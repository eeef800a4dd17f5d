"""The grouped GEMM's weight gradient (tgmm) on a CUDA card: the kernel and
its plain version against the fp64 sum at outputs of O(100) (groups of up
to 18,725 rows, bf16 and fp32, with empty and tail groups), then its time
at moe_350m's layer (CUDA events, L2 flushed, median of 20).

    python3 tools/probe_tgmm.py                        # this checkout
    python3 tools/probe_tgmm.py --all <tree>           # another checkout's
    python3 tools/probe_tgmm.py --time-only <tree>     # package; time only
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
                if len(sys.argv) < 3 else sys.argv[2])
import torch  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.ops import build  # noqa: E402
from deepspeed_tpu_torch.ops import grouped_gemm as GG  # noqa: E402

build.build_all(["grouped_gemm"])
dev = torch.device("cuda")
GG_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-3, 2.0 ** -7)}
tree = os.path.dirname(os.path.dirname(deepspeed_tpu_torch.__file__))


def report(label, got, ref64, plain):
    g, p, r = got.double(), plain.double(), ref64
    rb = ref64.to(got.dtype).double()
    out = {"tree": tree, "case": label, "dtype": str(got.dtype)}
    for name, x in (("kernel", g), ("plain", p)):
        out[name] = {"max_abs_vs_exact": float((x - r).abs().max()),
                     "not_correctly_rounded": int((x != rb).sum())}
    d = (g - p).abs()
    atol, rtol = GG_TOL[str(got.dtype).split(".")[-1]]
    out["kernel_vs_plain_max_abs"] = float(d.max()) if d.numel() else 0.0
    out["kernel_vs_plain_out_of_tol"] = int((d > atol + rtol * p.abs()).sum())
    out["finite"] = bool(torch.isfinite(g).all())
    print(json.dumps(out), flush=True)


def exact_tgmm(x, g, sizes_l):
    outs, s = [], 0
    for n in sizes_l:
        a, b = min(s, x.shape[0]), min(s + max(n, 0), x.shape[0])
        s += max(n, 0)
        outs.append(x[a:b].double().t() @ g[a:b].double())
    return torch.stack(outs)


def timed(fn, iters=20):
    for _ in range(3):
        fn()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    ts.sort()
    return ts[len(ts) // 2]


gen = torch.Generator(dev).manual_seed(0)
if "--time-only" not in sys.argv:
    for sizes_l, M, xscale in (([9869, 7272], 32768, 1.0),
                               ([9869, 7272], 32768, 3.0),
                               ([16384, 16384], 32768, 1.0),
                               ([18725, 0, 9362, 4681], 32768, 1.0),
                               ([0, 5000, 0, 3], 6000, 1.0),
                               ([1, 2, 3], 6, 1.0), ([0, 0], 100, 1.0),
                               ([700, 5000], 4000, 1.0)):
        K, N = 768, 3072
        sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn(M, K, generator=gen, device=dev) * xscale).to(dt)
            g = torch.randn(M, N, generator=gen, device=dev).to(dt)
            tg = GG.tgmm(x, g, sizes)
            tp = GG.tgmm_ref(x, g, sizes)
            report(f"tgmm sizes {sizes_l} M {M} x*{xscale}", tg,
                   exact_tgmm(x, g, sizes_l), tp)
            del x, g, tg, tp
            torch.cuda.empty_cache()

# moe_350m's layer: the weight gradients of the up and down projections
sizes = torch.tensor([7776, 8482, 8136, 8374], dtype=torch.int32, device=dev)
M = int(sizes.sum())
for proj, K, N in (("up", 768, 3072), ("down", 3072, 768)):
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)

    def run():
        flush.zero_()
        GG.tgmm(x, dy, sizes)

    print(json.dumps({"tree": tree, "time": f"tgmm[{proj}]",
                      "ms_with_flush": timed(run),
                      "flush_ms": timed(lambda: flush.zero_())}), flush=True)
