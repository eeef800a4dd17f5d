"""The bf16 loss statistic of chip_smoke's moe_350m step gate over more of
its batch, on a CUDA card.

chip_smoke's ``train_moe_350m`` trains moe_350m (micro 16, seq 1024, gas
4, bf16) and then holds one step four ways ({fp32, bf16} x {kernels,
plain}) on the batch's first 2 rows: the bf16 kernel path's loss no
further from the fp32 plain loss than 2x the bf16 plain path's. This
script runs the same main path, then takes the four ways' first losses
on each 2-row slice of the batch and on all 16 rows, from the main path's
trained master, and prints each bf16 path's relative distance from the
fp32 plain loss and their routing misses.

    python3 tools/probe_moe_gate.py
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def main():
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import load_master
    from deepspeed_tpu_torch.ops import build

    build.build_all()
    smoke = C.Smoke(torch, 0)
    smoke.phase_card()
    held = {}

    def capture(model, main, batch, **_):
        held["master"] = {k: v for k, v in main.state["master"].items()}
        held["batch"] = batch

    smoke.train_gate = capture
    smoke.train_profile = lambda model: {}
    smoke.train("moe_350m")
    t = C.TRAIN["moe_350m"]
    tokens = held["batch"]["tokens"]
    L = 12

    def losses(rows):
        out = {}
        for prec, path in (("fp32", "plain"), ("fp32", "kernels"),
                           ("bf16", "plain"), ("bf16", "kernels")):
            spec = dtt.causal_lm_spec(
                "moe_350m", attention="flash", remat="full",
                use_kernels=path == "kernels",
                dtype="float32" if prec == "fp32" else "bfloat16")
            engine, *_ = dtt.initialize(
                model=spec, config=smoke.train_config(rows.shape[0], 1, prec),
                device=smoke.dev)
            load_master(engine, held["master"])
            with C.recorded_routes() as routes:
                loss = float(engine.train_batch(iter([{"tokens": rows}])))
            idx = torch.stack([r[0] for r in routes[:L]])
            out[(prec, path)] = (loss, idx)
            del engine
            torch.cuda.empty_cache()
        ref, ridx = out[("fp32", "plain")]
        res = {}
        for path in ("kernels", "plain"):
            loss, idx = out[("bf16", path)]
            res[path] = {"loss_rel": abs(loss - ref) / abs(ref),
                         "route_miss": float((idx != ridx).float().mean())}
        res["fp32_kernels_loss_rel"] = abs(out[("fp32", "kernels")][0]
                                           - ref) / abs(ref)
        return res

    rows_of = t["gate_micro"]
    for r0 in range(0, tokens.shape[0], rows_of):
        print(json.dumps({"rows": [r0, r0 + rows_of],
                          **losses(tokens[r0:r0 + rows_of])}), flush=True)
    print(json.dumps({"rows": [0, tokens.shape[0]], **losses(tokens)}),
          flush=True)
    print(json.dumps({"card": smoke.card}), flush=True)


if __name__ == "__main__":
    main()
