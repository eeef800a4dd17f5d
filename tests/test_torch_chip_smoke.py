"""``chip_smoke.py``'s readers of kernel names, on the CPU.

* ``kernel_kind`` books a profiled kernel under the kind a train step's
  split reports: the grouped GEMM's wgmma body (bf16) and its fp32 body
  under ``moe_gmm`` / ``moe_tgmm`` (tgmm is mode 2), by their demangled
  names (as torch.profiler reports them) and their mangled ones; the
  flash, block-sparse and Evoformer kernels by theirs; cuBLAS GEMMs under
  ``gemm``; anything else under ``other``. A grouped GEMM that fell into
  ``other`` would read 0 under ``moe.gmm``.
* ``sass_kernel_label`` names each instantiation of the attention and
  GEMM libraries from its mangled name (as cuobjdump prints it), and every
  instantiation the design check requires has a name it can produce.
* ``paged_tick`` builds the paged-attention ticks the kernels phase checks
  as each kind says; ``prefill_rows`` finds the runs the plan sends to the
  prefill kernel; ``serving_launches_want`` gives the serving phases'
  launch counts.
* The ZeRO-3 phase: its launch formula, the gathers and reduces a step,
  the Z1-Z2 gate arithmetic, the Z4 memory comparison, and its rank
  function rehearsed at tiny size on two gloo ranks of the CPU.
* The expert-parallel phase: its traffic and launch formulas, and its
  rank function rehearsed at tiny size on two gloo ranks (E1-E4).

The names have the form nvcc and the demangler give these kernels, the
anonymous namespace's per-file prefix included.
"""
import numpy as np
import pytest

import chip_smoke as C

_GG = "_ZN48_GLOBAL__N__065297f9_15_grouped_gemm_cu_dac80e6d"
_FA = "_ZN51_GLOBAL__N__ac34abae_18_flash_attention_cu_446faa15"
_EV = "_ZN45_GLOBAL__N__2c3e0a11_12_evoformer_cu_8c1d2e6f"
_PA = "_ZN51_GLOBAL__N__81a95b55_18_paged_attention_cu_746e21b6"
_ANON = "(anonymous namespace)::"


@pytest.mark.parametrize("name, kind", [
    # the wgmma body (bf16), demangled and mangled
    (f"void {_ANON}gmm_wgmma_kernel<0>({_ANON}Args<__nv_bfloat16>, int, "
     "int)", "moe_gmm"),
    (f"void {_ANON}gmm_wgmma_kernel<1>({_ANON}Args<__nv_bfloat16>, int, "
     "int)", "moe_gmm"),
    (f"void {_ANON}gmm_wgmma_kernel<2>({_ANON}Args<__nv_bfloat16>, int, "
     "int)", "moe_tgmm"),
    (f"{_GG}16gmm_wgmma_kernelILi0EEEvNS_4ArgsI13__nv_bfloat16EEii",
     "moe_gmm"),
    (f"{_GG}16gmm_wgmma_kernelILi2EEEvNS_4ArgsI13__nv_bfloat16EEii",
     "moe_tgmm"),
    # the fp32 body, and the template form the kernels had before
    (f"void {_ANON}gmm_kernel<float, 1>({_ANON}Args<float>)", "moe_gmm"),
    (f"void {_ANON}gmm_kernel<float, 2>({_ANON}Args<float>)", "moe_tgmm"),
    (f"void {_ANON}gmm_kernel<__nv_bfloat16, 2>({_ANON}Args<__nv_bfloat16>)",
     "moe_tgmm"),
    (f"{_GG}10gmm_kernelIfLi2EEEvNS_4ArgsIT_EE", "moe_tgmm"),
    (f"{_GG}10gmm_kernelIfLi0EEEvNS_4ArgsIT_EE", "moe_gmm"),
    # attention kernels of the earlier slices
    (f"void {_ANON}flash_fwd_kernel_mma<64, 64, 64>(__nv_bfloat16 const*)",
     "flash_fwd"),
    (f"void {_ANON}flash_bwd_dq_kernel_mma<128, 64, 64>(__nv_bfloat16 "
     "const*)", "flash_bwd_dq"),
    (f"void {_ANON}flash_bwd_dkv_kernel_mma<128, 32, 64>(__nv_bfloat16 "
     "const*)", "flash_bwd_dkv"),
    (f"void {_ANON}flash_fwd_kernel<float, 64, 64, 64>(float const*)",
     "flash_fwd"),
    (f"void {_ANON}block_sparse_fwd_kernel_mma<128, 64, 64>(__nv_bfloat16 "
     "const*)", "block_sparse_fwd"),
    (f"void {_ANON}block_sparse_bwd_dq_kernel_mma<128, 64, 64>("
     "__nv_bfloat16 const*)", "block_sparse_bwd_dq"),
    (f"void {_ANON}block_sparse_bwd_dkv_kernel_mma<128, 32, 64>("
     "__nv_bfloat16 const*)", "block_sparse_bwd_dkv"),
    (f"{_FA}20flash_fwd_kernel_mmaILi64ELi64ELi64EEEvPK13__nv_bfloat16",
     "flash_fwd"),
    (f"void {_ANON}tc::evoformer_fwd_kernel_mma<__nv_bfloat16, 32>("
     "__nv_bfloat16 const*)", "evoformer_fwd"),
    (f"void {_ANON}fused_adam_kernel(float*, float*)", "fused_adam"),
    (f"void {_ANON}paged_attention_decode_kernel<__nv_bfloat16, 128, 1>("
     f"{_ANON}DecodeArgs)", "paged_attention_decode"),
    (f"void {_ANON}paged_attention_prefill_kernel_mma<128>({_ANON}"
     "PrefillArgs)", "paged_attention_prefill"),
    (f"void {_ANON}paged_attention_plan_kernel({_ANON}PlanArgs)",
     "paged_attention_plan"),
    ("_layer_norm_fwd", "norm_fwd"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopB_TNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>>(int, at::native::FillFunctor<float>)", "other"),
    ("void at::native::index_elementwise_kernel<128, 4>(long)", "other"),
])
def test_kernel_kind(name, kind):
    assert C.kernel_kind(name) == kind


@pytest.mark.parametrize("mangled, label", [
    (f"{_GG}16gmm_wgmma_kernelILi0EEEvNS_4ArgsI13__nv_bfloat16EEii",
     ("gmm", "bf16", "gmm")),
    (f"{_GG}16gmm_wgmma_kernelILi1EEEvNS_4ArgsI13__nv_bfloat16EEii",
     ("gmm", "bf16", "gmm_transpose_rhs")),
    (f"{_GG}16gmm_wgmma_kernelILi2EEEvNS_4ArgsI13__nv_bfloat16EEii",
     ("gmm", "bf16", "tgmm")),
    (f"{_GG}10gmm_kernelIfLi1EEEvNS_4ArgsIT_EE",
     ("gmm", "fp32", "gmm_transpose_rhs")),
    (f"{_EV}2tc24evoformer_fwd_kernel_mmaI13__nv_bfloat16Li32EEEvPKS2_S5_",
     ("evoformer", "bf16", "bias bf16 D32")),
    (f"{_EV}2tc24evoformer_fwd_kernel_mmaIfLi8EEEvPK13__nv_bfloat16S4_",
     ("evoformer", "bf16", "bias fp32 D8")),
    (f"{_EV}20evoformer_fwd_kernelIffLi128EEEvPKT_S3_",
     ("evoformer", "fp32", "bias fp32 D128")),
    (f"{_EV}20evoformer_fwd_kernelIf13__nv_bfloat16Li16EEEvPKT_S4_",
     ("evoformer", "fp32", "bias bf16 D16")),
    (f"{_FA}20flash_fwd_kernel_mmaILi128ELi64ELi64EEEvPK13__nv_bfloat16",
     ("flash", "bf16", "flash_fwd_kernel_mma D128 tiles 64x64")),
    (f"{_FA}27block_sparse_bwd_dq_kernelIfLi64ELi64ELi64EEEvPKT_",
     ("block_sparse", "fp32", "block_sparse_bwd_dq_kernel D64 tiles 64x64")),
    (f"{_PA}34paged_attention_prefill_kernel_mmaILi128EEEvNS_11PrefillArgsE",
     ("paged", "bf16", "prefill D128")),
    (f"{_PA}29paged_attention_decode_kernelI13__nv_bfloat16Li128ELi1EEEvNS_"
     "10DecodeArgsE", ("paged", "bf16", "decode D128 R1")),
    (f"{_PA}29paged_attention_decode_kernelIfLi64ELi8EEEvNS_10DecodeArgsE",
     ("paged", "fp32", "decode D64 R8")),
    (f"{_PA}27paged_attention_plan_kernelENS_8PlanArgsE",
     ("paged", "int32", "plan")),
    ("_Z14quant_kernelPKfPaPfi", None),
])
def test_sass_kernel_label(mangled, label):
    assert C.sass_kernel_label(mangled) == label


def test_every_required_instantiation_has_a_name():
    """Each (family, text) the design check requires is a name, or the
    prefix of a name, that sass_kernel_label gives some instantiation."""
    names = []
    for mode in range(3):
        names.append(f"{_GG}16gmm_wgmma_kernelILi{mode}EEEvNS_4Args")
        names.append(f"{_GG}10gmm_kernelIfLi{mode}EEEvNS_4ArgsIT_EE")
    for d in (8, 16, 32, 64, 128):
        for tb in ("f", "13__nv_bfloat16"):
            names.append(f"{_EV}2tc24evoformer_fwd_kernel_mmaI{tb}Li{d}EEEv")
            names.append(f"{_EV}20evoformer_fwd_kernelIf{tb}Li{d}EEEv")
    for fam in ("flash", "block_sparse"):
        for kind in ("fwd", "bwd_dq", "bwd_dkv"):
            for d in (64, 128):
                stem = f"{fam}_{kind}_kernel"
                names.append(f"{_FA}1{stem}_mmaILi{d}ELi64ELi64EEEvPK")
                names.append(f"{_FA}1{stem}IfLi{d}ELi64ELi64EEEvPK")
    for d in (64, 128):
        names.append(f"{_PA}34paged_attention_prefill_kernel_mmaILi{d}EEEv")
        for r in (1, 2, 4, 8):
            for t in ("f", "13__nv_bfloat16"):
                names.append(f"{_PA}29paged_attention_decode_kernelI{t}Li{d}"
                             f"ELi{r}EEEvNS_10DecodeArgsE")
    names.append(f"{_PA}27paged_attention_plan_kernelENS_8PlanArgsE")
    seen = set()
    for n in names:
        fam, dtype, rest = C.sass_kernel_label(n)
        seen.add((fam, f"{dtype} {rest}"))
    for family, text in C.DESIGN_INSTANTIATIONS:
        assert any(f == family and (t == text or t.startswith(text + " "))
                   for f, t in seen), (family, text)
    assert len(C.DESIGN_INSTANTIATIONS) == 24 + 6 + 20 + 16 + 2 + 1


def test_sass_op_counts_reads_hgmma_and_hmma():
    sass = "\n".join([
        "        Function : " + _GG + "16gmm_wgmma_kernelILi0EEEv",
        "        /*1e00*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8].tnspB, "
        "R24 ;",
        "        /*1e10*/  LDGSTS.E.BYPASS.LTC128B.128 [R3], desc[UR6][R4.64] ;",
        "        Function : " + _FA + "20flash_fwd_kernelIfLi64ELi64ELi64EEEv",
        "        /*0100*/  FFMA R1, R2, R3, R1 ;",
        "        Function : " + _EV + "2tc24evoformer_fwd_kernel_mmaIfLi32EEEv",
        "        /*0200*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "        /*0210*/  LDSM.16.M88.4 R8, [R2] ;",
    ])
    ops = C.sass_op_counts(sass)
    gmm, flash, evo = ops.values()
    assert gmm["HGMMA.F32.BF16"] == gmm["HGMMA"] == gmm["LDGSTS"] == 1
    assert gmm["HMMA"] == 0
    assert not any(flash.values())
    assert evo["HMMA.16816.F32.BF16"] == evo["HMMA"] == evo["LDSM"] == 1
    assert evo["HGMMA"] == 0


def test_ptxas_resources():
    report = "\n".join([
        "ptxas info    : Compiling entry function '" + _GG
        + "16gmm_wgmma_kernelILi2EEEvNS_4ArgsI13__nv_bfloat16EEii' for "
        "'sm_90a'",
        "ptxas info    : Function properties for " + _GG
        + "16gmm_wgmma_kernelILi2EEEvNS_4ArgsI13__nv_bfloat16EEii",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 123 registers, used 1 barriers, 33792 bytes "
        "smem",
    ])
    (info,) = C.ptxas_resources(report).values()
    assert info == {"spill_bytes": 12, "registers": 123,
                    "static_smem_bytes": 33792}


@pytest.mark.parametrize("label, kind, N, K, D, bs, MB", C.PA_TICKS)
def test_paged_ticks_are_what_their_kinds_say(label, kind, N, K, D, bs, MB):
    tables, lengths, NB = C.paged_tick(kind, bs, MB)
    T, cap = len(lengths), MB * bs
    assert tables.shape == (T, MB) and tables.dtype == lengths.dtype
    assert tables.min() >= 0 and tables.max() < NB
    assert N % K == 0 and N // K <= 8 and D in (64, 128)
    pad = ~tables.any(axis=1)
    real = {tuple(t) for t in tables[~pad]}
    for a in real:          # sequences own their blocks (beyond a prefix)
        for b in real - {a}:
            assert not set(a[MB // 2:]) & set(b)
    pre = C.prefill_rows(tables, 16)
    if kind.startswith("run"):
        n = int(kind[3:])
        assert T == n and len(real) == 1 and not pad.any()
        assert lengths[0] % bs not in (0, 1)            # starts mid-block
        np.testing.assert_array_equal(np.diff(lengths), 1)
        assert pre.all() == (n >= 16)
    elif kind == "mixed":
        assert pad.sum() == 6 and (lengths[pad] == 1).all()
        assert pre.sum() == 60 and not pre[:3].any()
    elif kind == "gqa":
        assert pre.sum() == 70 and lengths.max() == cap
    elif kind == "shared_prefix":
        a, b = tables[0], tables[20]
        assert (a[:MB // 2] == b[:MB // 2]).all() and not (a == b).all()
        assert pre.sum() == 38
    elif kind == "interleaved":
        assert not pre.any() and len(real) == 2
        assert all((tables[i] != tables[i + 1]).any() for i in range(T - 1))
    elif kind == "ragged":
        assert pre.all() and {0, 1, cap}.issubset(set(lengths.tolist()))
        assert lengths.max() > cap and (np.diff(lengths) < 0).any()
    elif kind == "long":
        assert cap == 2048 and lengths.max() > cap and 0 in lengths
        assert pre.sum() == 64


def test_prefill_rows_takes_runs_of_equal_tables():
    t = np.array([[1, 2]] * 3 + [[3, 4]] * 2 + [[1, 2]] * 3, np.int32)
    np.testing.assert_array_equal(C.prefill_rows(t, 3),
                                  [1, 1, 1, 0, 0, 1, 1, 1])
    np.testing.assert_array_equal(C.prefill_rows(t, 4), [0] * 8)


def test_serving_launches_want():
    """12 step ticks of 32 rows (a plan, L prefill launches each) and 32
    decode-window ticks of 8 (neither), as llama2_7b's main path runs."""
    assert C.serving_launches_want(32, [32] * 12 + [8] * 32, "rms_norm",
                                   16) == {
        "paged_attention": 1408, "paged_attention_decode": 1408,
        "paged_attention_prefill": 384, "paged_attention_plan": 12,
        "rms_norm": 2860}
    assert C.serving_launches_want(12, [16, 15], "layer_norm", 16) == {
        "paged_attention": 24, "paged_attention_decode": 24,
        "paged_attention_prefill": 12, "paged_attention_plan": 1,
        "layer_norm": 50}


# --------------------------------------------------------------------------- #
# the ZeRO-3 phase's host-side logic
# --------------------------------------------------------------------------- #

def test_zero3_launches_want():
    """llama_750m's 8 chunks, gas 4, 2 steps: 17 gathers a micro-batch
    (the head group, each chunk in the forward and in the recompute), one
    quantize and one dequant-reduce each on the qwZ wire, plus qgZ's
    quantize and its two dequant-reduces (receive, LoCo's sent)."""
    exact = C.zero3_launches_want(20, 4, 2, 8, wire=False)
    wire = C.zero3_launches_want(20, 4, 2, 8, wire=True)
    assert exact == dict(wire, quant_int8=0, dequant_reduce=0)
    assert (wire["quant_int8"], wire["dequant_reduce"]) == (144, 152)
    assert (wire["flash_fwd"], wire["flash_bwd_dq"], wire["flash_bwd_dkv"],
            wire["fused_adam"], wire["rms_norm"]) == (320, 160, 160, 2, 648)
    assert C.ZERO3_CHUNKS == 8 and C.ZERO3["gas"] == 4


def test_zero3_count_problems():
    good = {"gather_fwd": 36, "gather_bwd": 32, "reduce": 36}
    assert C.zero3_count_problems(good, 4, 8, wire=False) == []
    assert C.zero3_count_problems(dict(good, reduce=0), 4, 8, wire=True) \
        == []
    assert len(C.zero3_count_problems(dict(good, gather_bwd=31), 4, 8,
                                      wire=False)) == 1
    assert len(C.zero3_count_problems(good, 4, 8, wire=True)) == 1


def _gates(**z3):
    row = {"loss": 6.0, "loss_rel": 0.0, "grad_rel": 1e-6,
           "update_rel": 1e-5, "sign_miss": 0.0}
    return {"fp32_zero2": {"loss": 6.0}, "fp32_zero3": dict(row, **z3),
            "bf16_zero2": dict(row, loss=6.01, update_rel=0.05),
            "bf16_zero3": dict(row, loss=6.01, update_rel=0.06)}


@pytest.mark.parametrize("change, n", [
    ({}, 0), ({"loss_rel": 2e-5}, 1), ({"grad_rel": 2e-4}, 1),
    ({"update_rel": 2e-3}, 1), ({"sign_miss": 2e-3}, 1),
    ({"grad_rel": 2e-4, "sign_miss": 1.0}, 2)])
def test_zero3_gate_problems_z1(change, n):
    """Z1 holds the fp32 ZeRO-3 step to the training parity rule."""
    assert len(C.zero3_gate_problems(_gates(**change))) == n


def test_zero3_gate_problems_z2():
    """Z2: the bf16 loss within 1e-5 of ZeRO-2's, the bf16 update no
    further from the fp32 step than twice ZeRO-2's."""
    g = _gates()
    g["bf16_zero3"]["loss"] = 6.01 * (1 + 2e-5)
    assert len(C.zero3_gate_problems(g)) == 1
    g = _gates()
    g["bf16_zero3"]["update_rel"] = 0.11
    assert len(C.zero3_gate_problems(g)) == 1
    g["bf16_zero3"]["update_rel"] = 0.1
    assert C.zero3_gate_problems(g) == []


def test_zero3_memory_problems():
    assert C.zero3_memory_problems(14.0e9, 17.0e9) == []
    assert len(C.zero3_memory_problems(14.1e9, 17.0e9)) == 1
    assert len(C.zero3_memory_problems(20e9, 17e9)) == 1


def test_zero3_phase_rank_rehearsal_on_cpu(tmp_path):
    """The phase's rank function at tiny size on two gloo ranks of the CPU
    (the plain paths; the counters read 0 there): both runs train, the
    gathers and reduces a step are the plan's, the qwZ groups stay within
    half a step, the wire gate's bits agree, and Z1-Z2 pass."""
    import torch

    m = dict(C.ZERO3_MLP, width=64, micro=4)
    ref = str(tmp_path / "mlp_ref.pt")
    C.mlp_run(torch.device("cpu"), {"stage": 0}, 2 * m["micro"], 0, m, ref)
    t = dict(C.ZERO3, model="tiny", micro=2, seq=32, gas=2, steps=2,
             gate_layers=2, device="cpu", baseline=True, mlp=m, mlp_ref=ref)
    ranks = C.spawn_ranks("train_llama_750m_zero3_dp2_rank", 2, 0, t)
    for r in ranks:
        for run, wire in (("exact", False), ("wire", True)):
            m = r[run]
            assert np.isfinite(m["losses"]).all()
            assert m["losses"] == ranks[0][run]["losses"]
            assert C.zero3_count_problems(m["zero3_counts"], 2,
                                          len(m["chunk_bounds"]), wire) == []
        assert all(g["out_of_bound"] == 0 for g in r["qwz_gate"])
        assert r["wire_gate"]["q_bitwise_equal"]
        assert r["wire_gate"]["quant_err_out_of_bound"] == 0
        assert C.zero3_gate_problems(r["gates"]) == []
        assert r["gates"]["bf16_loss_bit_equal"]
        assert set(r["exposed"]) == {"overlap_on", "overlap_off"}
        assert r["baseline"]["losses"][0] == r["exact"]["losses"][0]
        # ZeRO-3 for a spec without the hook, against world 1 without ZeRO
        assert r["mlp_problems"] == [], r["mlp_problems"]
        assert r["mlp"]["type"] == "Zero3Engine"


def test_zeropp_phase_rank_rehearsal_on_cpu():
    """The ZeRO++ phase's rank function at tiny size on two gloo ranks:
    besides the int8 main path and its gates, exact ZeRO-2 with the hooked
    chunk and bucket reduces and the bucketed update (its reduces and
    publishes a step by formula: once a step, whatever gas), the unhooked
    run (one reduce after the backward), and the fp32 step of each by the
    training rule."""
    t = dict(C.ZEROPP, model="tiny", micro=2, seq=32, gas=2, steps=2,
             device="cpu")
    ranks = C.spawn_ranks("train_llama_750m_zeropp_dp2_rank", 2, 0, t)
    for r in ranks:
        b, once = r["baseline"], r["once"]
        assert b["hooked"] and not once["hooked"]
        assert b["reduce_counts"] == b["reduce_counts_want"]
        assert b["reduce_counts"]["chunk"] == len(b["plan"]["chunk_bounds"])
        assert b["plan"]["step_overlap"]
        assert once["reduce_counts"] == once["reduce_counts_want"] == {
            "chunk": 0, "bucket": 1, "late": 1, "publish": 0}
        assert b["losses"][0] == once["losses"][0]
        assert r["gate_problems"] == [], r["gate_problems"]
        assert r["overlap_gate"]["overlap"]["loss_rel"] <= C.TRAIN_LOSS_REL


# --------------------------------------------------------------------------- #
# the hpZ phase's host-side logic
# --------------------------------------------------------------------------- #

def test_hpz_launches_want():
    """The ZeRO++ trio (no LoCo) adds the replica hop's quantize and
    dequant-reduce a micro-batch: 17 gathers + qgZ + the replica hop = 19
    each, gas 4, 2 steps; MiCS at stage 3 (exact) launches neither."""
    trio = C.zero3_launches_want(20, 4, 2, 8, wire=True, loco=False,
                                 replica=True)
    assert (trio["quant_int8"], trio["dequant_reduce"]) == (152, 152)
    mics = C.zero3_launches_want(20, 4, 2, 8, wire=False)
    assert mics == dict(trio, quant_int8=0, dequant_reduce=0)
    assert C.HPZ["world"] == 4 and C.HPZ_Z == 2


def test_hpz_traffic_want():
    """H4's formula: a head group of 1,000 elements and two chunks of
    4,096 (block 2048 in the int8 wire: scales a block), n_sh 8,192, gas
    2, one step. No gather on the data group but the int8 replica hop's."""
    rows, n_sh, n_rep = [2048, 4096, 4096], 8192, 64
    exact = C.hpz_traffic_want(rows, n_sh, n_rep, 2, 1, wire=False)
    assert exact == {
        "zshard/all_gather": [2 * 5, 2 * (2048 + 4 * 4096)],
        "zshard/reduce_scatter": [2 * 3, 2 * 2 * 10240],
        "data/all_reduce": [2 * 3, 2 * 10240],
        "world/all_reduce": [2, 64 + 1],
        "zshard/all_reduce": [1, 1]}
    wire = C.hpz_traffic_want(rows, n_sh, n_rep, 2, 1, wire=True)
    assert wire == {
        "zshard/all_gather": [2 * 10, 2 * (2048 + 1 + 4 * (4096 + 2))],
        "zshard/all_to_all": [2 * 2, 2 * (16384 + 8)],
        "data/all_gather": [2 * 2, 2 * (8192 + 4)],
        "world/all_reduce": [2 + 1, 2 * 64 + 1],
        "zshard/all_reduce": [1, 1]}
    assert C.hpz_traffic_problems(
        {k: v + [0.5] for k, v in wire.items()}, wire) == []
    bad = dict(wire, **{"data/all_gather": [22, 2 * 18432]})
    assert len(C.hpz_traffic_problems(bad, wire)) == 1
    assert len(C.hpz_traffic_problems(
        dict(wire, **{"data/reduce_scatter": [1, 1]}), wire)) == 1


def _hpz_gates(**change):
    row = {"loss": 6.0, "loss_rel": 0.0, "grad_rel": 1e-7,
           "update_rel": 1e-6, "sign_miss": 0.0}
    g = {"fp32_d4_zero3": {"loss": 6.0}, "fp32_d4_zero2": {"loss": 6.0},
         "fp32_hpz_zero3": dict(row), "fp32_hpz_zero2": dict(row),
         "bf16_d4_zero3": dict(row, loss=6.01, update_rel=0.05),
         "bf16_hpz_zero3": dict(row, loss=6.01, update_rel=0.05)}
    for key, value in change.items():
        way, metric = key.split("__")
        g[way][metric] = value
    return g


@pytest.mark.parametrize("change, n", [
    ({}, 0), ({"fp32_hpz_zero3__grad_rel": 2e-4}, 1),
    ({"fp32_hpz_zero2__update_rel": 2e-3}, 1),
    ({"fp32_hpz_zero2__sign_miss": 2e-3, "fp32_hpz_zero3__loss_rel": 1.0}, 2),
    ({"bf16_hpz_zero3__loss": 6.0100001}, 1),
    ({"bf16_hpz_zero3__update_rel": 0.11}, 1)])
def test_hpz_gate_problems(change, n):
    """H1 holds both fp32 hpZ steps to the training rule; H2 the bf16
    first loss bit-equal and the update within 2x data = 4's."""
    assert len(C.hpz_gate_problems(_hpz_gates(**change))) == n


def test_hpz_phase_rank_rehearsal_on_cpu():
    """The hpZ phase's rank function at tiny size on four gloo ranks of
    the CPU (the plain paths; the counters read 0 there): rank r at data
    r // 2, zshard r % 2; both runs train with the ranks' losses equal;
    the gathers and reduces a step are the plan's and each group's
    collectives H4's formula; the replica hop's bits agree and its error
    stays in bound (H3); H1-H2 pass."""
    t = dict(C.HPZ, model="tiny", micro=2, seq=32, gas=2, steps=2,
             gate_layers=2, device="cpu")
    ranks = C.spawn_ranks("train_llama_750m_hpz_dp4_rank", 4, 0, t)
    for r in ranks:
        for run, wire in (("trio", True), ("mics", False)):
            m = r[run]
            assert m["coords"] == {"data": r["rank"] // 2,
                                   "zshard": r["rank"] % 2}
            assert m["zshard_ranks"] == [r["rank"] // 2 * 2,
                                         r["rank"] // 2 * 2 + 1]
            assert m["data_ranks"] == [r["rank"] % 2, r["rank"] % 2 + 2]
            assert np.isfinite(m["losses"]).all()
            assert m["losses"] == ranks[0][run]["losses"]
            assert C.zero3_count_problems(m["zero3_counts"], 2,
                                          len(m["chunk_bounds"]), wire) == []
            want = C.hpz_traffic_want(m["n_rows"], m["n_sharded"],
                                      m["n_replicated"], 2, 2, wire)
            assert C.hpz_traffic_problems(m["traffic"], want) == []
            assert "data/all_gather" in m["traffic"] if wire \
                else "data/all_gather" not in m["traffic"]
        g = r["replica_gate"]
        assert g["q_bitwise_equal"] and g["scales_bitwise_equal"]
        assert g["reduced_bitwise_equal"]
        assert g["two_hop_err_out_of_bound"] == 0
        assert C.hpz_gate_problems(r["gates"]) == []
        assert r["gates"]["bf16_loss_bit_equal"]


def test_moe_ep_formulas():
    """E4's collectives a step and the launches of an MoE rank: tiny_moe's
    2 layers, gas 2, one step, 32 tokens of top-2 a micro-batch at ep 2
    (buffers of 2 × 64 rows, dropless), H 64, E 4."""
    want = C.moe_ep_traffic_want(2, 2, 1, 1, 32, 2, 2, 64, 4)
    assert want == {"expert/all_to_all": [32, 4 * (6 * 128 * 64 + 2 * 128)],
                    "batch/all_reduce": [20, 4 * (24 + 4)]}
    launches = C.moe_ep_launches_want(12, 2, 2, 2, adam_per_step=2)
    assert launches["gmm"] == 3 * 2 * 12 * 4
    assert launches["tgmm"] == 2 * 12 * 4
    assert launches["layer_norm"] == 49 * 4 and launches["fused_adam"] == 4


def test_moe_ep_phase_rank_rehearsal_on_cpu(tmp_path):
    """The expert-parallel phase's rank function at tiny size on two gloo
    ranks of the CPU (bf16 main path; the plain paths, the counters read 0
    there): each rank holds 2 of tiny_moe's 4 experts, the losses fall and
    agree, E4's collectives a step match the formula with nothing dropped,
    E3's received buffer gives the plain version's rows and a zero tail,
    and E1-E2 pass (E1 against the same ranks without the expert axis and
    against the one-process reference)."""
    import torch

    t = dict(C.MOE_EP, model="tiny_moe", micro=2, seq=32, gas=2, steps=2,
             device="cpu")
    t["ref"] = C.moe_ep_reference(t, torch.device("cpu"), 0,
                                  str(tmp_path / "a"))
    ranks = C.spawn_ranks("train_moe_350m_ep_rank", 2, 0, t)
    assert C.moe_ep_problems(ranks, t, "a") == []
    for r in ranks:
        m = r["main"]
        assert m["local_experts"] == 2
        assert m["coords"] == {"data": 0, "expert": r["rank"]}
        assert m["expert_ranks"] == [0, 1]
        assert r["e3"]["rows"] == 2 * 128        # ep · Cs, Cs = 2 · 32 · 2
        g = r["gates"]
        assert g["fp32"]["route_miss"] == 0.0
        assert set(g) == {"fp32", "fp32_one_process", "bf16", "plain_bf16"}
    # dropless: every rank's 128 choices reached an expert
    assert sum(r["e3"]["routed_rows"] for r in ranks) == 2 * 128


# --------------------------------------------------------------------------- #
# the offload phases
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("avail, layers", [
    (90e9, 18), (103.08e9 - 5e9, 20), (200e9, 32), (5e9, 0)])
def test_super_offload_depth_rule(avail, layers):
    """(4.7 + 3.64 L) GB x 1.25 <= the host's available bytes: host state
    18 B a parameter, the embedding and head 262 M parameters, a layer
    202.4 M."""
    assert C.super_layers("llama2_7b", avail) == layers
    assert C.super_layers("llama2_7b", 200e9, max_layers=4) == 4


def test_host_available_takes_the_cgroup_limit():
    facts = {"mem_available_bytes": 103e9, "cgroup_limit_bytes": 96 * 2 ** 30,
             "cgroup_current_bytes": 4e9}
    assert C.host_available(facts) == 96 * 2 ** 30 - 4e9
    assert C.host_available(dict(facts, cgroup_limit_bytes=None)) == 103e9


def _super_gates(**change):
    g = {"fp32_device": {"init_bit_equal": True, "losses": [11.0]},
         "fp32_host": {"init_bit_equal": True, "losses": [11.0],
                       "master_rel_l2": 5e-10},
         "bf16_device": {"init_bit_equal": True, "losses": [11.0],
                         "update_rel_vs_fp32": 0.4},
         "bf16_host": {"init_bit_equal": True, "losses": [11.0, 3.0],
                       "update_rel_vs_fp32": 0.4},
         "bf16_overlap": {"init_bit_equal": True,
                          "losses": [11.0, 11.0, 3.0]}}
    for key, value in change.items():
        way, metric = key.split("__")
        g[way][metric] = value
    return g


@pytest.mark.parametrize("change, n", [
    ({}, 0), ({"fp32_host__losses": [11.000001]}, 1),
    ({"fp32_host__master_rel_l2": 2e-6}, 1),
    ({"bf16_host__update_rel_vs_fp32": 0.81}, 1),
    ({"bf16_overlap__losses": [11.0, 10.9, 3.0]}, 1),
    ({"bf16_overlap__losses": [11.0, 11.0, 3.1]}, 1),
    ({"bf16_host__init_bit_equal": False}, 1)])
def test_super_gate_problems(change, n):
    """S1 the fp32 loss bit-equal and the master within 1e-6; S2 the bf16
    host update within 2x the device's from fp32; S3 the overlap
    schedule's losses."""
    assert len(C.super_gate_problems(_super_gates(**change))) == n


def _cpu_smoke():
    import torch

    smoke = C.Smoke(torch, 0)
    smoke.dev = torch.device("cpu")
    return smoke


def test_super_offload_phase_rehearsal_on_cpu(tmp_path, monkeypatch):
    """The phase at tiny size on the CPU: S1-S3 pass, the master and the
    moments live on the host, the loss falls over the overlap and sync
    steps (the counters read 0 there: the plain versions count
    nothing)."""
    monkeypatch.setenv("DSTPU_NVME_PATH", str(tmp_path))
    smoke = _cpu_smoke()
    smoke.phase_train_llama2_7b_super_offload(dict(
        model="tiny_llama", micro=2, seq=32, gas=2, gate_layers=2,
        copy_elems=2 ** 16))
    r = smoke.state["super_offload"]
    assert r["layers"] == 2 and r["reduced"] is None
    assert r["modes"] == ["overlap"] * 3 + ["sync"] * 2
    assert r["losses"][1] == r["losses"][0]   # steps 1, 2: initial params
    assert r["losses"][2] != r["losses"][1]   # step 3: update 1's
    assert r["placed"]["master"] == "cpu"
    assert len(r["updates"]) == 5
    assert all(u["host_update_s"] > 0 for u in r["updates"])
    # the update ran in the host library; S0 on the step's real state:
    # m and v bit-equal to the plain version, the norm's sum the same at
    # one thread and at all
    assert r["host_update_route"].endswith("cpu_adam.cpp")
    assert r["launches"]["host_adam"] == r["launches"]["host_grad_prep"] == 5
    assert C.host_adam_gate_problems(r["s0"]) == []
    assert r["s0"]["vs_plain_bit_equal"]["m"]
    assert r["s0"]["norm_bit_equal"]
    row = smoke.host_rows["host_adam"]
    assert row["launches"] == 5 and row["bound_by"] == "bytes"


def test_offload_750m_phase_rehearsal_on_cpu(tmp_path, monkeypatch):
    """(a)-(d) at tiny size on the CPU, (d) on one spawned gloo rank:
    every tier bit-equal to no offload, the moments on the host or in
    their files between steps, ZenFlow's loss falling and its step gate
    passing."""
    monkeypatch.setenv("DSTPU_NVME_PATH", str(tmp_path))
    monkeypatch.setitem(C.TRAIN, "tiny_llama", dict(
        micro=2, seq=32, gas=2, steps=2, norm="rms_norm", gate_micro=1))
    smoke = _cpu_smoke()
    smoke.phase_train_llama_750m_offload(dict(
        model="tiny_llama", micro=2, seq=32, gas=2, gate_layers=2,
        param_layers=2))
    r = smoke.state["offload_750m"]
    base = r["runs"]["none"]
    for run in ("a_cpu", "b_nvme"):
        assert r["runs"][run]["losses"] == base["losses"]
        assert r["runs"][run]["master_bit_equal"]
    assert all(c["all_host"] for c in r["runs"]["a_cpu"]["checks"])
    assert all(c["swapped"] for c in r["runs"]["b_nvme"]["checks"])
    d = r["d_runs"]
    assert d["none"]["engine"] == "DeepSpeedTPUEngine"
    for run in ("cpu", "nvme"):
        assert d[run]["losses"] == d["none"]["losses"]
        assert d[run]["master_bit_equal"]
    assert {c["master"] for c in d["nvme"]["checks"]} == {"file"}
    # (d) streamed the master chunk by chunk; the int8 wire at world 2
    # kept the boundary swap, bit-equal
    for run in ("cpu", "nvme"):
        assert d[run]["stream"] and d[run]["stream_counts"]["update_h2d"] > 1
    for x in r["d_int8_runs"]:
        assert not x["cpu"]["stream"] and x["cpu"]["wire"] == "qz"
        assert x["cpu"]["losses"] == x["none"]["losses"]
        assert x["cpu"]["master_bit_equal"]
