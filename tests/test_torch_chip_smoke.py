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
    assert C.ZERO3_CHUNKS == 8 and C.ZERO3["gas"] == C.ZEROPP_GAS == 2


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


def test_moe_ep_zero_phase_rank_rehearsal_on_cpu(tmp_path):
    """The expert axis on every engine, at tiny size on gloo ranks of the
    CPU (the plain paths, the counters read 0 there): four ranks through
    ways (b)-(f) — ZeRO-2, ZeRO-3, ZeRO-2 + qgZ + qwZ + LoCo, ZeRO-3 +
    int8, hpZ ZeRO-3 — then two through (g), the dense dispatch at
    {expert: 2}. Every problem the parent checks is absent: each way's
    collectives a step equal ``epz_traffic_want`` by group and kind
    (E8), ZeRO-3's gathers, E6-E7's steps (exact against ZeRO-2 by the
    training rule; the int8 wire's kernels-vs-plain within its noise), E9
    against the one-process dense step with the same kept choices; E10's
    peaks are the card's only."""
    import torch

    t = dict(C.MOE_EPZ, model="tiny_moe", micro=2, seq=32, layers=2,
             device="cpu")
    ranks = C.spawn_ranks("train_moe_350m_ep_zero_rank", 4, 0, t)
    td = dict(C.MOE_EPZ_DENSE, model="tiny_moe", micro=2, seq=32, layers=2,
              device="cpu")
    td["ref"] = C.moe_ep_reference(td, torch.device("cpu"), 0,
                                   str(tmp_path / "g"), plain_bf16=False)
    dense = C.spawn_ranks("train_moe_350m_ep_dense_rank", 2, 0, td)
    assert C.epz_problems(ranks, dense, t) == []
    for r in ranks:
        main = r["main"]
        assert [w for w, _, _ in C.MOE_EPZ_WAYS] == list(main)
        assert all(m["local_experts"] == 2 for m in main.values())
        # the exact wires: no expert leaf crosses the expert group
        for label in ("c_zero3", "f_hpz_zero3"):
            assert "expert/all_gather" not in main[label]["traffic"]
        # the int8 wire: its expert pieces, gathered there (JAX's blocks)
        for label in ("d_zero2_int8_loco", "e_zero3_int8"):
            assert main[label]["traffic"]["expert/all_gather"][0] > 0
            assert main[label]["e7_wire"]["reduced_bitwise_equal"]
        assert "zshard/reduce_scatter" in main["f_hpz_zero3"]["traffic"]
    g = dense[0]["gates"]["fp32_one_process"]
    assert g["kept"] == g["ref_kept"] and g["route_miss"] == 0.0


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


def test_checkpoint_phase_rehearsal_on_cpu(tmp_path, monkeypatch):
    """C1-C5 at tiny size on the CPU (C3 on two spawned gloo ranks): the
    resumed runs bit-equal, the async save in flight at its return, the
    universal conversion's leaves and first loss bit-equal, the NVMe tier's
    reload bit-equal, the 16-bit export the compute params; the tags gone
    at the end."""
    import torch

    monkeypatch.setenv("DSTPU_NVME_PATH", str(tmp_path / "nvme"))
    monkeypatch.setenv("DSTPU_CHECKPOINT_PATH", str(tmp_path / "ck"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # as the phase's spawned CPU ranks run
    smoke = _cpu_smoke()
    try:
        smoke.phase_checkpoint_llama_750m(dict(
            model="tiny_llama", micro=2, seq=32, gas=2, zero3_layers=2,
            nvme_layers=2))
    finally:
        torch.set_num_threads(n)
    r = smoke.state["checkpoint"]
    assert r["c1"]["resumed_losses"] == r["c1"]["losses"][2:]
    assert r["c2"]["in_flight_at_return"]
    assert r["c3"]["wire"] == "qz+loco" and r["c3"]["loco_folds"] > 0
    assert r["c3"]["universal_first_loss"] == r["c3"]["direct_first_loss"]
    assert r["c4"]["after_load"] == r["c4"]["losses"][2:]
    assert r["c5"]["bit_equal"]
    for part in ("c1", "c2", "c3", "c4"):
        assert r[part]["gb_written"] > 0 and r[part]["crc_s"] >= 0
    assert smoke.steps["checkpoint_llama_750m"] == 2
    assert not (tmp_path / "ck").exists()


# --------------------------------------------------------------------------- #
# the sequence-parallel phase and the merged spawns
# --------------------------------------------------------------------------- #

def test_sp2_formulas():
    """SP4 at the phase's shapes: llama_750m's 12 heads of 128 (K = N),
    B 4, 1,024 positions a rank, gas 2."""
    from deepspeed_tpu_torch.models import transformer as T

    t = dict(C.SP2, layers=4)
    cfg = T.get_model_config("llama_750m", num_layers=4)
    launches, traffic, shapes = C.sp2_want(t, 4, "ulysses_flash", cfg, 1)
    assert (launches["flash_fwd"], launches["flash_bwd_dq"],
            launches["flash_bwd_dkv"]) == (16, 8, 8)
    assert launches["rms_norm"] == 17 * 2
    assert traffic == {"seq/all_to_all": (96, 96 * 4 * 1024 * 12 * 128)}
    assert shapes == [(4, 2048, 6, 128)]
    launches, traffic, shapes = C.sp2_want(t, 4, "ring", cfg, 1)
    assert launches["flash_fwd"] == 0 and shapes == []
    assert traffic == {"seq/permute": (48, 48 * 4 * 1024 * 12 * 128)}


def test_sp2_phase_rank_rehearsal_on_cpu(tmp_path):
    """The sequence-parallel phase's rank function at tiny size on two
    gloo ranks of the CPU, in one spawn with another phase's job (the
    merged spawn's ``jobs_rank``; the plain paths, the counters read 0
    there): both ways train, their seq-group traffic a step is the
    formula's (tiny_llama's GQA: K/V heads 2 of 4, sent as they are by
    Ulysses at sp 2, repeated to 4 before the ring), the flash wrapper sees
    the head-sharded shape, and SP1-SP3 pass against the one-process
    reference; then way (c) on four ranks at {data: 2, seq: 2}, whose SP1c
    holds against the same reference."""
    import torch

    from deepspeed_tpu_torch.models import transformer as T

    t = dict(C.SP2, model="tiny_llama", layers=2, micro=2, seq=32, gas=2)
    ref = C.sp2_reference(t, torch.device("cpu"), 0, str(tmp_path / "one"))
    ranks = C.spawn_ranks("jobs_rank", 2, 0, [
        ("sp2", "train_llama_750m_sp2_rank", dict(t, device="cpu", ref=ref)),
        ("qrs", "quantized_reduce_scatter_rank",
         dict(C.QRS, n=2 ** 12, device="cpu"))])
    cfg = T.get_model_config("tiny_llama", num_layers=2)
    for r in ranks:
        assert set(r) == {"sp2", "qrs"}
        got, seconds = r["sp2"]
        assert seconds > 0 and r["qrs"][0]["kernel_equals_plain"]
        assert C.sp2_gate_problems(got["gates"], ref) == []
        for label, attention in C.SP2_WAYS:
            m = got[label]
            assert m["losses"][-1] < m["losses"][0]
            assert m["coords"]["seq"] == got["rank"]
            _, traffic, shapes = C.sp2_want(t, 2, attention, cfg, 1)
            for key, (calls, elems) in traffic.items():
                assert m["traffic"][key][:2] == [calls, elems]
            if shapes:
                assert m["flash_shapes"]["flash_fwd"] == shapes
    # (c): four ranks at {data: 2, seq: 2} on the same global batch, SP1c
    tc = C.sp2_c(t)
    ranks = C.spawn_ranks("train_llama_750m_sp2_rank", 4, 0,
                          dict(tc, device="cpu", ref=ref))
    (label, attention), = C.SP2_C["ways"]
    _, traffic, shapes = C.sp2_want(tc, 2, attention, cfg, 1)
    for r in ranks:
        assert set(r["gates"]) == set(C.SP2_C["gates"])
        assert C.sp2_gate_problems(r["gates"], ref) == []
        m = r[label]
        assert m["coords"]["data"] == r["rank"] // 2
        assert m["flash_shapes"]["flash_fwd"] == shapes == [(1, 32, 2, 16)]
        for key, (calls, elems) in traffic.items():
            assert m["traffic"][key][:2] == [calls, elems]


def test_phase_seconds_moves_merged_jobs_to_their_phase():
    """A job run in another phase's spawn, and a preparation made in
    another phase's time, count for their own phase; the spawn's fixed
    cost stays with the phase that started it."""
    import torch

    s = C.Smoke(torch, 0)
    s.job_phase = {"zeropp": ("zeropp_phase", "zeropp_phase"),
                   "sp2": ("sp2_phase", "zeropp_phase")}
    s.job_seconds = {"zeropp": 90.0, "sp2": 40.0}
    s.phase_parts = {"sp2_phase": {"prepare_s": 10.0,
                                   "prepared_in": "zeropp_phase"}}
    got = s.phase_seconds({"zeropp_phase": 150.0, "sp2_phase": 5.0})
    assert got == {"zeropp_phase": 100.0, "sp2_phase": 55.0}


# --------------------------------------------------------------------------- #
# the tensor-parallel phases
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("model", ["tiny_llama", "tiny", "llama_750m"])
def test_tp_local_params_counts_a_ranks_slices(model):
    """TP4's formula against the slices of the port's own tree (layers cut
    to 2 so the tree stays small), at T = 2 and 4."""
    import torch

    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.models.convert import tp_local_tree

    cfg = T.get_model_config(model, num_layers=2)
    tree = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         dtype=torch.bfloat16)
    for n in (2, 4):
        mine = tp_local_tree(tree, cfg, n, 1)
        count = sum(v.numel() for _, v in _flat(mine))
        assert C.tp_local_params(cfg, n) == count


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", tree[k]


def test_tp2_formulas():
    """TP3 at the phase's shapes: llama_750m at 4 layers (H 1536, 12 heads
    of 128), B 4, S 2048, gas 2; way (b)'s B 2."""
    from deepspeed_tpu_torch.models import transformer as T

    t = dict(C.TP2, layers=4)
    cfg = T.get_model_config("llama_750m", num_layers=4)
    R, BSH = 4 * 2047, 4 * 2048 * 1536
    assert C.tp2_traffic_want(t, cfg) == {"tensor/all_reduce": (
        2 * 25 + 1, 2 * (21 * BSH + 3 * R + R * 1536) + 2)}
    launches, shapes = C.tp2_want(t, cfg, 1)
    assert (launches["flash_fwd"], launches["flash_bwd_dq"],
            launches["flash_bwd_dkv"], launches["rms_norm"]) == (
                16, 8, 8, 17 * 2)
    assert shapes == [(4, 2048, 6, 128)]
    tb = C.tp2_b(t)
    assert (tb["micro"], tb["world"], tb["mesh"]) == (
        2, 4, {"data": 2, "tensor": 2})
    assert C.tp2_want(tb, cfg, 1)[1] == [(2, 2048, 6, 128)]


def test_tp7b_traffic_want():
    """T3: 2L + 1 all-reduces of [rows, H] and one gather of [rows, V/T]
    a tick."""
    from deepspeed_tpu_torch.models import transformer as T

    cfg = T.get_model_config("llama2_7b")
    assert C.tp7b_traffic_want(cfg, [256, 8, 8], 2) == {
        "tensor/all_reduce": [65 * 3, 65 * 4096 * 272],
        "tensor/all_gather": [3, 16000 * 272]}


def _but_launches(problems):
    """The verdicts but the launch counts (0 on the CPU: the plain versions
    count nothing)."""
    return [p for p in problems if " launched " not in p]


def test_tp2_phase_rank_rehearsal_on_cpu(tmp_path):
    """The tensor-parallel training phase's rank function at tiny size,
    way (a) on two gloo ranks of the CPU in one spawn with another phase's
    job (the merged spawn's ``jobs_rank``; the plain paths, the counters
    read 0 there), way (b) on four: both train, the tensor group's traffic
    a step is TP3's formula, the flash wrapper sees a rank's heads, the
    rank's parameters and master are TP4's sizes, and TP1-TP2 pass against
    the one-process reference."""
    import torch

    from deepspeed_tpu_torch.models import transformer as T

    t = dict(C.TP2, model="tiny_llama", layers=2, micro=2, seq=32, gas=2,
             gates=tuple(C.TP2_GATES))
    cfg = T.get_model_config("tiny_llama", num_layers=2)
    ref = C.sp2_reference(t, torch.device("cpu"), 0, str(tmp_path / "one"))
    ranks = C.spawn_ranks("jobs_rank", 2, 0, [
        ("tp2", "train_llama_750m_tp2_rank", dict(t, device="cpu", ref=ref)),
        ("qrs", "quantized_reduce_scatter_rank",
         dict(C.QRS, n=2 ** 12, device="cpu"))])
    assert all(set(r) == {"tp2", "qrs"} for r in ranks)
    got = [r["tp2"][0] for r in ranks]
    assert _but_launches(C.tp2_problems("a", t, got, ref, cfg)) == []
    assert all(set(r["gates"]) == set(C.TP2_GATES) for r in got)
    assert got[0]["main"]["flash_shapes"]["flash_fwd"] == [(2, 32, 2, 16)]
    tb = C.tp2_b(t)
    got = C.spawn_ranks("train_llama_750m_tp2_rank", 4, 0,
                        dict(tb, device="cpu", ref=ref))
    assert _but_launches(C.tp2_problems("b", tb, got, ref, cfg)) == []
    assert [r["main"]["coords"]["tensor"] for r in got] == [0, 1, 0, 1]
    assert got[0]["main"]["shard_world"] == 2


def test_tp7b_phase_rank_rehearsal_on_cpu(tmp_path):
    """The tensor-parallel serving phase at tiny size on two gloo ranks of
    the CPU: the one-process tick of the parent, the ranks' main path with
    its launches (0: the plain paths) and the tensor group's traffic a
    tick, equal tokens on both ranks, and T1 against the one-process
    plain path."""
    import torch

    from deepspeed_tpu_torch.models import transformer as T

    t = dict(C.TP7B, model="tiny_llama", layers=2, n_req=3, lo=4, hi=40,
             max_new=4, engine=dict(n_blocks=64, block_size=16,
                                    max_blocks_per_seq=8, token_budget=32),
             tick=dict(lens=(10, 60), n_blocks=32))
    ref = C.tp7b_reference(t, torch.device("cpu"), 0, str(tmp_path))
    assert ref["decode_rows"] and ref["rows"] > ref["decode_rows"]
    ranks = C.spawn_ranks("llama2_7b_tp2_rank", 2, 0,
                          dict(t, device="cpu", ref=ref))
    cfg = T.get_model_config("tiny_llama", num_layers=2)
    assert _but_launches(C.tp7b_problems(ranks, t, ref, cfg,
                                         graphs=False)) == []
    assert ranks[0]["main"]["pool_heads"] == 1
    assert ranks[0]["main"]["traffic"]["tensor/all_reduce"][0] > 0


def test_pp2_formulas():
    """PP3 and PP4 at the phase's shapes: llama_750m at 20 layers (10 a
    stage), M = 4 pipeline micro-batches of 1 x 2048 tokens, gas 2: the
    launches a step of each stage, the stage hops (M·gas activations sent
    by stage 0, M·gas cotangents by stage 1, each [1, 2048, 1536]) and the
    exchanges, and the stage-local parameter count against the tree the
    converter cuts; way (b) at 4 layers and a tensor rank's 6 heads."""
    import torch

    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.models.convert import (
        pp_local_tree,
        tp_local_tree,
    )

    t = dict(C.PP2, layers=20)
    cfg = T.get_model_config("llama_750m", num_layers=20)
    for stage, (fwd, rms) in enumerate(((3 * 10 * 8, 6 * 10 * 8),
                                        (2 * 10 * 8, 41 * 8))):
        launches, shapes = C.pp2_want(t, cfg, stage, 1)
        assert (launches["flash_fwd"], launches["flash_bwd_dq"],
                launches["flash_bwd_dkv"], launches["rms_norm"],
                launches["fused_adam"]) == (fwd, 80, 80, rms, 1)
        assert shapes == [(1, 2048, 12, 128)]
    act = 2048 * 1536
    assert C.pp2_traffic_want(t, cfg, 0) == {
        "pipe/activation": [8, 8 * act], "pipe/cotangent": [0, 0],
        "pipe/exchange": [10, None], "pipe/all_reduce": [3, None]}
    assert C.pp2_traffic_want(t, cfg, 1) == {
        "pipe/activation": [0, 0], "pipe/cotangent": [8, 8 * act],
        "pipe/exchange": [10, None], "pipe/all_reduce": [3, None]}
    for P, M in ((2, 4), (4, 8), (4, 4)):
        hops = [C.pp_hops_want(P, M, 1, s) for s in range(P)]
        assert [h["activation"] for h in hops] == [M] * (P - 1) + [0]
        assert [h["cotangent"] for h in hops] == [0] + [M] * (P - 1)
    tb = C.pp2_b(t)
    cfg4 = T.get_model_config("llama_750m", num_layers=4)
    assert (tb["world"], tb["mesh"], tb["layers"]) == (
        4, {"pipe": 2, "tensor": 2}, 4)
    assert C.pp2_want(tb, cfg4, 0, 1)[1] == [(1, 2048, 6, 128)]
    small = T.get_model_config("llama_750m", num_layers=4, hidden_size=128,
                               num_heads=2, ffn_hidden_size=256,
                               vocab_size=512)
    tree = T.init_params(small, torch.Generator().manual_seed(0), "cpu")
    for P, Tn in ((2, 1), (2, 2), (4, 2)):
        for s in range(P):
            mine = tp_local_tree(pp_local_tree(tree, small, P, s), small,
                                 Tn, 1)
            count = sum(v.numel() for _, v in _flat(mine))
            assert C.pp_local_params(small, P, Tn) == count


def test_pp2_phase_rank_rehearsal_on_cpu(tmp_path):
    """The pipeline phase's rank function at tiny size: way (a) on two
    gloo ranks of the CPU in one merged spawn, way (b) on four (the plain
    paths, the counters read 0 there): both train, the stage hops a step
    are PP3's formula, the flash wrapper sees a pipeline micro-batch, the
    rank's parameters are PP4's count, PP1 and PP2 pass against the
    one-process reference, and the measured bubble lies in [0, 1)."""
    import torch

    from deepspeed_tpu_torch.models import transformer as T

    t = dict(C.PP2, model="tiny_llama", layers=2, seq=32,
             gates=tuple(C.PP2_GATES), seed=0)
    cfg = T.get_model_config("tiny_llama", num_layers=2)
    ref = C.pp2_reference(t, torch.device("cpu"), 0, str(tmp_path / "one"))
    ranks = C.spawn_ranks("jobs_rank", 2, 0, [
        ("pp2", "train_llama_750m_pp2_rank",
         dict(t, device="cpu", ref=ref, pp4=True, pp2_gate=True))])
    got = [r["pp2"][0] for r in ranks]
    assert _but_launches(C.pp2_problems(
        "a", dict(t, pp2_gate=True), got, ref, cfg)) == []
    assert [r["main"]["coords"]["pipe"] for r in got] == [0, 1]
    assert got[0]["main"]["flash_shapes"]["flash_fwd"] == [(1, 32, 4, 16)]
    assert all(0 <= r["main"]["bubble_measured"] < 1 for r in got)
    assert {label for label, _, _ in C.PP4_RUNS} <= set(got[0]["pp4"])
    tb = C.pp2_b(t)
    got = C.spawn_ranks("train_llama_750m_pp2_rank", 4, 0,
                        dict(tb, device="cpu", ref=ref))
    cfg4 = T.get_model_config("tiny_llama", num_layers=tb["layers"])
    assert _but_launches(C.pp2_problems("b", tb, got, ref, cfg4)) == []
    assert [(r["main"]["coords"]["pipe"], r["main"]["coords"]["tensor"])
            for r in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_pp_compose_formulas():
    """The composed pipe phase's formulas at its widths: llama_750m at 4
    layers (2 a stage, one a ZeRO-3 chunk at the default prefetch bucket;
    the phase runs PPC_LAYERS), M = 4, gas 2: ZeRO-3's gathers and reduces a step on each stage (PC3),
    Ulysses' all-to-alls at {pipe: 2, seq: 2} (a row's 1,024 positions of
    6 + 6 heads, 3 passes a layer on the last stage and 4 on the others),
    and PC4's reckoned margin from the stage's sizes."""
    from deepspeed_tpu_torch.models import transformer as T

    t = dict(C.PPC, layers=4, device="cpu")
    a = C.ppc_way(t, "a")
    assert (a["world"], a["mesh"], a["zero"]) == (
        4, {"pipe": 2, "data": 2}, {"stage": 3})
    assert C.ppc_zero3_want(a, 2, 0) == {"gather_fwd": 34,
                                         "gather_bwd": 16, "reduce": 18}
    assert C.ppc_zero3_want(a, 2, 1) == {"gather_fwd": 18,
                                         "gather_bwd": 16, "reduce": 18}
    cfg = T.get_model_config("llama_750m", num_layers=4)
    b = C.ppc_way(t, "b")
    per = 2048 // 2 * (2 * 12 + 2 * 12) * 128
    assert C.ppc_seq_want(b, cfg, 0) == {
        "seq/all_to_all": [4 * 4 * 2 * 4 * 2, 4 * 2 * 4 * 2 * per]}
    assert C.ppc_seq_want(b, cfg, 1) == {
        "seq/all_to_all": [4 * 3 * 2 * 4 * 2, 3 * 2 * 4 * 2 * per]}
    n = C.pp_local_params(cfg, 2)
    n_ex = 2 * 32000 * 1536 + 1536
    n_blk = n - n_ex
    assert C.ppc_memory_margin(cfg, 2, 1) == (
        12 * n + 4 * n_blk - 2 * n_ex - 12 * (n_blk // 2))
    assert C.ppc_memory_margin(cfg, 2, 1) == 1_549_347_840
    assert C.ppc_way(t, "d")["world"] == 2
    assert C.ppc_way(t, "c")["model"] == "moe_350m"
    # the phase's depth: one layer, one chunk a stage
    cfg2 = T.get_model_config("llama_750m", num_layers=C.PPC_LAYERS)
    assert C.ppc_memory_margin(cfg2, 2, 1) == 1_096_313_856
    assert C.ppc_zero3_want(a, 1, 0) == {"gather_fwd": 18,
                                         "gather_bwd": 8, "reduce": 10}


def test_pp_compose_phase_rank_rehearsal_on_cpu():
    """The composed pipe phase's rank function at tiny size: ways (a)-(c)
    on four gloo ranks of the CPU in one merged spawn, (d) on two (the
    plain paths, the counters read 0 there): every way trains and every
    gate passes but the card-only PC4 — ZeRO-3's gathers by formula, the
    seq group's all-to-alls, the MoE step against {pipe: 2, data: 2} with
    the grouped GEMM on a received buffer, the offload tier bit-equal."""
    from deepspeed_tpu_torch.models import transformer as T

    t = dict(C.PPC, model="tiny_llama", layers=2, seq=32, device="cpu")
    ways = {w: C.ppc_way(t, w) for w in C.PPC_WAYS}
    ways["c"].update(model="tiny_moe", seq=32)
    ranks = C.spawn_ranks("jobs_rank", 4, 0, [
        (f"ppc/{w}", "train_llama_750m_pp_compose_rank", ways[w])
        for w in "abc"])
    got = {w: [r[f"ppc/{w}"][0] for r in ranks] for w in "abc"}
    got["d"] = C.spawn_ranks("train_llama_750m_pp_compose_rank", 2, 0,
                             ways["d"])
    for w, tw in ways.items():
        cfg = T.get_model_config(tw["model"], num_layers=tw["layers"])
        assert _but_launches(C.ppc_problems(tw, got[w], cfg)) == [], w
    assert [r["main"]["coords"]["pipe"] for r in got["a"]] == [0, 0, 1, 1]
    assert got["a"][0]["main"]["zero3_counts"]["reduce"] > 0
    assert got["b"][0]["main"]["flash_shapes"]["flash_fwd"] == [
        (1, 32, 2, 16)]
    assert got["c"][0]["ep_buffer"]["routed_rows"] > 0


def test_sp_tp_moe_compose_formulas():
    """The composed seq / tensor phase's formulas at its widths (gas 2, one
    step): (b) moe_350m at {expert: 2, seq: 2} — a rank's 2 rows × 512
    positions, its expert buffer 2 × 2,048 rows, Ulysses' all-to-alls of
    its 6 + 6 heads; (d) at {expert: 2, tensor: 2} — the tensor group's
    6 all-reduces a layer and 5 a micro-batch beside, the received rows'
    outputs of a rank's 1,024 positions of 2 rows ([2 × 4,096, 768]
    twice a layer), and the norm's two sliced classes; the seq expert
    buffer and the tensor expert slice a rank's [2, 768, 1536] GEMM."""
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.moe.layer import ep_shard_capacity

    t = dict(C.STM, layers=C.STM_LAYERS, device="cpu")
    cfg = T.get_model_config("moe_350m", num_layers=2)
    b = C.stm_way(t, "b")
    assert (b["world"], b["mesh"], b["seq"]) == (
        4, {"expert": 2, "seq": 2}, 1024)
    want = C.stm_moe_seq_traffic_want(b, cfg)
    rows = 2 * ep_shard_capacity(2 * 512 * 2, 2)
    assert rows == 2 * 2048
    assert want["expert/all_to_all"] == [8 * 2 * 2, 2 * 2 * (
        6 * rows * 768 + 2 * rows)]
    assert want["batch/all_reduce"] == [5 * 2 * 2, 2 * 2 * (3 * 8 + 4)]
    assert want["seq/all_to_all"] == [4 * 3 * 2 * 2, 3 * 2 * 2 * 2 * 512
                                      * (2 * 12 + 2 * 12) * 64]
    d = C.stm_way(t, "d")
    assert (d["world"], d["mesh"], d["attention"]) == (
        4, {"expert": 2, "tensor": 2}, "flash")
    B, S, H = 2, 1024, 768
    R = B * (S - 1)
    rows = 2 * ep_shard_capacity(B * S * 2, 2)
    assert C.stm_tensor_traffic_want(d, cfg, 2) == {"tensor/all_reduce": [
        2 * (6 * 2 + 5) + 1,
        2 * (B * S * H + 2 * (4 * B * S * H + 2 * rows * H) + 3 * R
             + R * H) + 2]}
    assert C.stm_way(t, "c")["world"] == C.stm_way(t, "e")["world"] == 2
    assert C.stm_batch_ranks(C.stm_way(t, "a")) == 2
    assert C.stm_batch_ranks(d) == C.stm_batch_ranks(
        C.stm_way(t, "e")) == 2
    # a tensor rank's expert slice: E/X experts, F/T columns
    assert (cfg.n_experts // 2, cfg.hidden_size, cfg.ffn_size // 2) == (
        2, 768, 1536)


def test_sp_tp_moe_compose_phase_rank_rehearsal_on_cpu():
    """The composed seq / tensor phase's rank function at tiny size: ways
    (a), (b), (d) on four gloo ranks of the CPU in one merged spawn, (c)
    and (e) on two (the plain paths, the counters read 0 there): every
    way trains and every gate passes but the card-only SC6 peak — SC1
    and SC2 (hpZ's collectives by formula), SC3 (routes over the global
    batch), SC4 (the host step bit-equal in its loss), SC5 (the tensor
    group's all-reduces by formula), the grouped GEMM on each received
    buffer against its plain version, at the tensor slice's width."""
    from deepspeed_tpu_torch.models import transformer as T

    t = dict(C.STM, model="tiny_llama", layers=2, seq=32, device="cpu")
    ways = {w: C.stm_way(t, w) for w in C.STM_WAYS}
    for w in "bde":
        ways[w].update(model="tiny_moe", seq=32)
    ranks = C.spawn_ranks("jobs_rank", 4, 0, [
        (f"stm/{w}", "train_sp_tp_moe_compose_rank", ways[w])
        for w in "abd"])
    got = {w: [r[f"stm/{w}"][0] for r in ranks] for w in "abd"}
    ranks = C.spawn_ranks("jobs_rank", 2, 0, [
        (f"stm/{w}", "train_sp_tp_moe_compose_rank", ways[w])
        for w in "ce"])
    got.update({w: [r[f"stm/{w}"][0] for r in ranks] for w in "ce"})
    for w, tw in ways.items():
        cfg = T.get_model_config(tw["model"], num_layers=tw["layers"])
        assert _but_launches(C.stm_problems(tw, got[w], cfg)) == [], w
    a = got["a"][0]["main"]
    assert a["zero3_counts"]["reduce"] > 0
    assert a["traffic"]["seq_hop/all_reduce"][0] > 0
    assert got["b"][0]["ep_buffer"]["routed_rows"] > 0
    assert got["c"][0]["main"]["host_step"]
    assert got["c"][0]["gates"]["sc_fp32"]["loss_bit_equal"]
    assert got["d"][0]["ep_buffer"]["N"] == 128
    assert got["d"][0]["main"]["traffic"]["tensor/all_reduce"][0] > 0
    assert got["e"][0]["gates"] == {}
