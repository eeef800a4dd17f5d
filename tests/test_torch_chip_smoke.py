"""``chip_smoke.py``'s readers of kernel names, on the CPU.

* ``kernel_kind`` books a profiled kernel under the kind a train step's
  split reports: the grouped GEMM's wgmma body (bf16) and its fp32 body
  under ``moe_gmm`` / ``moe_tgmm`` (tgmm is mode 2), by their demangled
  names (as torch.profiler reports them) and their mangled ones; the
  flash, block-sparse and Evoformer kernels by theirs; cuBLAS GEMMs under
  ``gemm``; anything else under ``other``. A grouped GEMM that fell into
  ``other`` would read 0 under ``moe.gmm``.
* ``sass_kernel_label`` names each instantiation of the three attention and
  GEMM libraries from its mangled name (as cuobjdump prints it), and every
  instantiation the design check requires has a name it can produce.

The names have the form nvcc and the demangler give these kernels, the
anonymous namespace's per-file prefix included.
"""
import pytest

import chip_smoke as C

_GG = "_ZN48_GLOBAL__N__065297f9_15_grouped_gemm_cu_dac80e6d"
_FA = "_ZN51_GLOBAL__N__ac34abae_18_flash_attention_cu_446faa15"
_EV = "_ZN45_GLOBAL__N__2c3e0a11_12_evoformer_cu_8c1d2e6f"
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
    seen = set()
    for n in names:
        fam, dtype, rest = C.sass_kernel_label(n)
        seen.add((fam, f"{dtype} {rest}"))
    for family, text in C.DESIGN_INSTANTIATIONS:
        assert any(f == family and (t == text or t.startswith(text + " "))
                   for f, t in seen), (family, text)
    assert len(C.DESIGN_INSTANTIATIONS) == 24 + 6 + 20


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
