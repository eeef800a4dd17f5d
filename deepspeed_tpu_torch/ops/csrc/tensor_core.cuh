// Warp-level tensor-core helpers for the bf16 attention kernels
// (flash_attention.cu, evoformer.cu): 16-byte `cp.async` copies into XOR-
// swizzled shared tiles, `ldmatrix` fragment loads, and the m16n8k16 bf16
// `mma.sync` with fp32 sums. Inline PTX (sm_80 and later), no library headers.
//
// Shared tiles are [rows][D] bf16, row-major, with the 16-byte chunks of
// row r stored at chunk index c ^ (r & 7) (D >= 64: 8 or more chunks a
// row). A narrower row of CH = D / 8 < 8 chunks takes 8 / CH rows to fill
// 128 bytes, so chunk c of row r goes to c ^ ((r / (8 / CH)) & (CH - 1)):
// D 32 c ^ ((r >> 1) & 3), D 16 c ^ ((r >> 2) & 1), D 8 no swizzle. The 8
// rows an `ldmatrix` phase reads (one chunk each) and the 128 bytes that
// one phase of a copy writes then fall in 8 distinct groups of 4 banks:
// both are free of bank conflicts, with no padding.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane l holds, with
// g = l / 4 and t = l % 4,
//   A (16 x 16, row-major):  a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                            a2 = A[g][2t+8..+9],   a3 = A[g+8][2t+8..+9];
//   B (16 x 8, "col"):       b0 = B[2t..2t+1][g],   b1 = B[2t+8..+9][g];
//   C (16 x 8, fp32):        c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][..].
// So the C fragments of two neighbouring n8 blocks, rounded to bf16 in
// pairs, are the A fragment of the next product over those 16 columns: P
// (and dS) go from one mma to the next in registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dstpu_tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (8 bf16) of row r in a swizzled [r][D] tile
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int CH = D / 8;
  if constexpr (CH >= 8) {
    return static_cast<uint32_t>(r * (D * 2) + ((c ^ (r & 7)) << 4));
  } else {
    return static_cast<uint32_t>(r * (D * 2) +
                                 ((c ^ ((r / (8 / CH)) & (CH - 1))) << 4));
  }
}

// 16 bytes global → shared, bypassing L1; pred false zero-fills the 16
// bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// 4 bytes global → shared; pred false zero-fills
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread has started has landed (the caller then takes a
// barrier so that every thread's copies are visible)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows x D bf16 at src (row r at src + r * stride, D contiguous, 16-byte
// aligned rows) into the swizzled tile at dst; rows >= valid are zero-
// filled. All NT threads of the block take part.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src,
                                                int64_t stride, int valid) {
  constexpr int CH = D / 8;
  static_assert((ROWS * CH) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int k = 0; k < ROWS * CH / NT; ++k) {
    const int i = threadIdx.x + k * NT;
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid;
    cp_async16(dst + swz<D>(r, c), src + (ok ? r * stride + c * 8 : 0), ok);
  }
}

// n fp32 at src into dst; entries >= valid are zero-filled
template <int N, int NT>
__device__ __forceinline__ void load_vec_async(uint32_t dst, const float* src,
                                               int valid) {
  for (int i = threadIdx.x; i < N; i += NT) {
    const bool ok = i < valid;
    cp_async4(dst + 4 * i, src + (ok ? i : 0), ok);
  }
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Lane l's row and chunk offsets for one ldmatrix.x4 (rows from a multiple
// of 16, chunks from an even chunk):
//   A fragment (16 rows x 16 cols):                row l % 16, chunk l / 16;
//   B, tile rows are n (two n8 blocks x k16):      row l % 8 + 8 (l / 16),
//                                                  chunk (l / 8) % 2;
//   B, tile rows are k (.trans; k16 x two n8):     row l % 8 + 8 ((l / 8) % 2),
//                                                  chunk l / 16.
// r[0], r[1] are then the fragment of the first n8 block, r[2], r[3] the
// second's (B), or a0..a3 (A).
struct Lanes {
  int a_row, a_ch, bn_row, bn_ch, bt_row, bt_ch;
  __device__ __forceinline__ explicit Lanes(int l)
      : a_row(l & 15), a_ch(l >> 4), bn_row((l & 7) + ((l >> 4) << 3)),
        bn_ch((l >> 3) & 1), bt_row((l & 7) + (((l >> 3) & 1) << 3)),
        bt_ch(l >> 4) {}
};

// d += a * b, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 → one bf16x2 register, round to nearest even; lo in bits 0-15
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment over 16 columns from the C fragments of two n8 blocks
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 2^x by the SFU (ex2.approx: about 2 ulp; -inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace dstpu_tc
