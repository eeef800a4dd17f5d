// Flash attention, forward and backward (dq; dk+dv), for Hopper (sm_90a),
// and block-sparse attention over the same bodies.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py — `_fwd_kernel`
// (via `_fwd`), `_bwd_dq_kernel` and `_bwd_dkv_kernel` (via `_bwd`), the
// Pallas TPU kernels behind `flash_attention`. Same functions:
//   forward  o = softmax(q k^T * scale, mask) v by online softmax over kv
//            tiles, fp32 running max / denominator / accumulator; also the
//            per-row logsumexp lse (fp32); a row with no valid key gives
//            o = 0 and lse = -1e30 (`_finalize`);
//   dq       dq = sum_kv (p * (dp - delta)) k * scale, p recomputed from lse,
//            dp = do v^T, delta = rowsum(do * o) (computed by the caller);
//   dkv      dv = sum_q p^T do, dk = sum_q (p * (dp - delta) * scale)^T q,
//            summed over the rep = N / K query heads of the kv head (GQA).
// Mask: key col < Skv, query row < Sq (backward), and col <= row if causal.
// scale = 1/sqrt(D). Inputs bf16 or fp32, outputs in the input dtype (lse
// fp32).
//
// Layout: q [B, Sq, N, D], k/v [B, Skv, K, D] read in place through their
// strides (no transpose, no repeat of kv for GQA, no padding copy: the
// kernels mask the ragged edge themselves); o/dq [B, Sq, N, D], dk/dv
// [B, Skv, K, D] and lse/delta [B*N, Sq] are contiguous.
//
// What bounds it on this card: operations. At the training shapes (S
// 1024-2048, D 64-128) each q row meets hundreds of keys, so the work is
// 4*S*S*D flops per (batch, head) forward (10 backward) against 4*S*D
// bytes of operands: hundreds of flops a byte, above the H100's ridge (~295
// bf16 flops a byte). The bound is the tensor cores, 989 TF/s in bf16.
//
// bf16 — the main path's type — runs on the tensor cores (the *_mma
// kernels; `tensor_core.cuh` holds the PTX):
// * Every product is mma.sync m16n8k16 with bf16 operands and fp32 sums:
//   forward Q K^T and P V; dq Q K^T, dO V^T and dS K; dkv K Q^T, V dO^T,
//   P^T dO and dS^T Q. Operand fragments come from shared memory by
//   ldmatrix, .trans for the operands stored k-major (V in P V, K in dS K,
//   dO and Q in the dkv products).
// * Tiles stay bf16 in shared memory (half the bytes of fp32 staging),
//   row-major with 16-byte chunks XOR-swizzled by the row (no padding, no
//   bank conflicts for ldmatrix or the copies).
// * Copies are cp.async (16 B, L2 only) into a two-stage ring: K/V tiles
//   (forward, dq) and Q/dO tiles with their lse/delta rows (dkv). Tile
//   j+1 is in flight while tile j computes; one barrier a tile.
// * Forward: a warp owns 16 query rows; Q's fragments are loaded into
//   registers once. The online softmax runs on the accumulator fragments in
//   registers (row max by two quad shuffles; each thread keeps partial row
//   sums, reduced once at the end), in base 2: log2(e) is folded into the
//   scale and exp2 is the SFU's ex2.approx. P is rounded to bf16 in
//   registers and is the A fragment of P V directly (the C layout of two n8
//   blocks is the A layout), so scores never touch shared memory. O is
//   normalised in fp32 and leaves through shared memory in 16-byte
//   coalesced stores.
// * dq: one block per (q tile, batch*head), a warp per 16 rows; Q and dO
//   resident in shared memory, K/V tiles through the ring; S and dP by mma,
//   dS = P (dP - delta) scale in registers, dQ += dS K with dS as the A
//   fragment.
// * dkv: one block per (kv tile, batch*kv head), a warp per 16 keys; K and
//   V resident. The block computes the transposed products S^T = K Q^T and
//   dP^T = V dO^T, whose C fragments (keys x queries) are the A fragments
//   of dV += P^T dO and dK += dS^T Q: P and dS stay in registers and never
//   go through shared memory. dk and dv sum in fp32 registers over the rep
//   query heads x q tiles, deterministically (no atomics).
// * Masks apply only to tiles that cross the causal diagonal or the ragged
//   edge; the causal loops end at the diagonal and the forward/dq grids
//   start with the longest rows.
// * Numerics: P and dS are rounded to bf16 (relative error <= 2^-8 a term)
//   before they enter the tensor cores, where the Pallas kernel and the
//   plain version keep them fp32; the row sums, lse and every accumulator
//   stay fp32.
//
// fp32 keeps the first version's bodies (flash_*_kernel, block_sparse_*_
// kernel: products on the fp32 CUDA cores, tiles staged in shared memory
// as fp32, 256 threads as 16 x 16 with a 4 x (cols/16) register tile
// each): every term exact in fp32, for the card's fp32 gates. TF32 tensor
// cores would keep 10 mantissa bits.
//
// The Pallas grid's sequential kv axis (scratch carried across grid
// steps) becomes a loop over tiles inside one block in every kernel; blocks
// run in any order. Shared memory above 48 KB is opted into once per
// kernel; every launch returns cudaGetLastError() to the wrapper.
//
// Block-sparse attention (block_sparse_* kernels, the same bodies with
// kSparse set). Replaces deepspeed_tpu/ops/pallas/block_sparse.py —
// `_fwd_kernel` (via `_fwd`), `_bwd_dq_kernel` and `_bwd_dkv_kernel` (via
// `_bwd`): the functions above restricted to the `block` x `block` squares
// that an [nq, nkv] {0,1} layout marks active; a row with no active square
// gives o = 0, lse = -1e30 and dq = 0, a key with none dk = dv = 0. The
// Pallas grid visits all nq x nkv squares and skips the inactive ones with
// `pl.when`; here each block walks only its active partners — its q
// square's CSR row (forward, dq) or its kv square's CSC column (dkv),
// uploaded once per layout — so the work, and the bound (operations over
// the active squares), scale with the layout's density and no block idles
// on an inactive square. `block` is a multiple of 64, so every tile lies
// in one square; causal masking inside diagonal squares is the dense
// kernels' own. A dense layout gives the dense kernels' tiles in their
// order, so the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "tensor_core.cuh"

namespace {

using dstpu_attn::kNegInf;
using dstpu_attn::store;
using dstpu_attn::Strides;

constexpr int kThreads = 256;          // 16 x 16

template <typename T, int D, int P>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int rows,
                                          int valid) {
  dstpu_attn::load_tile<T, D, P, kThreads>(dst, src, row_stride, rows, valid);
}

// Which tiles a block visits. Dense (kSparse false): a q tile meets every kv
// tile up to the causal diagonal, and a kv tile every q tile from it. Block-
// sparse (kSparse true): only the `block` x `block` squares of an [nq, nkv]
// {0,1} layout that are 1, given as lists — the layout's rows in CSR
// (row_ptr [nq+1], col_idx) for forward and dq, its columns in CSC (col_ptr
// [nkv+1], row_idx) for dkv. `block` is a multiple of every tile size, so
// a tile lies in one square and needs no layout mask of its own.
struct BlockLists {
  const int* row_ptr;
  const int* col_idx;
  const int* col_ptr;
  const int* row_idx;
  int block;
};

__device__ __forceinline__ bool valid(int row, int col, int Sq, int Skv,
                                      int causal) {
  return row < Sq && col < Skv && (!causal || col <= row);
}

// ------------------------------------------------------------------------ //
// fp32 forward (CUDA cores)
// ------------------------------------------------------------------------ //
template <int D, int BQ, int BKV>
constexpr int fwd_smem_floats() {
  return BQ * D + BKV * (D + 1) + BKV * D + BQ * (BKV + 1) + 3 * BQ;
}

template <typename T, int D, int BQ, int BKV, bool kSparse>
__device__ __forceinline__ void flash_fwd_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int N, int K,
    Strides qs, Strides ks, Strides vs, float scale, int causal,
    BlockLists lay) {
  constexpr int RI = BQ / 16, CJ = BKV / 16, DJ = D / 16;
  constexpr int KP = D + 1, SP = BKV + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                  // [BQ][D]
  float* sK = sQ + BQ * D;           // [BKV][KP]
  float* sV = sK + BKV * KP;         // [BKV][D]
  float* sS = sV + BKV * D;          // [BQ][SP]  scores, then p
  float* sM = sS + BQ * SP;          // running max
  float* sL = sM + BQ;               // running denominator
  float* sA = sL + BQ;               // rescale of this tile

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;   // longest rows first
  const int bn = blockIdx.y, b = bn / N, h = bn % N;
  const int kh = h / (N / K);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;

  load_tile<T, D, D>(sQ, q + b * qs.b + (int64_t)q0 * qs.s + h * qs.h, qs.s,
                     BQ, min(BQ, Sq - q0));
  if (tid < BQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  int t_lo = 0, t_hi = 1;            // dense: one span of kv tiles
  if constexpr (kSparse) {
    t_lo = lay.row_ptr[q0 / lay.block];
    t_hi = lay.row_ptr[q0 / lay.block + 1];
  }
  for (int t = t_lo; t < t_hi; ++t) {
    int c_lo = 0, c_hi = kv_end;
    if constexpr (kSparse) {
      c_lo = lay.col_idx[t] * lay.block;
      c_hi = min(kv_end, c_lo + lay.block);
    }
    for (int c0 = c_lo; c0 < c_hi; c0 += BKV) {
      __syncthreads();                 // the previous tile is consumed
      const int nv = min(BKV, Skv - c0);
      load_tile<T, D, KP>(sK, kb + (int64_t)c0 * ks.s, ks.s, BKV, nv);
      load_tile<T, D, D>(sV, vb + (int64_t)c0 * vs.s, vs.s, BKV, nv);
      __syncthreads();

      float s[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) {
        float qv[RI], kv[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) qv[i] = sQ[(ty + 16 * i) * D + e];
#pragma unroll
        for (int j = 0; j < CJ; ++j) kv[j] = sK[(tx + 16 * j) * KP + e];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          // a masked key gets p = exp(-inf) = 0 against any finite max
          sS[r * SP + c] = valid(q0 + r, c0 + c, Sq, Skv, causal)
                               ? s[i][j] * scale : -INFINITY;
        }
      __syncthreads();

      // online softmax, one warp per row
      for (int r = warp; r < BQ; r += kThreads / 32) {
        float x[BKV / 32];
        float mt = -INFINITY;
#pragma unroll
        for (int t = 0; t < BKV / 32; ++t) {
          x[t] = sS[r * SP + lane + 32 * t];
          mt = fmaxf(mt, x[t]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        }
        const float m_prev = sM[r];
        const float m_new = fmaxf(m_prev, mt);
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < BKV / 32; ++t) {
          const float p = expf(x[t] - m_new);
          sS[r * SP + lane + 32 * t] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          sA[r] = alpha;
          sL[r] = alpha * sL[r] + sum;
          sM[r] = m_new;
        }
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float a = sA[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
      }
#pragma unroll 4
      for (int c = 0; c < BKV; ++c) {
        float p[RI], vv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) p[i] = sS[(ty + 16 * i) * SP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) vv[j] = sV[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();

  const int64_t o_s = (int64_t)N * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (row < Sq) {
      const float l = sL[r];
      const float l_safe = (l == 0.f) ? 1.f : l;
      T* orow = o + ((int64_t)b * Sq + row) * o_s + (int64_t)h * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) store(orow + tx + 16 * j, acc[i][j] / l_safe);
    }
  }
  if (tid < BQ && q0 + tid < Sq) {
    const float l = sL[tid];
    lse[(int64_t)bn * Sq + q0 + tid] =
        (l == 0.f) ? kNegInf : sM[tid] + logf(l);
  }
}

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int N, int K,
                 Strides qs, Strides ks, Strides vs, float scale, int causal,
                 BlockLists lay) {
  flash_fwd_body<T, D, BQ, BKV, false>(q, k, v, o, lse, Sq, Skv, N, K, qs, ks,
                                       vs, scale, causal, lay);
}

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
block_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int Sq, int Skv, int N,
                        int K, Strides qs, Strides ks, Strides vs, float scale,
                        int causal, BlockLists lay) {
  flash_fwd_body<T, D, BQ, BKV, true>(q, k, v, o, lse, Sq, Skv, N, K, qs, ks,
                                      vs, scale, causal, lay);
}

// ------------------------------------------------------------------------ //
// fp32 backward: dq
// ------------------------------------------------------------------------ //
template <int D, int BQ, int BKV>
constexpr int dq_smem_floats() {
  return 2 * BQ * D + 2 * BKV * (D + 1) + BQ * (BKV + 1) + 2 * BQ;
}

template <typename T, int D, int BQ, int BKV, bool kSparse>
__device__ __forceinline__ void flash_bwd_dq_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv,
    int N, int K, Strides qs, Strides ks, Strides vs, Strides dos,
    float scale, int causal, BlockLists lay) {
  constexpr int RI = BQ / 16, CJ = BKV / 16, DJ = D / 16;
  constexpr int KP = D + 1, SP = BKV + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                  // [BQ][D]
  float* sDO = sQ + BQ * D;          // [BQ][D]
  float* sK = sDO + BQ * D;          // [BKV][KP]
  float* sV = sK + BKV * KP;         // [BKV][KP]
  float* sDS = sV + BKV * KP;        // [BQ][SP]
  float* sLse = sDS + BQ * SP;
  float* sDelta = sLse + BQ;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int bn = blockIdx.y, b = bn / N, h = bn % N;
  const int kh = h / (N / K);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nq = min(BQ, Sq - q0);

  load_tile<T, D, D>(sQ, q + b * qs.b + (int64_t)q0 * qs.s + h * qs.h, qs.s,
                     BQ, nq);
  load_tile<T, D, D>(sDO, dout + b * dos.b + (int64_t)q0 * dos.s + h * dos.h,
                     dos.s, BQ, nq);
  if (tid < BQ) {
    const bool in = tid < nq;
    sLse[tid] = in ? lse[(int64_t)bn * Sq + q0 + tid] : 0.f;
    sDelta[tid] = in ? delta[(int64_t)bn * Sq + q0 + tid] : 0.f;
  }
  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  int t_lo = 0, t_hi = 1;            // dense: one span of kv tiles
  if constexpr (kSparse) {
    t_lo = lay.row_ptr[q0 / lay.block];
    t_hi = lay.row_ptr[q0 / lay.block + 1];
  }
  for (int t = t_lo; t < t_hi; ++t) {
    int c_lo = 0, c_hi = kv_end;
    if constexpr (kSparse) {
      c_lo = lay.col_idx[t] * lay.block;
      c_hi = min(kv_end, c_lo + lay.block);
    }
    for (int c0 = c_lo; c0 < c_hi; c0 += BKV) {
      __syncthreads();
      const int nv = min(BKV, Skv - c0);
      load_tile<T, D, KP>(sK, kb + (int64_t)c0 * ks.s, ks.s, BKV, nv);
      load_tile<T, D, KP>(sV, vb + (int64_t)c0 * vs.s, vs.s, BKV, nv);
      __syncthreads();

      float s[RI][CJ], dp[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int e = 0; e < D; ++e) {
        float qv[RI], dov[RI], kv[CJ], vv[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          qv[i] = sQ[(ty + 16 * i) * D + e];
          dov[i] = sDO[(ty + 16 * i) * D + e];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          kv[j] = sK[(tx + 16 * j) * KP + e];
          vv[j] = sV[(tx + 16 * j) * KP + e];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const float p = valid(q0 + r, c0 + c, Sq, Skv, causal)
                              ? expf(s[i][j] * scale - sLse[r]) : 0.f;
          sDS[r * SP + c] = p * (dp[i][j] - sDelta[r]) * scale;
        }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < BKV; ++c) {
        float ds[RI], kv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) ds[i] = sDS[(ty + 16 * i) * SP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) kv[j] = sK[c * KP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
      }
    }
  }

  const int64_t o_s = (int64_t)N * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Sq) {
      T* out = dq + ((int64_t)b * Sq + row) * o_s + (int64_t)h * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) store(out + tx + 16 * j, acc[i][j]);
    }
  }
}

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Skv, int N, int K, Strides qs, Strides ks,
                    Strides vs, Strides dos, float scale, int causal,
                    BlockLists lay) {
  flash_bwd_dq_body<T, D, BQ, BKV, false>(q, k, v, dout, lse, delta, dq, Sq,
                                          Skv, N, K, qs, ks, vs, dos, scale,
                                          causal, lay);
}

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
block_sparse_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, int Sq, int Skv, int N, int K,
                           Strides qs, Strides ks, Strides vs, Strides dos,
                           float scale, int causal, BlockLists lay) {
  flash_bwd_dq_body<T, D, BQ, BKV, true>(q, k, v, dout, lse, delta, dq, Sq,
                                         Skv, N, K, qs, ks, vs, dos, scale,
                                         causal, lay);
}

// ------------------------------------------------------------------------ //
// fp32 backward: dk, dv (summed over the GQA group)
// ------------------------------------------------------------------------ //
template <int D, int BQ, int BKV>
constexpr int dkv_smem_floats() {
  return 2 * BKV * (D + 1) + 2 * BQ * D + 2 * BQ * (BKV + 1) + 2 * BQ;
}

template <typename T, int D, int BQ, int BKV, bool kSparse>
__device__ __forceinline__ void flash_bwd_dkv_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Skv, int N, int K, Strides qs, Strides ks, Strides vs,
    Strides dos, float scale, int causal, BlockLists lay) {
  constexpr int RI = BQ / 16, CJ = BKV / 16, CI = BKV / 16, DJ = D / 16;
  constexpr int KP = D + 1, SP = BKV + 1;
  extern __shared__ float smem[];
  float* sK = smem;                  // [BKV][KP]
  float* sV = sK + BKV * KP;         // [BKV][KP]
  float* sQ = sV + BKV * KP;         // [BQ][D]
  float* sDO = sQ + BQ * D;          // [BQ][D]
  float* sP = sDO + BQ * D;          // [BQ][SP]
  float* sDS = sP + BQ * SP;         // [BQ][SP]
  float* sLse = sDS + BQ * SP;
  float* sDelta = sLse + BQ;

  const int c0 = blockIdx.x * BKV;   // causal: the first tiles do the most
  const int bk = blockIdx.y, b = bk / K, kh = bk % K;
  const int rep = N / K;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nv = min(BKV, Skv - c0);

  load_tile<T, D, KP>(sK, k + b * ks.b + (int64_t)c0 * ks.s + kh * ks.h, ks.s,
                      BKV, nv);
  load_tile<T, D, KP>(sV, v + b * vs.b + (int64_t)c0 * vs.s + kh * vs.h, vs.s,
                      BKV, nv);
  float dk_acc[CI][DJ], dv_acc[CI][DJ];
#pragma unroll
  for (int i = 0; i < CI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: q rows below c0 see none of this tile's keys
  const int qt0 = causal ? c0 / BQ : 0;
  const int n_qt = (Sq + BQ - 1) / BQ;
  int t_lo = 0, t_hi = 1;            // dense: one span of q tiles
  if constexpr (kSparse) {
    t_lo = lay.col_ptr[c0 / lay.block];
    t_hi = lay.col_ptr[c0 / lay.block + 1];
  }
  for (int hh = 0; hh < rep; ++hh) {
    const int h = kh * rep + hh;
    const int64_t bn = (int64_t)b * N + h;
    for (int t = t_lo; t < t_hi; ++t) {
      int qt_lo = qt0, qt_hi = n_qt;
      if constexpr (kSparse) {
        const int i0 = lay.row_idx[t] * (lay.block / BQ);
        qt_lo = max(qt0, i0);
        qt_hi = min(n_qt, i0 + lay.block / BQ);
      }
      for (int qt = qt_lo; qt < qt_hi; ++qt) {
        const int q0 = qt * BQ, nq = min(BQ, Sq - q0);
        __syncthreads();
        load_tile<T, D, D>(sQ, q + b * qs.b + (int64_t)q0 * qs.s + h * qs.h,
                           qs.s, BQ, nq);
        load_tile<T, D, D>(sDO,
                           dout + b * dos.b + (int64_t)q0 * dos.s + h * dos.h,
                           dos.s, BQ, nq);
        if (tid < BQ) {
          const bool in = tid < nq;
          sLse[tid] = in ? lse[bn * Sq + q0 + tid] : 0.f;
          sDelta[tid] = in ? delta[bn * Sq + q0 + tid] : 0.f;
        }
        __syncthreads();

        float s[RI][CJ], dp[RI][CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
        for (int e = 0; e < D; ++e) {
          float qv[RI], dov[RI], kv[CJ], vv[CJ];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            qv[i] = sQ[(ty + 16 * i) * D + e];
            dov[i] = sDO[(ty + 16 * i) * D + e];
          }
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            kv[j] = sK[(tx + 16 * j) * KP + e];
            vv[j] = sV[(tx + 16 * j) * KP + e];
          }
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
              s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
              dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            const int r = ty + 16 * i, c = tx + 16 * j;
            const float p = valid(q0 + r, c0 + c, Sq, Skv, causal)
                                ? expf(s[i][j] * scale - sLse[r]) : 0.f;
            sP[r * SP + c] = p;
            sDS[r * SP + c] = p * (dp[i][j] - sDelta[r]) * scale;
          }
        __syncthreads();

#pragma unroll 4
        for (int r = 0; r < BQ; ++r) {
          float pv[CI], dsv[CI], dov[DJ], qv[DJ];
#pragma unroll
          for (int i = 0; i < CI; ++i) {
            pv[i] = sP[r * SP + ty + 16 * i];
            dsv[i] = sDS[r * SP + ty + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dov[j] = sDO[r * D + tx + 16 * j];
            qv[j] = sQ[r * D + tx + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < CI; ++i)
#pragma unroll
            for (int j = 0; j < DJ; ++j) {
              dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
              dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
            }
        }
      }
    }
  }

  const int64_t o_s = (int64_t)K * D;
#pragma unroll
  for (int i = 0; i < CI; ++i) {
    const int row = c0 + ty + 16 * i;
    if (row < Skv) {
      const int64_t off = ((int64_t)b * Skv + row) * o_s + (int64_t)kh * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        store(dk + off + tx + 16 * j, dk_acc[i][j]);
        store(dv + off + tx + 16 * j, dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Skv, int N, int K,
                     Strides qs, Strides ks, Strides vs, Strides dos,
                     float scale, int causal, BlockLists lay) {
  flash_bwd_dkv_body<T, D, BQ, BKV, false>(q, k, v, dout, lse, delta, dk, dv,
                                           Sq, Skv, N, K, qs, ks, vs, dos,
                                           scale, causal, lay);
}

template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
block_sparse_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int Sq,
                            int Skv, int N, int K, Strides qs, Strides ks,
                            Strides vs, Strides dos, float scale, int causal,
                            BlockLists lay) {
  flash_bwd_dkv_body<T, D, BQ, BKV, true>(q, k, v, dout, lse, delta, dk, dv,
                                          Sq, Skv, N, K, qs, ks, vs, dos,
                                          scale, causal, lay);
}

// ------------------------------------------------------------------------ //
// bf16 on the tensor cores: the tiles a block walks
// ------------------------------------------------------------------------ //

// forward, dq: the kv tiles (from c0, BKV wide) that the q tile at q0
// meets — every tile below kv_end (dense), or those of the active squares
// of its CSR row (sparse)
template <bool kSparse, int BKV>
struct KvWalk {
  int t, t_hi, c0, c_hi, kv_end;

  __device__ __forceinline__ void init(const BlockLists& lay, int q0,
                                       int end) {
    kv_end = end;
    if constexpr (kSparse) {
      t = lay.row_ptr[q0 / lay.block];
      t_hi = lay.row_ptr[q0 / lay.block + 1];
      settle(lay);
    } else {
      t = 0, t_hi = 1, c0 = 0, c_hi = kv_end;
    }
  }
  // the first square from t on that holds a tile below kv_end
  __device__ __forceinline__ void settle(const BlockLists& lay) {
    for (; t < t_hi; ++t) {
      c0 = lay.col_idx[t] * lay.block;
      c_hi = min(kv_end, c0 + lay.block);
      if (c0 < c_hi) return;
    }
  }
  __device__ __forceinline__ bool valid() const { return t < t_hi; }
  __device__ __forceinline__ void advance(const BlockLists& lay) {
    c0 += BKV;
    if (c0 < c_hi) return;
    ++t;
    if constexpr (kSparse) settle(lay);
  }
};

// dkv: the (query head of the group, q tile) pairs that the kv tile at c0
// meets — rep heads x the q tiles from the causal diagonal (dense), or
// those inside the active squares of its CSC column (sparse)
template <bool kSparse, int BQ>
struct QWalk {
  int hh, rep, t, t_lo, t_hi, qt, qt_hi, qt0, n_qt;

  __device__ __forceinline__ void init(const BlockLists& lay, int c0, int r,
                                       int first_qt, int n) {
    hh = 0, rep = r, qt0 = first_qt, n_qt = n;
    if constexpr (kSparse) {
      t_lo = lay.col_ptr[c0 / lay.block];
      t_hi = lay.col_ptr[c0 / lay.block + 1];
    } else {
      t_lo = 0, t_hi = 1;
    }
    t = t_lo;
    settle(lay);
  }
  __device__ __forceinline__ void settle(const BlockLists& lay) {
    for (; hh < rep; ++hh, t = t_lo) {
      for (; t < t_hi; ++t) {
        if constexpr (kSparse) {
          const int i0 = lay.row_idx[t] * (lay.block / BQ);
          qt = max(qt0, i0);
          qt_hi = min(n_qt, i0 + lay.block / BQ);
        } else {
          qt = qt0, qt_hi = n_qt;
        }
        if (qt < qt_hi) return;
      }
    }
  }
  __device__ __forceinline__ bool valid() const { return hh < rep; }
  __device__ __forceinline__ void advance(const BlockLists& lay) {
    if (++qt < qt_hi) return;
    ++t;
    settle(lay);
  }
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A warp's 16 rows x D fp32 fragments (acc[D / 8][4], times the row
// factor f[0] for row g, f[1] for row g + 8) → bf16 rows 16 w .. 16 w + 15
// of the swizzled tile at tile (the warp's own rows: no other warp reads
// them any more) → global rows row0 + r (r < 16, row0 + r < rows) at
// dst + (row0 + r) * dst_stride, in 16-byte coalesced stores.
template <int D>
__device__ __forceinline__ void store_rows(unsigned char* tile,
                                           const float (&acc)[D / 8][4],
                                           const float (&f)[2], int warp,
                                           int lane, dstpu_tc::bf16* dst,
                                           int64_t dst_stride, int row0,
                                           int rows) {
  using namespace dstpu_tc;
  constexpr int CH = D / 8;
  const int g = lane >> 2, tq = lane & 3, r = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    *reinterpret_cast<uint32_t*>(tile + swz<D>(r, j) + 4 * tq) =
        pack_bf16(acc[j][0] * f[0], acc[j][1] * f[0]);
    *reinterpret_cast<uint32_t*>(tile + swz<D>(r + 8, j) + 4 * tq) =
        pack_bf16(acc[j][2] * f[1], acc[j][3] * f[1]);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 16 * CH / 32; ++k) {
    const int i = lane + 32 * k, rr = i / CH, c = i % CH;
    if (row0 + rr < rows) {
      *reinterpret_cast<uint4*>(dst + (row0 + rr) * dst_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<D>(16 * warp + rr, c));
    }
  }
}

// ------------------------------------------------------------------------ //
// bf16 forward
// ------------------------------------------------------------------------ //
template <int D, int BQ, int BKV>
constexpr int tc_fwd_smem_bytes() {
  return (BQ * D + 4 * BKV * D) * 2;    // Q, K x 2 stages, V x 2 stages
}

template <int D, int BQ, int BKV, bool kSparse>
__device__ __forceinline__ void tc_fwd_body(
    const dstpu_tc::bf16* __restrict__ q, const dstpu_tc::bf16* __restrict__ k,
    const dstpu_tc::bf16* __restrict__ v, dstpu_tc::bf16* __restrict__ o,
    float* __restrict__ lse, int Sq, int Skv, int N, int K, Strides qs,
    Strides ks, Strides vs, float scale, int causal, BlockLists lay) {
  using namespace dstpu_tc;
  constexpr int NT = BQ / 16 * 32;
  constexpr int KD = D / 16, NB = BKV / 8, DB = D / 8;
  constexpr uint32_t kKV = BKV * D * 2;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sQ = smem_u32(tc_smem), sK = sQ + BQ * D * 2,
                 sV = sK + 2 * kKV;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;   // longest rows first
  const int bn = blockIdx.y, b = bn / N, h = bn % N;
  const int kh = h / (N / K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const int row = q0 + 16 * warp + (lane >> 2);       // and row + 8
  const Lanes ln(lane);

  load_tile_async<D, BQ, NT>(sQ, q + b * qs.b + (int64_t)q0 * qs.s + h * qs.h,
                             qs.s, min(BQ, Sq - q0));
  const bf16* kb = k + b * ks.b + kh * ks.h;
  const bf16* vb = v + b * vs.b + kh * vs.h;
  KvWalk<kSparse, BKV> w;
  w.init(lay, q0, causal ? min(Skv, q0 + BQ) : Skv);
  if (w.valid()) {
    load_tile_async<D, BKV, NT>(sK, kb + (int64_t)w.c0 * ks.s, ks.s,
                                min(BKV, Skv - w.c0));
    load_tile_async<D, BKV, NT>(sV, vb + (int64_t)w.c0 * vs.s, vs.s,
                                min(BKV, Skv - w.c0));
  }
  cp_async_commit();

  const float c2 = scale * kLog2e;     // scores in base-2 units
  float m[2] = {kNegInf, kNegInf};     // running max of rows row, row + 8
  float l[2] = {0.f, 0.f};             // this thread's part of the row sums
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[KD][4];
  int stage = 0;
  bool first = true;
  while (w.valid()) {
    const int c0 = w.c0;
    KvWalk<kSparse, BKV> nx = w;
    nx.advance(lay);
    cp_async_wait_all();
    __syncthreads();     // tile c0 landed; every warp is done with the other stage
    if (first) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm4(qf[kk], sQ + swz<D>(16 * warp + ln.a_row, 2 * kk + ln.a_ch));
      first = false;
    }
    if (nx.valid()) {
      const int nv = min(BKV, Skv - nx.c0);
      load_tile_async<D, BKV, NT>(sK + (stage ^ 1) * kKV,
                                  kb + (int64_t)nx.c0 * ks.s, ks.s, nv);
      load_tile_async<D, BKV, NT>(sV + (stage ^ 1) * kKV,
                                  vb + (int64_t)nx.c0 * vs.s, vs.s, nv);
    }
    cp_async_commit();
    const uint32_t tK = sK + stage * kKV, tV = sV + stage * kKV;

    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NB / 2; ++j2) {
        uint32_t bk[4];
        ldsm4(bk, tK + swz<D>(16 * j2 + ln.bn_row, 2 * kk + ln.bn_ch));
        mma(s[2 * j2], qf[kk], bk[0], bk[1]);
        mma(s[2 * j2 + 1], qf[kk], bk[2], bk[3]);
      }
    }
    // a masked key gets p = exp2(-inf) = 0 against any finite max
    if ((causal && c0 + BKV - 1 > q0 + 16 * warp) || c0 + BKV > Skv) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * tq + (e & 1);
          const int r = row + 8 * (e >> 1);
          if (col >= Skv || (causal && col > r)) s[j][e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i] * c2);
      alpha[i] = exp2_approx(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      acc[j][0] *= alpha[0], acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1], acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      s[j][0] = exp2_approx(fmaf(s[j][0], c2, -m[0]));
      s[j][1] = exp2_approx(fmaf(s[j][1], c2, -m[0]));
      s[j][2] = exp2_approx(fmaf(s[j][2], c2, -m[1]));
      s[j][3] = exp2_approx(fmaf(s[j][3], c2, -m[1]));
      l[0] += s[j][0] + s[j][1];
      l[1] += s[j][2] + s[j][3];
    }
    // O += P V: P (bf16, registers) is the A fragment, V through .trans
#pragma unroll
    for (int k2 = 0; k2 < BKV / 16; ++k2) {
      uint32_t a[4];
      a_from_c(a, s[2 * k2], s[2 * k2 + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm4_t(bv, tV + swz<D>(16 * k2 + ln.bt_row, 2 * dp + ln.bt_ch));
        mma(acc[2 * dp], a, bv[0], bv[1]);
        mma(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    stage ^= 1;
    w = nx;
  }
  cp_async_wait_all();   // no copy in flight into the tiles reused below
  __syncthreads();

  float f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    f[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
  }
  store_rows<D>(tc_smem, acc, f, warp, lane,
                o + ((int64_t)b * Sq * N + h) * D, (int64_t)N * D,
                q0 + 16 * warp, Sq);
  if (tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      if (r < Sq)
        lse[(int64_t)bn * Sq + r] =
            (l[i] == 0.f) ? kNegInf : (m[i] + log2f(l[i])) * kLn2;
    }
  }
}

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(BQ / 16 * 32)
flash_fwd_kernel_mma(const dstpu_tc::bf16* __restrict__ q,
                     const dstpu_tc::bf16* __restrict__ k,
                     const dstpu_tc::bf16* __restrict__ v,
                     dstpu_tc::bf16* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Skv, int N, int K, Strides qs, Strides ks,
                     Strides vs, float scale, int causal, BlockLists lay) {
  tc_fwd_body<D, BQ, BKV, false>(q, k, v, o, lse, Sq, Skv, N, K, qs, ks, vs,
                                 scale, causal, lay);
}

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(BQ / 16 * 32)
block_sparse_fwd_kernel_mma(const dstpu_tc::bf16* __restrict__ q,
                            const dstpu_tc::bf16* __restrict__ k,
                            const dstpu_tc::bf16* __restrict__ v,
                            dstpu_tc::bf16* __restrict__ o,
                            float* __restrict__ lse, int Sq, int Skv, int N,
                            int K, Strides qs, Strides ks, Strides vs,
                            float scale, int causal, BlockLists lay) {
  tc_fwd_body<D, BQ, BKV, true>(q, k, v, o, lse, Sq, Skv, N, K, qs, ks, vs,
                                scale, causal, lay);
}

// ------------------------------------------------------------------------ //
// bf16 backward: dq
// ------------------------------------------------------------------------ //
template <int D, int BQ, int BKV>
constexpr int tc_dq_smem_bytes() {
  return (2 * BQ * D + 4 * BKV * D) * 2;   // Q, dO, K x 2, V x 2
}

template <int D, int BQ, int BKV, bool kSparse>
__device__ __forceinline__ void tc_dq_body(
    const dstpu_tc::bf16* __restrict__ q, const dstpu_tc::bf16* __restrict__ k,
    const dstpu_tc::bf16* __restrict__ v,
    const dstpu_tc::bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, dstpu_tc::bf16* __restrict__ dq, int Sq,
    int Skv, int N, int K, Strides qs, Strides ks, Strides vs, Strides dos,
    float scale, int causal, BlockLists lay) {
  using namespace dstpu_tc;
  constexpr int NT = BQ / 16 * 32;
  constexpr int KD = D / 16, NB = BKV / 8, DB = D / 8;
  constexpr uint32_t kKV = BKV * D * 2;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sQ = smem_u32(tc_smem), sDO = sQ + BQ * D * 2,
                 sK = sDO + BQ * D * 2, sV = sK + 2 * kKV;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int bn = blockIdx.y, b = bn / N, h = bn % N;
  const int kh = h / (N / K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const int row = q0 + 16 * warp + (lane >> 2);
  const int nq = min(BQ, Sq - q0);
  const Lanes ln(lane);

  load_tile_async<D, BQ, NT>(sQ, q + b * qs.b + (int64_t)q0 * qs.s + h * qs.h,
                             qs.s, nq);
  load_tile_async<D, BQ, NT>(
      sDO, dout + b * dos.b + (int64_t)q0 * dos.s + h * dos.h, dos.s, nq);
  const bf16* kb = k + b * ks.b + kh * ks.h;
  const bf16* vb = v + b * vs.b + kh * vs.h;
  KvWalk<kSparse, BKV> w;
  w.init(lay, q0, causal ? min(Skv, q0 + BQ) : Skv);
  if (w.valid()) {
    load_tile_async<D, BKV, NT>(sK, kb + (int64_t)w.c0 * ks.s, ks.s,
                                min(BKV, Skv - w.c0));
    load_tile_async<D, BKV, NT>(sV, vb + (int64_t)w.c0 * vs.s, vs.s,
                                min(BKV, Skv - w.c0));
  }
  cp_async_commit();

  const float c2 = scale * kLog2e;
  float lse2[2], dl[2];                // rows row, row + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row + 8 * i < Sq;
    lse2[i] = in ? lse[(int64_t)bn * Sq + row + 8 * i] * kLog2e : 0.f;
    dl[i] = in ? delta[(int64_t)bn * Sq + row + 8 * i] : 0.f;
  }
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  int stage = 0;
  while (w.valid()) {
    const int c0 = w.c0;
    KvWalk<kSparse, BKV> nx = w;
    nx.advance(lay);
    cp_async_wait_all();
    __syncthreads();
    if (nx.valid()) {
      const int nv = min(BKV, Skv - nx.c0);
      load_tile_async<D, BKV, NT>(sK + (stage ^ 1) * kKV,
                                  kb + (int64_t)nx.c0 * ks.s, ks.s, nv);
      load_tile_async<D, BKV, NT>(sV + (stage ^ 1) * kKV,
                                  vb + (int64_t)nx.c0 * vs.s, vs.s, nv);
    }
    cp_async_commit();
    const uint32_t tK = sK + stage * kKV, tV = sV + stage * kKV;

    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm4(aq, sQ + swz<D>(16 * warp + ln.a_row, 2 * kk + ln.a_ch));
      ldsm4(ado, sDO + swz<D>(16 * warp + ln.a_row, 2 * kk + ln.a_ch));
#pragma unroll
      for (int j2 = 0; j2 < NB / 2; ++j2) {
        uint32_t bk[4], bv[4];
        ldsm4(bk, tK + swz<D>(16 * j2 + ln.bn_row, 2 * kk + ln.bn_ch));
        mma(s[2 * j2], aq, bk[0], bk[1]);
        mma(s[2 * j2 + 1], aq, bk[2], bk[3]);
        ldsm4(bv, tV + swz<D>(16 * j2 + ln.bn_row, 2 * kk + ln.bn_ch));
        mma(dp[2 * j2], ado, bv[0], bv[1]);
        mma(dp[2 * j2 + 1], ado, bv[2], bv[3]);
      }
    }
    const bool masked =
        (causal && c0 + BKV - 1 > q0 + 16 * warp) || c0 + BKV > Skv;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2_approx(fmaf(s[j][e], c2, -lse2[i]));
        if (masked) {
          const int col = c0 + 8 * j + 2 * tq + (e & 1);
          if (col >= Skv || (causal && col > row + 8 * i)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[i]) * scale;      // dS
      }
    // dQ += dS K: dS (bf16, registers) is the A fragment, K through .trans
#pragma unroll
    for (int k2 = 0; k2 < BKV / 16; ++k2) {
      uint32_t a[4];
      a_from_c(a, s[2 * k2], s[2 * k2 + 1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bk[4];
        ldsm4_t(bk, tK + swz<D>(16 * k2 + ln.bt_row, 2 * dd + ln.bt_ch));
        mma(acc[2 * dd], a, bk[0], bk[1]);
        mma(acc[2 * dd + 1], a, bk[2], bk[3]);
      }
    }
    stage ^= 1;
    w = nx;
  }
  cp_async_wait_all();
  __syncthreads();
  const float f[2] = {1.f, 1.f};
  store_rows<D>(tc_smem, acc, f, warp, lane,
                dq + ((int64_t)b * Sq * N + h) * D, (int64_t)N * D,
                q0 + 16 * warp, Sq);
}

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(BQ / 16 * 32)
flash_bwd_dq_kernel_mma(const dstpu_tc::bf16* __restrict__ q,
                        const dstpu_tc::bf16* __restrict__ k,
                        const dstpu_tc::bf16* __restrict__ v,
                        const dstpu_tc::bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        dstpu_tc::bf16* __restrict__ dq, int Sq, int Skv,
                        int N, int K, Strides qs, Strides ks, Strides vs,
                        Strides dos, float scale, int causal, BlockLists lay) {
  tc_dq_body<D, BQ, BKV, false>(q, k, v, dout, lse, delta, dq, Sq, Skv, N, K,
                                qs, ks, vs, dos, scale, causal, lay);
}

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(BQ / 16 * 32)
block_sparse_bwd_dq_kernel_mma(const dstpu_tc::bf16* __restrict__ q,
                               const dstpu_tc::bf16* __restrict__ k,
                               const dstpu_tc::bf16* __restrict__ v,
                               const dstpu_tc::bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               dstpu_tc::bf16* __restrict__ dq, int Sq,
                               int Skv, int N, int K, Strides qs, Strides ks,
                               Strides vs, Strides dos, float scale,
                               int causal, BlockLists lay) {
  tc_dq_body<D, BQ, BKV, true>(q, k, v, dout, lse, delta, dq, Sq, Skv, N, K,
                               qs, ks, vs, dos, scale, causal, lay);
}

// ------------------------------------------------------------------------ //
// bf16 backward: dk, dv (summed over the GQA group)
// ------------------------------------------------------------------------ //
template <int D, int BQ, int BKV>
constexpr int tc_dkv_smem_bytes() {
  // K, V; Q x 2, dO x 2 (bf16); lse x 2, delta x 2 (fp32)
  return (2 * BKV * D + 4 * BQ * D) * 2 + 4 * BQ * 4;
}

template <int D, int BQ, int BKV, bool kSparse>
__device__ __forceinline__ void tc_dkv_body(
    const dstpu_tc::bf16* __restrict__ q, const dstpu_tc::bf16* __restrict__ k,
    const dstpu_tc::bf16* __restrict__ v,
    const dstpu_tc::bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, dstpu_tc::bf16* __restrict__ dk,
    dstpu_tc::bf16* __restrict__ dv, int Sq, int Skv, int N, int K,
    Strides qs, Strides ks, Strides vs, Strides dos, float scale, int causal,
    BlockLists lay) {
  using namespace dstpu_tc;
  constexpr int NT = BKV / 16 * 32;
  constexpr int KD = D / 16, QB = BQ / 8, DB = D / 8;
  constexpr uint32_t kKV = BKV * D * 2, kQ = BQ * D * 2;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sK = smem_u32(tc_smem), sV = sK + kKV, sQ = sV + kKV,
                 sDO = sQ + 2 * kQ, sRow = sDO + 2 * kQ;
  // per stage: lse [BQ] then delta [BQ], fp32
  const float* rows = reinterpret_cast<const float*>(
      tc_smem + 2 * kKV + 4 * kQ);

  const int c0 = blockIdx.x * BKV;   // causal: the first tiles do the most
  const int bk = blockIdx.y, b = bk / K, kh = bk % K;
  const int rep = N / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const int key = c0 + 16 * warp + (lane >> 2);      // and key + 8
  const int n_qt = (Sq + BQ - 1) / BQ;
  const Lanes ln(lane);

  load_tile_async<D, BKV, NT>(
      sK, k + b * ks.b + (int64_t)c0 * ks.s + kh * ks.h, ks.s,
      min(BKV, Skv - c0));
  load_tile_async<D, BKV, NT>(
      sV, v + b * vs.b + (int64_t)c0 * vs.s + kh * vs.h, vs.s,
      min(BKV, Skv - c0));
  // causal: q rows below c0 see none of this tile's keys
  QWalk<kSparse, BQ> w;
  w.init(lay, c0, rep, causal ? c0 / BQ : 0, n_qt);
  auto prefetch = [&](const QWalk<kSparse, BQ>& at, int stg) {
    const int h = kh * rep + at.hh, q0 = at.qt * BQ, nq = min(BQ, Sq - q0);
    const int64_t r0 = ((int64_t)b * N + h) * Sq + q0;
    load_tile_async<D, BQ, NT>(
        sQ + stg * kQ, q + b * qs.b + (int64_t)q0 * qs.s + h * qs.h, qs.s, nq);
    load_tile_async<D, BQ, NT>(
        sDO + stg * kQ, dout + b * dos.b + (int64_t)q0 * dos.s + h * dos.h,
        dos.s, nq);
    load_vec_async<BQ, NT>(sRow + stg * 2 * BQ * 4, lse + r0, nq);
    load_vec_async<BQ, NT>(sRow + (stg * 2 + 1) * BQ * 4, delta + r0, nq);
  };
  if (w.valid()) prefetch(w, 0);
  cp_async_commit();

  const float c2 = scale * kLog2e;
  float dka[DB][4], dva[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  int stage = 0;
  while (w.valid()) {
    const int q0 = w.qt * BQ;
    QWalk<kSparse, BQ> nx = w;
    nx.advance(lay);
    cp_async_wait_all();
    __syncthreads();
    if (nx.valid()) prefetch(nx, stage ^ 1);
    cp_async_commit();
    const uint32_t tQ = sQ + stage * kQ, tDO = sDO + stage * kQ;
    const float* tL = rows + stage * 2 * BQ;
    const float* tD = tL + BQ;

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys
    float st[QB][4], dpt[QB][4];
#pragma unroll
    for (int j = 0; j < QB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ak[4], av[4];
      ldsm4(ak, sK + swz<D>(16 * warp + ln.a_row, 2 * kk + ln.a_ch));
      ldsm4(av, sV + swz<D>(16 * warp + ln.a_row, 2 * kk + ln.a_ch));
#pragma unroll
      for (int j2 = 0; j2 < QB / 2; ++j2) {
        uint32_t bq[4], bd[4];
        ldsm4(bq, tQ + swz<D>(16 * j2 + ln.bn_row, 2 * kk + ln.bn_ch));
        mma(st[2 * j2], ak, bq[0], bq[1]);
        mma(st[2 * j2 + 1], ak, bq[2], bq[3]);
        ldsm4(bd, tDO + swz<D>(16 * j2 + ln.bn_row, 2 * kk + ln.bn_ch));
        mma(dpt[2 * j2], av, bd[0], bd[1]);
        mma(dpt[2 * j2 + 1], av, bd[2], bd[3]);
      }
    }
    const bool masked = (causal && c0 + 16 * warp + 15 > q0) ||
                        q0 + BQ > Sq || c0 + BKV > Skv;
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      const int qi = 8 * j + 2 * tq;
      const float2 L = *reinterpret_cast<const float2*>(tL + qi);
      const float2 Dl = *reinterpret_cast<const float2*>(tD + qi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? L.y : L.x, dlt = (e & 1) ? Dl.y : Dl.x;
        float p = exp2_approx(fmaf(st[j][e], c2, -lv * kLog2e));
        if (masked) {
          const int qr = q0 + qi + (e & 1), kc = key + 8 * (e >> 1);
          if (kc >= Skv || qr >= Sq || (causal && kc > qr)) p = 0.f;
        }
        dpt[j][e] = p * (dpt[j][e] - dlt) * scale;     // dS^T
        st[j][e] = p;                                 // P^T
      }
    }
    // dV += P^T dO, dK += dS^T Q: P^T, dS^T (bf16, registers) are the A
    // fragments, dO and Q through .trans
#pragma unroll
    for (int k2 = 0; k2 < BQ / 16; ++k2) {
      uint32_t ap[4], as[4];
      a_from_c(ap, st[2 * k2], st[2 * k2 + 1]);
      a_from_c(as, dpt[2 * k2], dpt[2 * k2 + 1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bd[4], bq[4];
        ldsm4_t(bd, tDO + swz<D>(16 * k2 + ln.bt_row, 2 * dd + ln.bt_ch));
        mma(dva[2 * dd], ap, bd[0], bd[1]);
        mma(dva[2 * dd + 1], ap, bd[2], bd[3]);
        ldsm4_t(bq, tQ + swz<D>(16 * k2 + ln.bt_row, 2 * dd + ln.bt_ch));
        mma(dka[2 * dd], as, bq[0], bq[1]);
        mma(dka[2 * dd + 1], as, bq[2], bq[3]);
      }
    }
    stage ^= 1;
    w = nx;
  }
  cp_async_wait_all();
  __syncthreads();
  const float f[2] = {1.f, 1.f};
  const int64_t o_s = (int64_t)K * D, base = ((int64_t)b * Skv * K + kh) * D;
  store_rows<D>(tc_smem, dka, f, warp, lane, dk + base, o_s, c0 + 16 * warp,
                Skv);
  store_rows<D>(tc_smem + kKV, dva, f, warp, lane, dv + base, o_s,
                c0 + 16 * warp, Skv);
}

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(BKV / 16 * 32)
flash_bwd_dkv_kernel_mma(const dstpu_tc::bf16* __restrict__ q,
                         const dstpu_tc::bf16* __restrict__ k,
                         const dstpu_tc::bf16* __restrict__ v,
                         const dstpu_tc::bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         dstpu_tc::bf16* __restrict__ dk,
                         dstpu_tc::bf16* __restrict__ dv, int Sq, int Skv,
                         int N, int K, Strides qs, Strides ks, Strides vs,
                         Strides dos, float scale, int causal, BlockLists lay) {
  tc_dkv_body<D, BQ, BKV, false>(q, k, v, dout, lse, delta, dk, dv, Sq, Skv,
                                 N, K, qs, ks, vs, dos, scale, causal, lay);
}

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(BKV / 16 * 32)
block_sparse_bwd_dkv_kernel_mma(const dstpu_tc::bf16* __restrict__ q,
                                const dstpu_tc::bf16* __restrict__ k,
                                const dstpu_tc::bf16* __restrict__ v,
                                const dstpu_tc::bf16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                dstpu_tc::bf16* __restrict__ dk,
                                dstpu_tc::bf16* __restrict__ dv, int Sq,
                                int Skv, int N, int K, Strides qs, Strides ks,
                                Strides vs, Strides dos, float scale,
                                int causal, BlockLists lay) {
  tc_dkv_body<D, BQ, BKV, true>(q, k, v, dout, lse, delta, dk, dv, Sq, Skv, N,
                                K, qs, ks, vs, dos, scale, causal, lay);
}

// ------------------------------------------------------------------------ //
// launchers
// ------------------------------------------------------------------------ //

// Tiles (rows of q, rows of k/v) of each kernel. fp32: the first version's
// (256 threads). bf16: a warp per 16 rows of the block's resident operand
// (forward, dq: q rows; dkv: kv rows), so 4 warps at 64. A warp's
// fragments and accumulators take 139-255 registers and spill at most 8
// bytes (ptxas; chip_smoke's build phase prints each instantiation), so
// 2-4 blocks fit an SM by registers and shared memory. dkv at D 128 takes
// q tiles of 32 to keep its dk and dv accumulators (128 registers) in
// registers. Larger blocks (8 warps: forward BQ 128, dq BQ 128, dkv BKV
// 128) and smaller tiles (dq BKV 32, dkv BQ 32 at D 64) were no faster on
// an H100 at the main-path shapes. Every tile size divides 64, so a tile
// lies in one layout square.
template <typename T, int D>
struct Tiles;
template <>
struct Tiles<float, 64> {
  static constexpr int kFwdBQ = 64, kFwdBKV = 64, kDqBQ = 64, kDqBKV = 64,
                       kDkvBQ = 64, kDkvBKV = 64;
};
template <>
struct Tiles<float, 128> {
  static constexpr int kFwdBQ = 64, kFwdBKV = 32, kDqBQ = 64, kDqBKV = 32,
                       kDkvBQ = 32, kDkvBKV = 32;
};
template <>
struct Tiles<__nv_bfloat16, 64> {
  static constexpr int kFwdBQ = 64, kFwdBKV = 64, kDqBQ = 64, kDqBKV = 64,
                       kDkvBQ = 64, kDkvBKV = 64;
};
template <>
struct Tiles<__nv_bfloat16, 128> {
  static constexpr int kFwdBQ = 64, kFwdBKV = 64, kDqBQ = 64, kDqBKV = 64,
                       kDkvBQ = 32, kDkvBKV = 64;
};

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

// dynamic shared memory of one block of kernel 0 (forward), 1 (dq) or 2
// (dkv)
template <typename T, int D>
constexpr int smem_bytes(int kernel) {
  using Ti = Tiles<T, D>;
  if constexpr (kTensorCores<T>) {
    return kernel == 0   ? tc_fwd_smem_bytes<D, Ti::kFwdBQ, Ti::kFwdBKV>()
           : kernel == 1 ? tc_dq_smem_bytes<D, Ti::kDqBQ, Ti::kDqBKV>()
                         : tc_dkv_smem_bytes<D, Ti::kDkvBQ, Ti::kDkvBKV>();
  } else {
    return (int)sizeof(float) *
           (kernel == 0   ? fwd_smem_floats<D, Ti::kFwdBQ, Ti::kFwdBKV>()
            : kernel == 1 ? dq_smem_floats<D, Ti::kDqBQ, Ti::kDqBKV>()
                          : dkv_smem_floats<D, Ti::kDkvBQ, Ti::kDkvBKV>());
  }
}

template <typename Kernel>
int opt_in(Kernel* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D, bool kSparse>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int Sq, int Skv, int N, int K, Strides qs, Strides ks,
        Strides vs, float scale, int causal, BlockLists lay,
        cudaStream_t stream) {
  constexpr int BQ = Tiles<T, D>::kFwdBQ, BKV = Tiles<T, D>::kFwdBKV;
  void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, int,
                 int, Strides, Strides, Strides, float, int, BlockLists);
  int threads;
  if constexpr (kTensorCores<T>) {
    kernel = kSparse ? block_sparse_fwd_kernel_mma<D, BQ, BKV>
                     : flash_fwd_kernel_mma<D, BQ, BKV>;
    threads = BQ / 16 * 32;
  } else {
    kernel = kSparse ? block_sparse_fwd_kernel<T, D, BQ, BKV>
                     : flash_fwd_kernel<T, D, BQ, BKV>;
    threads = kThreads;
  }
  const int bytes = smem_bytes<T, D>(0);
  // opt in above 48 KB once per instantiation (a function static: set
  // once, thread-safe; each instantiation launches one kernel)
  static const int err = opt_in(kernel, bytes);
  if (err) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * N);
  kernel<<<grid, threads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Skv, N, K, qs, ks, vs, scale, causal, lay);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kSparse>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqp, int B, int Sq, int Skv,
       int N, int K, Strides qs, Strides ks, Strides vs, Strides dos,
       float scale, int causal, BlockLists lay, cudaStream_t stream) {
  constexpr int BQ = Tiles<T, D>::kDqBQ, BKV = Tiles<T, D>::kDqBKV;
  void (*kernel)(const T*, const T*, const T*, const T*, const float*,
                 const float*, T*, int, int, int, int, Strides, Strides,
                 Strides, Strides, float, int, BlockLists);
  int threads;
  if constexpr (kTensorCores<T>) {
    kernel = kSparse ? block_sparse_bwd_dq_kernel_mma<D, BQ, BKV>
                     : flash_bwd_dq_kernel_mma<D, BQ, BKV>;
    threads = BQ / 16 * 32;
  } else {
    kernel = kSparse ? block_sparse_bwd_dq_kernel<T, D, BQ, BKV>
                     : flash_bwd_dq_kernel<T, D, BQ, BKV>;
    threads = kThreads;
  }
  const int bytes = smem_bytes<T, D>(1);
  // opt in above 48 KB once per instantiation (a function static: set
  // once, thread-safe; each instantiation launches one kernel)
  static const int err = opt_in(kernel, bytes);
  if (err) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * N);
  kernel<<<grid, threads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dqp), Sq, Skv, N, K, qs, ks, vs, dos, scale, causal,
      lay);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kSparse>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dkp, void* dvp, int B,
        int Sq, int Skv, int N, int K, Strides qs, Strides ks, Strides vs,
        Strides dos, float scale, int causal, BlockLists lay,
        cudaStream_t stream) {
  constexpr int BQ = Tiles<T, D>::kDkvBQ, BKV = Tiles<T, D>::kDkvBKV;
  void (*kernel)(const T*, const T*, const T*, const T*, const float*,
                 const float*, T*, T*, int, int, int, int, Strides, Strides,
                 Strides, Strides, float, int, BlockLists);
  int threads;
  if constexpr (kTensorCores<T>) {
    kernel = kSparse ? block_sparse_bwd_dkv_kernel_mma<D, BQ, BKV>
                     : flash_bwd_dkv_kernel_mma<D, BQ, BKV>;
    threads = BKV / 16 * 32;
  } else {
    kernel = kSparse ? block_sparse_bwd_dkv_kernel<T, D, BQ, BKV>
                     : flash_bwd_dkv_kernel<T, D, BQ, BKV>;
    threads = kThreads;
  }
  const int bytes = smem_bytes<T, D>(2);
  // opt in above 48 KB once per instantiation (a function static: set
  // once, thread-safe; each instantiation launches one kernel)
  static const int err = opt_in(kernel, bytes);
  if (err) return err;
  dim3 grid((Skv + BKV - 1) / BKV, B * K);
  kernel<<<grid, threads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dkp), static_cast<T*>(dvp), Sq, Skv, N, K, qs, ks, vs,
      dos, scale, causal, lay);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int Sq, int Skv, int N, int K) {
  return B > 0 && Sq > 0 && Skv > 0 && K > 0 && N % K == 0;
}

// every tile (64 rows at most) lies inside one layout square
bool lists_ok(const BlockLists& lay, int Sq, int Skv) {
  return lay.block > 0 && lay.block % 64 == 0 && Sq % lay.block == 0 &&
         Skv % lay.block == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {64, 128}. Strides are in
// elements, (batch, seq, head) for each of q, k, v (and dout); the head
// dim is contiguous and every row starts 16-byte aligned. Each entry point
// returns a cudaError_t (0 = launched). The block_sparse_* entry points take
// the layout's device lists (int32; see BlockLists) and its block size.
#define DSTPU_DISPATCH(CALL64, CALL128)                              \
  if (dtype == 0 && D == 64) return CALL64(float);                   \
  if (dtype == 0 && D == 128) return CALL128(float);                 \
  if (dtype == 1 && D == 64) return CALL64(__nv_bfloat16);           \
  if (dtype == 1 && D == 128) return CALL128(__nv_bfloat16);         \
  return (int)cudaErrorInvalidValue;

#define DSTPU_FWD_ARGS                                                   \
  const void *q, const void *k, const void *v, void *o, void *lse, int B, \
      int Sq, int Skv, int N, int K, int D, int64_t q_sb, int64_t q_ss,   \
      int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,             \
      int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int causal
#define DSTPU_BWD_IN                                             \
  const void *q, const void *k, const void *v, const void *dout, \
      const void *lse, const void *delta
#define DSTPU_BWD_DIMS                                                   \
  int B, int Sq, int Skv, int N, int K, int D, int64_t q_sb, int64_t q_ss, \
      int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,             \
      int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t do_sb,            \
      int64_t do_ss, int64_t do_sh, float scale, int causal
#define DSTPU_BWD_ARGS DSTPU_BWD_IN, DSTPU_BWD_DIMS

namespace {

int run_fwd(DSTPU_FWD_ARGS, int dtype, const BlockLists& lay, bool sparse,
            cudaStream_t s) {
  if (!shape_ok(B, Sq, Skv, N, K)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
#define F64(T) sparse ? fwd<T, 64, true>(q, k, v, o, lse, B, Sq, Skv, N, K, qs, ks, vs, scale, causal, lay, s) \
                      : fwd<T, 64, false>(q, k, v, o, lse, B, Sq, Skv, N, K, qs, ks, vs, scale, causal, lay, s)
#define F128(T) sparse ? fwd<T, 128, true>(q, k, v, o, lse, B, Sq, Skv, N, K, qs, ks, vs, scale, causal, lay, s) \
                       : fwd<T, 128, false>(q, k, v, o, lse, B, Sq, Skv, N, K, qs, ks, vs, scale, causal, lay, s)
  DSTPU_DISPATCH(F64, F128)
#undef F64
#undef F128
}

int run_dq(DSTPU_BWD_ARGS, void* dqp, int dtype, const BlockLists& lay,
           bool sparse, cudaStream_t s) {
  if (!shape_ok(B, Sq, Skv, N, K)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, dos{do_sb, do_ss, do_sh};
#define F64(T) sparse ? dq<T, 64, true>(q, k, v, dout, lse, delta, dqp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s) \
                      : dq<T, 64, false>(q, k, v, dout, lse, delta, dqp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s)
#define F128(T) sparse ? dq<T, 128, true>(q, k, v, dout, lse, delta, dqp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s) \
                       : dq<T, 128, false>(q, k, v, dout, lse, delta, dqp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s)
  DSTPU_DISPATCH(F64, F128)
#undef F64
#undef F128
}

int run_dkv(DSTPU_BWD_ARGS, void* dkp, void* dvp, int dtype,
            const BlockLists& lay, bool sparse, cudaStream_t s) {
  if (!shape_ok(B, Sq, Skv, N, K)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, dos{do_sb, do_ss, do_sh};
#define F64(T) sparse ? dkv<T, 64, true>(q, k, v, dout, lse, delta, dkp, dvp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s) \
                      : dkv<T, 64, false>(q, k, v, dout, lse, delta, dkp, dvp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s)
#define F128(T) sparse ? dkv<T, 128, true>(q, k, v, dout, lse, delta, dkp, dvp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s) \
                       : dkv<T, 128, false>(q, k, v, dout, lse, delta, dkp, dvp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s)
  DSTPU_DISPATCH(F64, F128)
#undef F64
#undef F128
}

constexpr BlockLists kDense{nullptr, nullptr, nullptr, nullptr, 0};

}  // namespace

#define DSTPU_FWD_PASS                                                   \
  q, k, v, o, lse, B, Sq, Skv, N, K, D, q_sb, q_ss, q_sh, k_sb, k_ss,    \
      k_sh, v_sb, v_ss, v_sh, scale, causal
#define DSTPU_BWD_PASS                                                   \
  q, k, v, dout, lse, delta, B, Sq, Skv, N, K, D, q_sb, q_ss, q_sh, k_sb, \
      k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, scale, causal

extern "C" int dstpu_flash_fwd(DSTPU_FWD_ARGS, int dtype, void* stream) {
  return run_fwd(DSTPU_FWD_PASS, dtype, kDense, false,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int dstpu_flash_bwd_dq(DSTPU_BWD_IN, void* dqp, DSTPU_BWD_DIMS,
                                  int dtype, void* stream) {
  return run_dq(DSTPU_BWD_PASS, dqp, dtype, kDense, false,
                static_cast<cudaStream_t>(stream));
}

extern "C" int dstpu_flash_bwd_dkv(DSTPU_BWD_IN, void* dkp, void* dvp,
                                   DSTPU_BWD_DIMS, int dtype, void* stream) {
  return run_dkv(DSTPU_BWD_PASS, dkp, dvp, dtype, kDense, false,
                 static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) of one block of kernel 0 (forward, also
// block-sparse), 1 (dq) or 2 (dkv) at dtype and D; -1 if none is built.
extern "C" int dstpu_flash_smem_bytes(int kernel, int dtype, int D) {
  if (kernel < 0 || kernel > 2) return -1;
  if (dtype == 0 && D == 64) return smem_bytes<float, 64>(kernel);
  if (dtype == 0 && D == 128) return smem_bytes<float, 128>(kernel);
  if (dtype == 1 && D == 64) return smem_bytes<__nv_bfloat16, 64>(kernel);
  if (dtype == 1 && D == 128) return smem_bytes<__nv_bfloat16, 128>(kernel);
  return -1;
}

// Block-sparse: the layout's CSR row_ptr/col_idx (forward, dq) or CSC
// col_ptr/row_idx (dkv), int32 on the device; block a multiple of 64 that
// divides Sq and Skv.
extern "C" int dstpu_block_sparse_fwd(DSTPU_FWD_ARGS, const int* row_ptr,
                                      const int* col_idx, int block,
                                      int dtype, void* stream) {
  const BlockLists lay{row_ptr, col_idx, nullptr, nullptr, block};
  if (!lists_ok(lay, Sq, Skv)) return (int)cudaErrorInvalidValue;
  return run_fwd(DSTPU_FWD_PASS, dtype, lay, true,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int dstpu_block_sparse_bwd_dq(DSTPU_BWD_IN, void* dqp,
                                         DSTPU_BWD_DIMS, const int* row_ptr,
                                         const int* col_idx, int block,
                                         int dtype, void* stream) {
  const BlockLists lay{row_ptr, col_idx, nullptr, nullptr, block};
  if (!lists_ok(lay, Sq, Skv)) return (int)cudaErrorInvalidValue;
  return run_dq(DSTPU_BWD_PASS, dqp, dtype, lay, true,
                static_cast<cudaStream_t>(stream));
}

extern "C" int dstpu_block_sparse_bwd_dkv(DSTPU_BWD_IN, void* dkp,
                                          void* dvp, DSTPU_BWD_DIMS,
                                          const int* col_ptr,
                                          const int* row_idx, int block,
                                          int dtype, void* stream) {
  const BlockLists lay{nullptr, nullptr, col_ptr, row_idx, block};
  if (!lists_ok(lay, Sq, Skv)) return (int)cudaErrorInvalidValue;
  return run_dkv(DSTPU_BWD_PASS, dkp, dvp, dtype, lay, true,
                 static_cast<cudaStream_t>(stream));
}
