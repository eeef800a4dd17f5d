// Flash attention, forward and backward (dq; dk+dv), for Hopper (sm_90a).
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
// scale = 1/sqrt(D). Inputs bf16 or fp32, all arithmetic fp32, outputs in
// the input dtype (lse fp32).
//
// Layout: q [B, Sq, N, D], k/v [B, Skv, K, D] read in place through their
// strides (no transpose, no repeat of kv for GQA, no padding copy: the
// kernels mask the ragged edge themselves); o/dq [B, Sq, N, D], dk/dv
// [B, Skv, K, D] and lse/delta [B*N, Sq] are contiguous.
//
// What bounds it on this card: operations. At the training shapes
// (S 1024-2048, D 64-128) each q row meets hundreds of keys, so the work
// is 4*S*S*D flops per (batch, head) against 4*S*D bytes of each operand —
// hundreds of flops a byte, above the H100's ridge. The bound is the tensor
// cores (989 TF/s bf16); this first version runs the products on the fp32
// CUDA cores (67 TF/s peak), which makes the arithmetic exact per term —
// a bf16 x bf16 product is exact in fp32, as the Pallas kernel's
// upcast-then-dot is — and simple to hold against the plain version.
// wgmma/mma.sync, TMA and a copy pipeline are later work.
//
// Design (what replaces the TPU structure):
// * The Pallas grid's sequential kv axis (scratch carried across grid
//   steps) becomes a loop over kv tiles inside one block; blocks run in any
//   order. forward and dq: one block per (q tile, batch*head); dkv: one
//   block per (kv tile, batch*kv head) that loops over the rep q heads of
//   its group x q tiles and keeps dk and dv in registers — the group sum of
//   `_bwd_dkv_kernel`'s flattened inner axis, with no atomics, so results
//   are deterministic.
// * Causal: kv tiles wholly above the diagonal are never visited, and the
//   forward/dq grids start with the longest rows.
// * Tiles are staged in shared memory as fp32 with 16-byte global loads
//   (neighbouring threads on neighbouring addresses); K/V rows are padded
//   by one float so the column-per-thread dot products are free of bank
//   conflicts. 256 threads as 16 x 16: a thread owns a 4 x (cols/16)
//   register tile of S and of the output accumulators.
// * Shared memory above 48 KB is opted into once per kernel; every launch
//   returns cudaGetLastError() to the wrapper.
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
// kernels' own. The dense instantiation (kSparse false) compiles to the
// loops it had before the schedule was added.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

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
// forward
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
// backward: dq
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
// backward: dk, dv (summed over the GQA group)
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
// launchers
// ------------------------------------------------------------------------ //

template <typename T, int D, int BQ, int BKV, bool kSparse>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int Sq, int Skv, int N, int K, Strides qs, Strides ks,
        Strides vs, float scale, int causal, BlockLists lay,
        cudaStream_t stream) {
  auto kernel = kSparse ? block_sparse_fwd_kernel<T, D, BQ, BKV>
                        : flash_fwd_kernel<T, D, BQ, BKV>;
  const int bytes = fwd_smem_floats<D, BQ, BKV>() * (int)sizeof(float);
  // opt in above 48 KB once per instantiation (a function static: set
  // once, thread-safe; each instantiation launches one kernel)
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * N);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Skv, N, K, qs, ks, vs, scale, causal, lay);
  return (int)cudaGetLastError();
}

template <typename T, int D, int BQ, int BKV, bool kSparse>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqp, int B, int Sq, int Skv,
       int N, int K, Strides qs, Strides ks, Strides vs, Strides dos,
       float scale, int causal, BlockLists lay, cudaStream_t stream) {
  auto kernel = kSparse ? block_sparse_bwd_dq_kernel<T, D, BQ, BKV>
                        : flash_bwd_dq_kernel<T, D, BQ, BKV>;
  const int bytes = dq_smem_floats<D, BQ, BKV>() * (int)sizeof(float);
  // opt in above 48 KB once per instantiation (a function static: set
  // once, thread-safe; each instantiation launches one kernel)
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * N);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dqp), Sq, Skv, N, K, qs, ks, vs, dos, scale, causal,
      lay);
  return (int)cudaGetLastError();
}

template <typename T, int D, int BQ, int BKV, bool kSparse>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dkp, void* dvp, int B,
        int Sq, int Skv, int N, int K, Strides qs, Strides ks, Strides vs,
        Strides dos, float scale, int causal, BlockLists lay,
        cudaStream_t stream) {
  auto kernel = kSparse ? block_sparse_bwd_dkv_kernel<T, D, BQ, BKV>
                        : flash_bwd_dkv_kernel<T, D, BQ, BKV>;
  const int bytes = dkv_smem_floats<D, BQ, BKV>() * (int)sizeof(float);
  // opt in above 48 KB once per instantiation (a function static: set
  // once, thread-safe; each instantiation launches one kernel)
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Skv + BKV - 1) / BKV, B * K);
  kernel<<<grid, kThreads, bytes, stream>>>(
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
#define F64(T) sparse ? fwd<T, 64, 64, 64, true>(q, k, v, o, lse, B, Sq, Skv, N, K, qs, ks, vs, scale, causal, lay, s) \
                      : fwd<T, 64, 64, 64, false>(q, k, v, o, lse, B, Sq, Skv, N, K, qs, ks, vs, scale, causal, lay, s)
#define F128(T) sparse ? fwd<T, 128, 64, 32, true>(q, k, v, o, lse, B, Sq, Skv, N, K, qs, ks, vs, scale, causal, lay, s) \
                       : fwd<T, 128, 64, 32, false>(q, k, v, o, lse, B, Sq, Skv, N, K, qs, ks, vs, scale, causal, lay, s)
  DSTPU_DISPATCH(F64, F128)
#undef F64
#undef F128
}

int run_dq(DSTPU_BWD_ARGS, void* dqp, int dtype, const BlockLists& lay,
           bool sparse, cudaStream_t s) {
  if (!shape_ok(B, Sq, Skv, N, K)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, dos{do_sb, do_ss, do_sh};
#define F64(T) sparse ? dq<T, 64, 64, 64, true>(q, k, v, dout, lse, delta, dqp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s) \
                      : dq<T, 64, 64, 64, false>(q, k, v, dout, lse, delta, dqp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s)
#define F128(T) sparse ? dq<T, 128, 64, 32, true>(q, k, v, dout, lse, delta, dqp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s) \
                       : dq<T, 128, 64, 32, false>(q, k, v, dout, lse, delta, dqp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s)
  DSTPU_DISPATCH(F64, F128)
#undef F64
#undef F128
}

int run_dkv(DSTPU_BWD_ARGS, void* dkp, void* dvp, int dtype,
            const BlockLists& lay, bool sparse, cudaStream_t s) {
  if (!shape_ok(B, Sq, Skv, N, K)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, dos{do_sb, do_ss, do_sh};
#define F64(T) sparse ? dkv<T, 64, 64, 64, true>(q, k, v, dout, lse, delta, dkp, dvp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s) \
                      : dkv<T, 64, 64, 64, false>(q, k, v, dout, lse, delta, dkp, dvp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s)
#define F128(T) sparse ? dkv<T, 128, 32, 32, true>(q, k, v, dout, lse, delta, dkp, dvp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s) \
                       : dkv<T, 128, 32, 32, false>(q, k, v, dout, lse, delta, dkp, dvp, B, Sq, Skv, N, K, qs, ks, vs, dos, scale, causal, lay, s)
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
