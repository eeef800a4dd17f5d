// Evoformer attention forward (non-causal flash attention with an additive
// bias) for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/evoformer.py — `_evo_fwd_kernel` (via
// `_evo_flash_fwd`), the Pallas TPU kernel behind `evoformer_flash`. Same
// function, per flat head b = g * N + n:
//   s = q k^T * scale + bias[b or n]   (fp32; scale = 1/sqrt(D))
//   o = sum_k exp(s - m) v / max(l, 1e-30), online over kv tiles with the
//       running max m starting at -1e30 and l = sum_k exp(s - m),
// so a row whose bias is -inf everywhere gives 0, as in the Pallas kernel.
// Inputs q/k/v bf16 or fp32, bias bf16 or fp32 in its own dtype, the
// softmax in fp32, the output in q's dtype. The backward is not a kernel in
// the JAX package (jax.vjp of the jnp reference), nor here.
//
// Layout: q/k/v [G, S, N, D] read in place through their strides (no
// transpose, no padding copy: the kernel masks the ragged edge itself, where
// the Pallas wrapper padded S to its block); bias [Gb, N, S, S] contiguous,
// Gb = 1 (shared by all G rows: head b reads bias row n — never expanded)
// or Gb = G (head b reads row b), read tile by tile; o [G, S, N, D]
// contiguous. D in {8, 16, 32, 64, 128}.
//
// What bounds it on this card: bytes, at the Evoformer's widths. Each
// (g, n) reads its S x S bias once and does 4 S^2 D flops: D flops a bias
// element, far below the H100's ridge (~295 bf16 ops a byte). OpenFold's
// triangle attention (G 256, S 256, N 4, D 32, a per-row bias) moves 201 MB
// in bf16 for 8.6 GFLOP. Both designs read the bias once and keep the S x S
// scores out of device memory.
//
// bf16 q/k/v (either bias dtype): the tensor cores, on PR 6's flash forward
// design (tensor_core.cuh). A block of 4 warps per (flat head, 64-row q
// tile), each warp 16 rows, a loop over 64-key tiles (the Pallas grid's
// sequential kv axis). The q tile's fragments stay in registers; K, V and
// the bias tile (in its own dtype, rows swizzled like the others) are
// double-buffered by cp.async, so the next tile's copies overlap this
// tile's products: one barrier a tile. S = Q K^T by mma.sync m16n8k16 (fp32
// sums), then scale and the bias in the C fragment in the reference's
// order of rounding; the online softmax in registers (quad shuffles); P,
// rounded to bf16, is the A fragment of P V, V read by ldmatrix.trans.
// D 8 is staged 16 wide, its second half zero-filled by cp.async's
// src-size: the product's depth is 16. Only the last kv tile masks keys
// past S; rows past S are computed and not written.
// fp32 q/k/v: the CUDA cores (exact fp32 products). q, K and V tiles are
// staged in shared memory as fp32 (K rows padded by one float: conflict-
// free column reads). Scores: 16 x 16 threads, each a 4 x 4 register tile;
// the online softmax: one warp per row; P V: the D columns spread over
// min(16, D) threads and the 64 rows over the rest, so D = 8 uses all 256
// threads too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "tensor_core.cuh"

namespace {

using dstpu_attn::kNegInf;
using dstpu_attn::load_tile;
using dstpu_attn::store;
using dstpu_attn::Strides;
using dstpu_attn::to_float;

constexpr int kThreads = 256;
constexpr int BQ = 64, BKV = 64;

template <int D>
constexpr int smem_floats() {
  return BQ * D + BKV * (D + 1) + BKV * D + BQ * (BKV + 1) + 3 * BQ;
}

template <typename T, typename TB, int D>
__global__ void __launch_bounds__(kThreads)
evoformer_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const TB* __restrict__ bias,
                     T* __restrict__ o, int S, int N, int Gb, Strides qs,
                     Strides ks, Strides vs, float scale) {
  constexpr int RI = BQ / 16, CJ = BKV / 16;   // a thread's score tile
  constexpr int TC = D < 16 ? D : 16;          // threads across D
  constexpr int TR = kThreads / TC;            // threads across rows
  constexpr int OR = BQ / TR, OC = D / TC;     // a thread's output tile
  constexpr int KP = D + 1, SP = BKV + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                  // [BQ][D]
  float* sK = sQ + BQ * D;           // [BKV][KP]
  float* sV = sK + BKV * KP;         // [BKV][D]
  float* sS = sV + BKV * D;          // [BQ][SP]  scores, then p
  float* sM = sS + BQ * SP;          // running max
  float* sL = sM + BQ;               // running denominator
  float* sA = sL + BQ;               // rescale of this tile

  const int bn = blockIdx.x, g = bn / N, h = bn % N;
  const int q0 = blockIdx.y * BQ;
  const TB* bb = bias + (int64_t)(Gb == 1 ? h : bn) * S * S;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int ox = tid % TC, oy = tid / TC;

  load_tile<T, D, D, kThreads>(
      sQ, q + g * qs.b + (int64_t)q0 * qs.s + h * qs.h, qs.s, BQ,
      min(BQ, S - q0));
  if (tid < BQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[OR][OC];
#pragma unroll
  for (int i = 0; i < OR; ++i)
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[i][j] = 0.f;

  const T* kb = k + g * ks.b + h * ks.h;
  const T* vb = v + g * vs.b + h * vs.h;
  for (int c0 = 0; c0 < S; c0 += BKV) {
    __syncthreads();                 // the previous tile is consumed
    const int nv = min(BKV, S - c0);
    load_tile<T, D, KP, kThreads>(sK, kb + (int64_t)c0 * ks.s, ks.s, BKV, nv);
    load_tile<T, D, D, kThreads>(sV, vb + (int64_t)c0 * vs.s, vs.s, BKV, nv);
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
        const int row = q0 + r, col = c0 + c;
        // a key past S gets p = exp(-inf) = 0 against any running max
        sS[r * SP + c] =
            (row < S && col < S)
                ? __fadd_rn(__fmul_rn(s[i][j], scale),
                            to_float(bb[(int64_t)row * S + col]))
                : -INFINITY;
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
    for (int i = 0; i < OR; ++i) {
      const float a = sA[oy + TR * i];
#pragma unroll
      for (int j = 0; j < OC; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[OR], vv[OC];
#pragma unroll
      for (int i = 0; i < OR; ++i) p[i] = sS[(oy + TR * i) * SP + c];
#pragma unroll
      for (int j = 0; j < OC; ++j) vv[j] = sV[c * D + ox + TC * j];
#pragma unroll
      for (int i = 0; i < OR; ++i)
#pragma unroll
        for (int j = 0; j < OC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  const int64_t o_s = (int64_t)N * D;
#pragma unroll
  for (int i = 0; i < OR; ++i) {
    const int r = oy + TR * i, row = q0 + r;
    if (row < S) {
      const float l = fmaxf(sL[r], 1e-30f);
      T* orow = o + ((int64_t)g * S + row) * o_s + (int64_t)h * D;
#pragma unroll
      for (int j = 0; j < OC; ++j) store(orow + ox + TC * j, acc[i][j] / l);
    }
  }
}

// ------------------------------------------------------------------------ //
// bf16 on the tensor cores
// ------------------------------------------------------------------------ //
namespace tc {

using dstpu_tc::bf16;
constexpr int NT = BQ / 16 * 32;       // 4 warps, 16 q rows each
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int width() {   // the staged width: D 8 → 16
  return D < 16 ? 16 : D;
}

// the bias tile's byte offset of 16-byte chunk c of row r: rows of BKV
// elements, chunks swizzled by the row like the q/k/v tiles (bf16 rows
// are 8 chunks: c ^ (r & 7); fp32 rows 16: c ^ ((r & 7) << 1), so that a
// half-warp's 8-byte reads of one n8 column block hit distinct banks)
template <typename TB>
__device__ __forceinline__ uint32_t bias_off(int r, int c) {
  constexpr int CPR = BKV * (int)sizeof(TB) / 16;
  constexpr int SH = CPR / 8 - 1;      // 0 for bf16, 1 for fp32
  return static_cast<uint32_t>(r * (BKV * (int)sizeof(TB)) +
                               ((c ^ ((r & 7) << SH)) << 4));
}

template <typename TB, int D>
constexpr int smem_bytes() {
  return (BQ + 4 * BKV) * width<D>() * 2 + 2 * BQ * BKV * (int)sizeof(TB);
}

// ROWS x D bf16 at src (row r at src + r * stride) into a swizzled tile of
// width<D>() columns; rows >= valid and the columns past D are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          int64_t stride, int valid) {
  constexpr int DP = width<D>(), CH = DP / 8;
#pragma unroll
  for (int k = 0; k < ROWS * CH / NT; ++k) {
    const int i = threadIdx.x + k * NT, r = i / CH, c = i % CH;
    const bool ok = r < valid && c < D / 8;
    dstpu_tc::cp_async16(dst + dstpu_tc::swz<DP>(r, c),
                         src + (ok ? r * stride + c * 8 : 0), ok);
  }
}

// the BQ x BKV bias tile at src (row r at src + r * S), rows >= rows_valid
// and columns >= cols_valid zero-filled: 16-byte cp.async where every row
// starts 16-byte aligned (vec), else element by element
template <typename TB>
__device__ __forceinline__ void load_bias(unsigned char* base, uint32_t dst,
                                          const TB* src, int S,
                                          int rows_valid, int cols_valid,
                                          bool vec) {
  constexpr int EPC = 16 / (int)sizeof(TB), CPR = BKV / EPC;
  if (vec) {
#pragma unroll
    for (int k = 0; k < BQ * CPR / NT; ++k) {
      const int i = threadIdx.x + k * NT, r = i / CPR, c = i % CPR;
      const bool ok = r < rows_valid && c * EPC < cols_valid;
      dstpu_tc::cp_async16(dst + bias_off<TB>(r, c),
                           src + (ok ? (int64_t)r * S + c * EPC : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < BQ * BKV; i += NT) {
      const int r = i / BKV, col = i % BKV;
      const TB x = (r < rows_valid && col < cols_valid)
                       ? src[(int64_t)r * S + col]
                       : TB(0.0f);
      *reinterpret_cast<TB*>(base + bias_off<TB>(r, col / EPC) +
                             (col % EPC) * sizeof(TB)) = x;
    }
  }
}

// the bias at (r, col), (r, col + 1) of a tile (col even)
__device__ __forceinline__ float2 bias_pair(const unsigned char* tile, int r,
                                            int col, const bf16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      tile + bias_off<bf16>(r, col >> 3) + (col & 7) * 2));
}
__device__ __forceinline__ float2 bias_pair(const unsigned char* tile, int r,
                                            int col, const float*) {
  return *reinterpret_cast<const float2*>(
      tile + bias_off<float>(r, col >> 2) + (col & 3) * 4);
}

template <typename TB, int D>
__global__ void __launch_bounds__(NT, 1)
evoformer_fwd_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const TB* __restrict__ bias, bf16* __restrict__ o,
                         int S, int N, int Gb, Strides qs, Strides ks,
                         Strides vs, float scale, int bias_vec) {
  using namespace dstpu_tc;
  constexpr int DP = width<D>(), KD = DP / 16, NB = BKV / 8, DB = DP / 8;
  constexpr uint32_t kKV = BKV * DP * 2, kBias = BQ * BKV * sizeof(TB);
  extern __shared__ __align__(128) unsigned char evo_smem[];
  const uint32_t base = smem_u32(evo_smem);
  const uint32_t oK = BQ * DP * 2, oV = oK + 2 * kKV, oB = oV + 2 * kKV;

  const int bn = blockIdx.x, gi = bn / N, h = bn % N;
  const int q0 = blockIdx.y * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rw = 16 * warp + gq;       // this lane's tile rows rw, rw + 8
  const Lanes ln(lane);
  const int qv = min(BQ, S - q0);
  const TB* bb = bias + ((int64_t)(Gb == 1 ? h : bn) * S + q0) * S;
  const bf16* kb = k + gi * ks.b + h * ks.h;
  const bf16* vb = v + gi * vs.b + h * vs.h;

  load_rows<D, BQ>(base, q + gi * qs.b + (int64_t)q0 * qs.s + h * qs.h, qs.s,
                   qv);
  load_rows<D, BKV>(base + oK, kb, ks.s, min(BKV, S));
  load_rows<D, BKV>(base + oV, vb, vs.s, min(BKV, S));
  load_bias<TB>(evo_smem + oB, base + oB, bb, S, qv, S, bias_vec);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf};     // running max of rows rw, rw + 8
  float l[2] = {0.f, 0.f};             // this lane's part of the row sums
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[KD][4];
  int stage = 0;
  for (int c0 = 0; c0 < S; c0 += BKV, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();     // tile c0 landed; every warp is done with the other stage
    if (c0 == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm4(qf[kk], base + swz<DP>(16 * warp + ln.a_row, 2 * kk + ln.a_ch));
    }
    const int c1 = c0 + BKV;
    if (c1 < S) {
      const int nv = min(BKV, S - c1);
      load_rows<D, BKV>(base + oK + (stage ^ 1) * kKV,
                        kb + (int64_t)c1 * ks.s, ks.s, nv);
      load_rows<D, BKV>(base + oV + (stage ^ 1) * kKV,
                        vb + (int64_t)c1 * vs.s, vs.s, nv);
      load_bias<TB>(evo_smem + oB + (stage ^ 1) * kBias,
                    base + oB + (stage ^ 1) * kBias, bb + c1, S, qv, S - c1,
                    bias_vec);
    }
    cp_async_commit();
    const uint32_t tK = base + oK + stage * kKV, tV = base + oV + stage * kKV;
    const unsigned char* tB = evo_smem + oB + stage * kBias;

    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NB / 2; ++j2) {
        uint32_t bk[4];
        ldsm4(bk, tK + swz<DP>(16 * j2 + ln.bn_row, 2 * kk + ln.bn_ch));
        mma(s[2 * j2], qf[kk], bk[0], bk[1]);
        mma(s[2 * j2 + 1], qf[kk], bk[2], bk[3]);
      }
    }
    // s * scale + bias, rounded in that order; a key past S gets
    // p = exp(-inf) = 0 against any running max
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 b = bias_pair(tB, rw + 8 * hf, 8 * j + 2 * tq, bias);
        s[j][2 * hf] = __fadd_rn(__fmul_rn(s[j][2 * hf], scale), b.x);
        s[j][2 * hf + 1] = __fadd_rn(__fmul_rn(s[j][2 * hf + 1], scale), b.y);
      }
    }
    if (c1 > S) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + 2 * tq + (e & 1) >= S) s[j][e] = -INFINITY;
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
      const float mn = fmaxf(m[i], mx[i]);
      alpha[i] = exp2_approx((m[i] - mn) * kLog2e);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      acc[j][0] *= alpha[0], acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1], acc[j][3] *= alpha[1];
    }
    // exp(s - m) as 2^((s - m) log2 e): s - m is exact where the two are
    // close, even at the -1e9 of a masked key
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp2_approx((s[j][e] - m[e >> 1]) * kLog2e);
      l[0] += s[j][0] + s[j][1];
      l[1] += s[j][2] + s[j][3];
    }
    // O += P V: P (bf16, registers) is the A fragment, V through .trans
#pragma unroll
    for (int k2 = 0; k2 < BKV / 16; ++k2) {
      uint32_t a[4];
      a_from_c(a, s[2 * k2], s[2 * k2 + 1]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bv[4];
        ldsm4_t(bv, tV + swz<DP>(16 * k2 + ln.bt_row, 2 * dp + ln.bt_ch));
        mma(acc[2 * dp], a, bv[0], bv[1]);
        mma(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();

  // 1 / max(l, 1e-30), rounded to bf16 through the warp's own rows of the
  // q tile (no other warp reads them any more), then 16-byte stores of
  // the D real columns of each row < S
  float f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    f[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < DB; ++j) {
    *reinterpret_cast<uint32_t*>(evo_smem + swz<DP>(rw, j) + 4 * tq) =
        pack_bf16(acc[j][0] * f[0], acc[j][1] * f[0]);
    *reinterpret_cast<uint32_t*>(evo_smem + swz<DP>(rw + 8, j) + 4 * tq) =
        pack_bf16(acc[j][2] * f[1], acc[j][3] * f[1]);
  }
  __syncwarp();
  constexpr int CD = D / 8;            // 16-byte chunks of a stored row
  bf16* ob = o + ((int64_t)gi * S * N + h) * D;
  for (int i = lane; i < 16 * CD; i += 32) {
    const int rr = 16 * warp + i / CD, c = i % CD;
    if (q0 + rr < S)
      *reinterpret_cast<uint4*>(ob + (int64_t)(q0 + rr) * N * D + c * 8) =
          *reinterpret_cast<const uint4*>(evo_smem + swz<DP>(rr, c));
  }
}

}  // namespace tc

template <typename T, typename TB, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, int G, int S, int N, int Gb, Strides qs, Strides ks,
           Strides vs, float scale, cudaStream_t stream) {
  dim3 grid(G * N, (S + BQ - 1) / BQ);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    auto kernel = tc::evoformer_fwd_kernel_mma<TB, D>;
    const int bytes = tc::smem_bytes<TB, D>();
    // opt in above 48 KB once per instantiation (a function static: set
    // once, thread-safe)
    static const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    // 16-byte bias rows: S a multiple of the chunk, the base aligned
    const int vec = S % (16 / (int)sizeof(TB)) == 0 &&
                    reinterpret_cast<uintptr_t>(bias) % 16 == 0;
    kernel<<<grid, tc::NT, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const TB*>(bias),
        static_cast<T*>(o), S, N, Gb, qs, ks, vs, scale, vec);
  } else {
    auto kernel = evoformer_fwd_kernel<T, TB, D>;
    const int bytes = smem_floats<D>() * (int)sizeof(float);
    static const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const TB*>(bias),
        static_cast<T*>(o), S, N, Gb, qs, ks, vs, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename TB>
int by_dim(int D, const void* q, const void* k, const void* v,
           const void* bias, void* o, int G, int S, int N, int Gb,
           Strides qs, Strides ks, Strides vs, float scale, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, TB, 8>(q, k, v, bias, o, G, S, N, Gb, qs, ks, vs, scale, s);
    case 16: return launch<T, TB, 16>(q, k, v, bias, o, G, S, N, Gb, qs, ks, vs, scale, s);
    case 32: return launch<T, TB, 32>(q, k, v, bias, o, G, S, N, Gb, qs, ks, vs, scale, s);
    case 64: return launch<T, TB, 64>(q, k, v, bias, o, G, S, N, Gb, qs, ks, vs, scale, s);
    case 128: return launch<T, TB, 128>(q, k, v, bias, o, G, S, N, Gb, qs, ks, vs, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype / bias_dtype: 0 = float32, 1 = bfloat16; D in {8, 16, 32, 64, 128};
// Gb in {1, G}. Strides are in elements, (g, seq, head) for each of q, k,
// v; the head dim is contiguous and every row starts 16-byte aligned.
// Returns a cudaError_t (0 = launched).
extern "C" int dstpu_evoformer_fwd(const void* q, const void* k,
                                   const void* v, const void* bias, void* o,
                                   int G, int S, int N, int D, int Gb,
                                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                   float scale, int dtype, int bias_dtype,
                                   void* stream) {
  if (G <= 0 || S <= 0 || N <= 0 || (Gb != 1 && Gb != G)) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && bias_dtype == 0)
    return by_dim<float, float>(D, q, k, v, bias, o, G, S, N, Gb, qs, ks, vs, scale, s);
  if (dtype == 0 && bias_dtype == 1)
    return by_dim<float, __nv_bfloat16>(D, q, k, v, bias, o, G, S, N, Gb, qs, ks, vs, scale, s);
  if (dtype == 1 && bias_dtype == 0)
    return by_dim<__nv_bfloat16, float>(D, q, k, v, bias, o, G, S, N, Gb, qs, ks, vs, scale, s);
  if (dtype == 1 && bias_dtype == 1)
    return by_dim<__nv_bfloat16, __nv_bfloat16>(D, q, k, v, bias, o, G, S, N, Gb, qs, ks, vs, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a launch (bytes; dtype / bias_dtype 0 = float32,
// 1 = bfloat16), or -1 outside the kernel's D.
extern "C" int dstpu_evoformer_smem_bytes(int dtype, int bias_dtype, int D) {
  switch (D) {
#define DSTPU_EVO_SMEM(d)                                                   \
  case d:                                                                  \
    return dtype == 0 ? smem_floats<d>() * (int)sizeof(float)              \
           : bias_dtype == 0 ? tc::smem_bytes<float, d>()                  \
                             : tc::smem_bytes<__nv_bfloat16, d>();
    DSTPU_EVO_SMEM(8)
    DSTPU_EVO_SMEM(16)
    DSTPU_EVO_SMEM(32)
    DSTPU_EVO_SMEM(64)
    DSTPU_EVO_SMEM(128)
#undef DSTPU_EVO_SMEM
    default: return -1;
  }
}
