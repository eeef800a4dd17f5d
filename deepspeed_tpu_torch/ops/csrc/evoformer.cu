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
// Inputs q/k/v bf16 or fp32, bias bf16 or fp32 in its own dtype, all
// arithmetic fp32, the output in q's dtype. The backward is not a kernel in
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
// (g, n) reads its S x S bias once (4 S^2 bytes in fp32) and does 4 S^2 D
// flops: D flops a bias byte, far below the H100's ridge (~295 bf16 ops a
// byte). OpenFold's triangle attention (G 256, S 256, N 4, D 32, a per-row
// fp32 bias) moves 268 MB for 8.6 GFLOP. The design reads the bias once,
// coalesced (16 neighbouring threads on 16 neighbouring elements of a bias
// row), and keeps the S x S scores out of device memory; the products run
// on the fp32 CUDA cores, as the port's flash kernels do.
//
// Design: one block of 256 threads per (flat head, 64-row q tile), a loop
// over 64-key tiles inside it (the Pallas grid's sequential kv axis). q, K
// and V tiles are staged in shared memory as fp32 (K rows padded by one
// float: conflict-free column reads). Scores: 16 x 16 threads, each a 4 x 4
// register tile; the online softmax: one warp per row; P V: the D columns
// spread over min(16, D) threads and the 64 rows over the rest, so D = 8
// uses all 256 threads too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

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

template <typename T, typename TB, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, int G, int S, int N, int Gb, Strides qs, Strides ks,
           Strides vs, float scale, cudaStream_t stream) {
  auto kernel = evoformer_fwd_kernel<T, TB, D>;
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  // opt in above 48 KB once per instantiation (a function static: set
  // once, thread-safe)
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(G * N, (S + BQ - 1) / BQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TB*>(bias),
      static_cast<T*>(o), S, N, Gb, qs, ks, vs, scale);
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
