// Paged attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/paged_attention.py `_kernel` (via
// `paged_attention`), the Pallas TPU kernel that FastGen's tick runs per
// layer. Same function: token t's rep = N/K query heads of kv head k attend
// to the first lengths[t] cache slots of its sequence, found through
// tables[t, :] in the pool [NB, bs, K, D]; scale 1/sqrt(D); fp32 scores,
// online softmax and accumulation; slots at index >= lengths[t] masked; a
// row of length 0 gives 0 (the TPU kernel's `l_safe`); output in q's dtype.
//
// What bounds it on this card: bytes. Each (token, kv head) reads
// ceil(len/32)*32 slots of K and V once ([D] each) and does 4*rep*D flops
// per slot; at rep <= 8 that is at most 8 flops a byte, far below the
// flops-per-byte ratio at which the H100's compute, not HBM, would limit.
//
// Design, and what it does about that bound (a simple first version):
// * grid (T, K): one 128-thread block per token and kv head; blocks run in
//   any order, so nothing carries across them (the TPU kernel's sequential
//   grid axis over blocks becomes the loop over tiles inside the block);
// * the block reads its own table entries and walks the context in tiles of
//   32 slots; a slot row is D contiguous elements, staged into shared
//   memory with 16-byte vector loads, neighbouring threads on neighbouring
//   addresses (coalesced), converted to fp32 once;
// * the rep query rows are loaded once and kept in shared memory, so GQA
//   reads each K/V tile once for all rep heads;
// * scores: one thread per (row, slot) dot product over a padded K tile
//   (row stride D+1, no bank conflicts); softmax: one warp per row with
//   shuffles; P·V: thread d keeps the fp32 accumulators of column d for its
//   rows in registers;
// * it allocates nothing, launches on the caller's stream and returns
//   cudaGetLastError() to the wrapper.
// Known weakness: prefill rows of one prompt each walk the same blocks, so
// a C-row chunk reads that prompt's KV C times (mostly from L2). Grouping
// such rows is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;     // cache slots per tile; == warp size (softmax)
constexpr int kMaxRep = 8;    // query heads per kv head
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kElems = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as astype does
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                       const T* __restrict__ vpool,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int N, int K, int bs, int MB, float scale) {
  constexpr int kGroups = kThreads / D;           // row groups in P·V (1, 2)
  constexpr int kRowsPerThread = kMaxRep / kGroups;
  constexpr int kElems = Vec16<T>::kElems;
  constexpr int kVecs = D / kElems;               // 16-byte vectors per slot

  __shared__ float qs[kMaxRep][D];
  __shared__ float ks[kTile][D + 1];              // +1: conflict-free dots
  __shared__ float vs[kTile][D];
  __shared__ float ps[kMaxRep][kTile];
  __shared__ float m_s[kMaxRep], l_s[kMaxRep], alpha_s[kMaxRep];

  const int t = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rep = N / K;
  const int len = min(lengths[t], MB * bs);
  const int* table = tables + (size_t)t * MB;
  const size_t slot_stride = (size_t)K * D;       // elements between slots

  // the rep query heads of kv head kh are rows kh*rep .. kh*rep+rep-1
  const T* qrow = q + ((size_t)t * N + (size_t)kh * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) {
    qs[i / D][i % D] = to_float(qrow[i]);
  }
  if (tid < kMaxRep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int g = tid / D, d = tid % D;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < len; c0 += kTile) {
    // stage the K and V rows of slots c0 .. c0+kTile-1 (zeros past len, so
    // a masked slot's p = 0 never meets a NaN left in shared memory)
    for (int i = tid; i < kTile * kVecs; i += kThreads) {
      const int c = i / kVecs, v = i % kVecs, slot = c0 + c;
      float kf[kElems], vf[kElems];
      if (slot < len) {
        const size_t blk = (size_t)table[slot / bs];
        const size_t off = (blk * bs + slot % bs) * slot_stride
                           + (size_t)kh * D + (size_t)v * kElems;
        Vec16<T>::load(kpool + off, kf);
        Vec16<T>::load(vpool + off, vf);
      } else {
#pragma unroll
        for (int e = 0; e < kElems; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        ks[c][v * kElems + e] = kf[e];
        vs[c][v * kElems + e] = vf[e];
      }
    }
    __syncthreads();

    for (int p = tid; p < rep * kTile; p += kThreads) {
      const int r = p / kTile, c = p % kTile;
      float s = 0.f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) s = fmaf(qs[r][e], ks[c][e], s);
      ps[r][c] = (c0 + c < len) ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w+4; lane = slot in the tile
    for (int r = warp; r < rep; r += kThreads / 32) {
      const float m_prev = m_s[r];
      const float s = ps[r][lane];
      float mt = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      }
      const float m_new = fmaxf(m_prev, mt);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      ps[r][lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = g + i * kGroups;
      if (r < rep) {
        float a = acc[i] * alpha_s[r];
#pragma unroll 8
        for (int c = 0; c < kTile; ++c) a = fmaf(ps[r][c], vs[c][d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = g + i * kGroups;
    if (r < rep) {
      const float l = l_s[r];
      const float l_safe = (l == 0.f) ? 1.f : l;
      store(out + ((size_t)t * N + (size_t)kh * rep + r) * D + d,
            acc[i] / l_safe);
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* kpool, const void* vpool,
            const void* tables, const void* lengths, void* out, int T_,
            int N, int K, int bs, int MB, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  paged_attention_kernel<T, D><<<dim3(T_, K), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), N, K, bs, MB,
      scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Shapes: q/out [T, N, D], pools
// [NB, bs, K, D] (contiguous, 16-byte aligned), tables [T, MB] int32,
// lengths [T] int32. Returns a cudaError_t (0 = launched).
extern "C" int dstpu_paged_attention(const void* q, const void* kpool,
                                     const void* vpool, const void* tables,
                                     const void* lengths, void* out, int T,
                                     int N, int K, int D, int bs, int MB,
                                     int dtype, void* stream) {
  if (T <= 0) return 0;
  if (K <= 0 || N % K != 0 || N / K > kMaxRep || bs <= 0 || MB <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) {
    launch<float, 64>(q, kpool, vpool, tables, lengths, out, T, N, K, bs, MB, s);
  } else if (dtype == 0 && D == 128) {
    launch<float, 128>(q, kpool, vpool, tables, lengths, out, T, N, K, bs, MB, s);
  } else if (dtype == 1 && D == 64) {
    launch<__nv_bfloat16, 64>(q, kpool, vpool, tables, lengths, out, T, N, K,
                              bs, MB, s);
  } else if (dtype == 1 && D == 128) {
    launch<__nv_bfloat16, 128>(q, kpool, vpool, tables, lengths, out, T, N, K,
                               bs, MB, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
