// Device helpers shared by the attention kernels (flash_attention.cu,
// evoformer.cu): 16-byte vector loads of bf16/fp32 rows into fp32, rounding
// stores, and the strided tile load into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstpu_attn {

constexpr float kNegInf = -1e30f;      // the TPU kernels' NEG_INF

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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as .to(bfloat16)
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// rows x D tile at src (row r at src + r * row_stride, D contiguous) into
// shared memory with row pitch P floats; rows >= valid are zero-filled.
// Every thread of the block (kThreads of them) takes part.
template <typename T, int D, int P, int kThreads>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int rows,
                                          int valid) {
  constexpr int kE = Vec16<T>::kElems;
  constexpr int kV = D / kE;
  static_assert(D % kE == 0, "a row must be whole 16-byte vectors");
  for (int i = threadIdx.x; i < rows * kV; i += kThreads) {
    const int r = i / kV, c = (i % kV) * kE;
    float f[kE];
    if (r < valid) {
      Vec16<T>::load(src + (int64_t)r * row_stride + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) dst[r * P + c + e] = f[e];
  }
}

struct Strides {        // elements; the head dim is contiguous
  int64_t b, s, h;
};

}  // namespace dstpu_attn
