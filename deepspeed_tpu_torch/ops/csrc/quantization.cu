// Blockwise symmetric int8 quantization and the fused dequantize-and-reduce
// of the ZeRO++ int8 wire (qgZ gradients, qwZ weights), for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/quantization.py
//   * `_quant_kernel` via `quantize_int8_blocks` — per block of `block`
//     elements: amax = max |x|, scale = amax / 127 (1 where amax = 0),
//     q = clip(round-half-even(x / scale), -127, 127) as int8;
//   * `_dequant_reduce_kernel` via `dequant_reduce` — out = sum over w of
//     q[w] * scale[w] in fp32, in w order, / W when `mean`.
// Every fp32 operation is one IEEE-rounded operation (__fdiv_rn, __fmul_rn,
// __fadd_rn: no reciprocal multiply, no fused multiply-add contraction),
// and rintf rounds half to even, so both kernels give the bits of their
// plain PyTorch versions (ops/quant_kernels.py) at every shape.
//
// Non-finite blocks: the amax is a max that propagates NaN (fmaxf drops
// it). An amax of inf gives scale inf and q = 0 (x / inf = 0, inf / inf =
// NaN → 0), as in the JAX package. An amax of NaN gives a NaN scale, so the
// block dequantizes to NaN and reaches the global norm (the JAX quantizer
// gives scale 1 there and loses the NaN: a fault of the reference that the
// port fixes). A NaN quotient gives q = 0, as XLA's int8 convert does.
//
// What bounds them on this card: bytes. quantize reads x once (4 or 2
// bytes an element) and writes q (1 byte) and one fp32 scale per block;
// dequant_reduce reads W int8 rows and their scales and writes fp32 [C].
// Design: quantize runs one 256-thread block per quantization block, four
// elements a thread per step with 16-byte (fp32) or 8-byte (bf16) loads;
// the amax is a warp-shuffle max, then a shared-memory max over the 8
// warps; the second pass over the block re-reads it from L1/L2, not from
// device memory. dequant_reduce is a grid-stride loop of four columns a
// thread (4-byte int8 loads per row, one float4 store). A row width or
// block that is no multiple of 4, or an unaligned buffer, takes the scalar
// variant. Neither kernel allocates; both launch on the caller's stream and
// return cudaGetLastError() to the wrapper.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ signed char quant_one(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  if (r != r) return 0;
  return (signed char)(int)fminf(fmaxf(r, -127.f), 127.f);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, signed char* __restrict__ q,
             float* __restrict__ scales, int block) {
  const int64_t base = (int64_t)blockIdx.x * block;
  const T* xb = x + base;
  signed char* qb = q + base;
  float amax = 0.f;
  if (kVec) {
    for (int i = 4 * threadIdx.x; i < block; i += 4 * kThreads) {
      float v[4];
      load4(xb + i, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) amax = nan_max(amax, fabsf(v[j]));
    }
  } else {
    for (int i = threadIdx.x; i < block; i += kThreads)
      amax = nan_max(amax, fabsf(to_float(xb[i])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[kThreads / 32];
  __shared__ float block_scale;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = nan_max(m, warp_max[w]);
    const float scale = (m != m) ? m : (m > 0.f ? __fdiv_rn(m, 127.f) : 1.f);
    block_scale = scale;
    scales[blockIdx.x] = scale;
  }
  __syncthreads();
  const float scale = block_scale;
  if (kVec) {
    for (int i = 4 * threadIdx.x; i < block; i += 4 * kThreads) {
      float v[4];
      load4(xb + i, v);
      char4 o;
      o.x = quant_one(v[0], scale);
      o.y = quant_one(v[1], scale);
      o.z = quant_one(v[2], scale);
      o.w = quant_one(v[3], scale);
      *reinterpret_cast<char4*>(qb + i) = o;
    }
  } else {
    for (int i = threadIdx.x; i < block; i += kThreads)
      qb[i] = quant_one(to_float(xb[i]), scale);
  }
}

__global__ void __launch_bounds__(kThreads)
dequant_reduce_kernel(const signed char* __restrict__ q,
                      const float* __restrict__ scales,
                      float* __restrict__ out, int world, int64_t chunk,
                      int block, int mean, int vec) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t n_blocks = chunk / block;
  const float w_f = (float)world;
  const int64_t n4 = vec ? chunk / 4 : 0;
  for (int64_t i4 = (int64_t)blockIdx.x * kThreads + threadIdx.x; i4 < n4;
       i4 += stride) {
    const int64_t i = 4 * i4, b = i / block;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int w = 0; w < world; ++w) {
      const char4 v = reinterpret_cast<const char4*>(q + w * chunk)[i4];
      const float s = scales[w * n_blocks + b];
      a0 = __fadd_rn(a0, __fmul_rn((float)v.x, s));
      a1 = __fadd_rn(a1, __fmul_rn((float)v.y, s));
      a2 = __fadd_rn(a2, __fmul_rn((float)v.z, s));
      a3 = __fadd_rn(a3, __fmul_rn((float)v.w, s));
    }
    if (mean) {
      a0 = __fdiv_rn(a0, w_f);
      a1 = __fdiv_rn(a1, w_f);
      a2 = __fdiv_rn(a2, w_f);
      a3 = __fdiv_rn(a3, w_f);
    }
    reinterpret_cast<float4*>(out)[i4] = make_float4(a0, a1, a2, a3);
  }
  for (int64_t i = 4 * n4 + (int64_t)blockIdx.x * kThreads + threadIdx.x;
       i < chunk; i += stride) {
    const int64_t b = i / block;
    float a = 0.f;
    for (int w = 0; w < world; ++w)
      a = __fadd_rn(a, __fmul_rn((float)q[w * chunk + i],
                                 scales[w * n_blocks + b]));
    out[i] = mean ? __fdiv_rn(a, w_f) : a;
  }
}

template <typename T>
int launch_quant(const void* x, void* q, void* s, int64_t n, int block,
                 int vec, cudaStream_t stream) {
  const int64_t grid = n / block;
  const T* xp = static_cast<const T*>(x);
  signed char* qp = static_cast<signed char*>(q);
  float* sp = static_cast<float*>(s);
  if (vec)
    quant_kernel<T, true><<<(unsigned)grid, kThreads, 0, stream>>>(xp, qp, sp,
                                                                   block);
  else
    quant_kernel<T, false><<<(unsigned)grid, kThreads, 0, stream>>>(xp, qp,
                                                                    sp, block);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n] float32 (dtype 0) or bfloat16 (dtype 1), n % block == 0,
// n / block < 2^31; q: [n] int8; scales: [n / block] float32. vec = 1
// (block % 4 == 0, x 16-byte (fp32) or 8-byte (bf16) aligned, q 4-byte
// aligned) takes the vector loads. Returns a cudaError_t (0 = launched).
extern "C" int dstpu_quantize_int8_blocks(const void* x, void* q, void* scales,
                                          int64_t n, int block, int dtype,
                                          int vec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_quant<__nv_bfloat16>(x, q, scales, n, block, vec, st);
  return launch_quant<float>(x, q, scales, n, block, vec, st);
}

// q: [world, chunk] int8; scales: [world, chunk / block] float32; out:
// [chunk] float32. vec = 1 (chunk and block multiples of 4, q 4-byte and
// out 16-byte aligned) takes the vector loop. Returns a cudaError_t
// (0 = launched).
extern "C" int dstpu_dequant_reduce(const void* q, const void* scales,
                                    void* out, int world, int64_t chunk,
                                    int block, int mean, int vec,
                                    void* stream) {
  if (chunk <= 0) return 0;
  int64_t blocks = (chunk / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dequant_reduce_kernel<<<(int)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), world, chunk, block, mean, vec);
  return (int)cudaGetLastError();
}
