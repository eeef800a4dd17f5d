// Fused Adam / AdamW update over flat fp32 buffers, for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/fused_adam.py `_adam_kernel` (via
// `fused_adam_flat` / `fused_adam_tree`), the Pallas TPU kernel that
// updates param and both moments in one pass. Same function, in the
// arithmetic order of the JAX engine's `FusedAdam.update`
// (deepspeed_tpu/ops/optimizer.py):
//   g' = g + wd * p                         (Adam mode, wd != 0)
//   m  = b1 * m + (1 - b1) * g'
//   v  = b2 * v + (1 - b2) * (g' * g')
//   u  = (m / bc1) / (sqrt(v / bc2) + eps)  (+ wd * p in AdamW mode)
//   p  = p - lr * u
// Every operation is one IEEE-rounded fp32 operation (__fmul_rn etc.: no
// fused multiply-add contraction), so the kernel gives the same bits as the
// plain PyTorch version, which runs the same operations one at a time. The
// scalars (lr, betas, eps, weight decay, the bias corrections) are kernel
// arguments: a schedule's new lr never rebuilds anything.
//
// Optionally the same pass writes the bf16 compute copy of the new p,
// rounded to nearest even exactly as p.to(torch.bfloat16), so the engine
// needs no separate cast pass over the master.
//
// What bounds it on this card: bytes. Per element it reads p, g, m, v and
// writes p, m, v (28 bytes, 30 with the bf16 copy) for ~15 flops.
// Design: the engine keeps master, moments and gradient accumulator as one
// flat buffer each (every parameter a view into them), so one launch covers
// the whole model — the multi-tensor-apply analog that `fused_adam_tree`
// gets by concatenation, with no copy. A grid-stride loop moves four
// elements per thread per step with 16-byte loads and stores; a scalar loop
// takes the tail. It allocates nothing, launches on the caller's stream and
// returns cudaGetLastError() to the wrapper.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;
  int adam_w;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v,
                                         const Hyper& h) {
  if (!h.adam_w && h.wd != 0.f) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  float u = __fdiv_rn(__fdiv_rn(m, h.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  if (h.adam_w && h.wd != 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
}

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                  float* __restrict__ m, float* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int64_t n, Hyper h) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t n4 = n / 4;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    float4 pp = reinterpret_cast<float4*>(p)[i];
    const float4 gg = reinterpret_cast<const float4*>(g)[i];
    float4 mm = reinterpret_cast<float4*>(m)[i];
    float4 vv = reinterpret_cast<float4*>(v)[i];
    adam_one(pp.x, gg.x, mm.x, vv.x, h);
    adam_one(pp.y, gg.y, mm.y, vv.y, h);
    adam_one(pp.z, gg.z, mm.z, vv.z, h);
    adam_one(pp.w, gg.w, mm.w, vv.w, h);
    reinterpret_cast<float4*>(p)[i] = pp;
    reinterpret_cast<float4*>(m)[i] = mm;
    reinterpret_cast<float4*>(v)[i] = vv;
    if (out != nullptr) {
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + 4 * i);
      o2[0] = __floats2bfloat162_rn(pp.x, pp.y);
      o2[1] = __floats2bfloat162_rn(pp.z, pp.w);
    }
  }
  for (int64_t i = 4 * n4 + (int64_t)blockIdx.x * kThreads + threadIdx.x;
       i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_one(pp, g[i], mm, vv, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
    if (out != nullptr) out[i] = __float2bfloat16(pp);
  }
}

}  // namespace

// p, g, m, v: [n] float32, 16-byte aligned; out: [n] bfloat16 (8-byte
// aligned) or null. one_minus_b1/b2 are computed by the caller in double
// and rounded once, as the JAX engine's Python-float (1 - b) is. Returns a
// cudaError_t (0 = launched).
extern "C" int dstpu_fused_adam(void* p, const void* g, void* m, void* v,
                                void* out, int64_t n, float lr, float b1,
                                float one_minus_b1, float b2,
                                float one_minus_b2, float eps, float wd,
                                float bc1, float bc2, int adam_w,
                                void* stream) {
  if (n <= 0) return 0;
  const Hyper h{lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, bc1, bc2,
                adam_w};
  int64_t blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_adam_kernel<<<(int)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<__nv_bfloat16*>(out), n, h);
  return (int)cudaGetLastError();
}
