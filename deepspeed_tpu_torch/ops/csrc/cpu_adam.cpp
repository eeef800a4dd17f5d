// Host Adam / AdamW for the host-executed optimizer step (SuperOffload,
// ZenFlow's host update): a compiled, multi-threaded pass over flat fp32
// buffers in host memory.
//
// Replaces: the CPU-compiled XLA update of the JAX package
// (deepspeed_tpu/runtime/host_step.py `_build_update`: one jax.jit program
// for the CPU backend that fuses the gas division, the global norm, the
// clip, Adam and the bf16 cast into a few vectorised loops). Two entry
// points, in the step's order:
//
//   dstpu_host_grad_prep  g /= gas_scale in place (true division) and, in
//                         the same pass, the sum of squares of the divided
//                         g for the global norm;
//   dstpu_host_adam       the clip factor, then Adam or AdamW with bias
//                         correction in the arithmetic order of
//                         ops/fused_adam.py `fused_adam_ref` (the JAX
//                         engine's FusedAdam.update); p, m, v in place and
//                         the bf16 copy of the new p (round to nearest
//                         even) into the staging buffer the host-to-device
//                         copy reads.
//
// Numerics: every operation is one IEEE-rounded fp32 operation. The
// library is built with -ffp-contract=off (no fused multiply-add) and
// without -ffast-math; the vector div and sqrt are correctly rounded, so
// vectorising (-march=native: AVX-512 where the host has it) changes no
// bit. The result equals the CUDA kernel's (ops/csrc/fused_adam.cu) bit for
// bit, and the plain PyTorch version's except where PyTorch's CPU sqrt is
// not correctly rounded (one ulp of p).
//
// The norm's sum of squares is taken over a fixed partition of the buffer
// into kNormBlock-element blocks: each block sums its squares in kLanes
// double accumulators (element i of the block into lane i % kLanes, the
// lanes added in order at the end) and writes one fp32 partial; the
// partials are added in block order. So the result does not depend on the
// thread count. Threads take contiguous runs of blocks (prep) or of
// elements (Adam); the thread count is an argument of each call.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kNormBlock = int64_t(1) << 20;
constexpr int kLanes = 16;

inline uint16_t to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return uint16_t((u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return uint16_t(u >> 16);
}

// f(lo, hi) over [0, n) cut into `threads` contiguous runs, the runs
// starting at multiples of `align`; the calling thread takes the first.
template <class F>
void parallel_runs(int64_t n, int threads, int64_t align, F f) {
  if (n <= 0) return;
  int64_t units = (n + align - 1) / align;
  if (threads < 1) threads = 1;
  if (threads > units) threads = int(units);
  std::vector<std::thread> pool;
  int64_t per = units / threads, rem = units % threads, start = 0;
  int64_t first_hi = 0;
  for (int t = 0; t < threads; ++t) {
    int64_t count = per + (t < rem ? 1 : 0);
    int64_t lo = start * align;
    int64_t hi = (start + count) * align;
    if (hi > n) hi = n;
    start += count;
    if (t == 0) {
      first_hi = hi;
      continue;
    }
    pool.emplace_back(f, lo, hi);
  }
  f(int64_t(0), first_hi);
  for (auto& th : pool) th.join();
}

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2, clip;
};

// kMode: 0 no weight decay, 1 L2 into the gradient (Adam), 2 decoupled
// (AdamW)
template <int kMode, bool kClip, bool kOut>
void adam_run(float* __restrict__ p, const float* __restrict__ g,
              float* __restrict__ m, float* __restrict__ v,
              uint16_t* __restrict__ out, int64_t lo, int64_t hi,
              const Hyper h) {
  for (int64_t i = lo; i < hi; ++i) {
    float gg = g[i];
    const float pp = p[i];
    if (kClip) gg = gg * h.clip;
    if (kMode == 1) gg = gg + h.wd * pp;
    const float mm = h.b1 * m[i] + h.omb1 * gg;
    const float vv = h.b2 * v[i] + (gg * gg) * h.omb2;
    float u = (mm / h.bc1) / (std::sqrt(vv / h.bc2) + h.eps);
    if (kMode == 2) u = u + pp * h.wd;
    const float np = pp - u * h.lr;
    m[i] = mm;
    v[i] = vv;
    p[i] = np;
    if (kOut) out[i] = to_bf16(np);
  }
}

using AdamFn = void (*)(float*, const float*, float*, float*, uint16_t*,
                        int64_t, int64_t, const Hyper);

template <int kMode, bool kClip>
AdamFn pick_out(bool has_out) {
  return has_out ? &adam_run<kMode, kClip, true>
                 : &adam_run<kMode, kClip, false>;
}

template <int kMode>
AdamFn pick_clip(bool clip, bool has_out) {
  return clip ? pick_out<kMode, true>(has_out)
              : pick_out<kMode, false>(has_out);
}

}  // namespace

extern "C" {

// g: [n] float32, divided by gas_scale in place. partials: [ceil(n /
// kNormBlock)] float32, each block's sum of squares of the divided g.
// Returns the partials' sum in block order (double).
double dstpu_host_grad_prep(float* g, int64_t n, float gas_scale,
                            float* partials, int threads) {
  if (n <= 0) return 0.0;
  const int64_t n_blocks = (n + kNormBlock - 1) / kNormBlock;
  parallel_runs(n_blocks, threads, 1, [=](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b) {
      const int64_t lo = b * kNormBlock;
      const int64_t hi = lo + kNormBlock < n ? lo + kNormBlock : n;
      double acc[kLanes] = {0.0};
      int64_t i = lo;
      for (; i + kLanes <= hi; i += kLanes) {
        for (int j = 0; j < kLanes; ++j) {
          const float x = g[i + j] / gas_scale;
          g[i + j] = x;
          acc[j] += double(x * x);
        }
      }
      for (int j = 0; i < hi; ++i, ++j) {
        const float x = g[i] / gas_scale;
        g[i] = x;
        acc[j] += double(x * x);
      }
      double s = 0.0;
      for (int j = 0; j < kLanes; ++j) s += acc[j];
      partials[b] = float(s);
    }
  });
  double total = 0.0;
  for (int64_t b = 0; b < n_blocks; ++b) total += double(partials[b]);
  return total;
}

int64_t dstpu_host_norm_block() { return kNormBlock; }

// p, g, m, v: [n] float32 (g read only); out: [n] bfloat16 bits or null.
// use_clip: g is multiplied by clip first. one_minus_b1/b2 are computed by
// the caller in double and rounded once, as the JAX engine's Python-float
// (1 - b) is. Returns 0.
int dstpu_host_adam(float* p, const float* g, float* m, float* v,
                    uint16_t* out, int64_t n, float lr, float b1,
                    float one_minus_b1, float b2, float one_minus_b2,
                    float eps, float wd, float bc1, float bc2, int adam_w,
                    float clip, int use_clip, int threads) {
  if (n <= 0) return 0;
  const Hyper h{lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, bc1, bc2,
                clip};
  const int mode = wd == 0.f ? 0 : (adam_w ? 2 : 1);
  const bool has_out = out != nullptr, c = use_clip != 0;
  AdamFn fn = mode == 0   ? pick_clip<0>(c, has_out)
              : mode == 1 ? pick_clip<1>(c, has_out)
                          : pick_clip<2>(c, has_out);
  parallel_runs(n, threads, 64, [=](int64_t lo, int64_t hi) {
    fn(p, g, m, v, out, lo, hi, h);
  });
  return 0;
}

}  // extern "C"
