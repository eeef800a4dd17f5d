// Grouped GEMM for the dropless MoE FFN, for Hopper (sm_90a): gmm (forward),
// gmm with the rhs transposed (dgrad) and tgmm (wgrad).
//
// Replaces: the megablox kernels the JAX package's MoE runs on
// (deepspeed_tpu/moe/layer.py:136 `grouped_dot` -> megablox `gmm`, and the
// custom VJP's `gmm(..., transpose_rhs)` / `tgmm` in
// jax/experimental/pallas/ops/tpu/megablox/ops.py). Rows of the lhs are
// sorted by expert; group e owns the contiguous rows
// [off_e, off_e + group_sizes[e]), off_e the exclusive prefix sum.
//   gmm:   out[rows of e] = lhs[rows of e] @ rhs[e]      lhs [M,K], rhs [E,K,N]
//   gmmT:  out[rows of e] = lhs[rows of e] @ rhs[e]^T    lhs [M,K], rhs [E,N,K]
//   tgmm:  out[e] = lhs[rows of e]^T @ grad[rows of e]   lhs [M,K], grad [M,N]
//          -> out [E,K,N]; an empty group gives zeros.
// gmm/gmmT write zeros on the rows past sum(group_sizes) (lax.ragged_dot's
// semantics; megablox leaves them undefined). Sums are fp32; the output is
// rounded once to the inputs' dtype.
//
// What bounds it on this card: operations. At moe_350m's up projection
// (M 32768, K 768, N 3072) a call is 1.55e11 flops against 0.27 GB of
// traffic: 0.156 ms at 989 TF/s, 0.08 ms at 3.35 TB/s.
//
// Design. Megablox builds a tile-to-group schedule on the host side of the
// TPU program (`make_group_metadata`); here there is no host step: the grid
// is an upper bound of ceil(M/128) + E row tiles (a group boundary inside a
// tile adds one tile, the rows past the last group one more), and each block
// walks group_sizes (E int32 on the device) to find its (group, row tile) or
// exits. No host sync, no schedule kernel. A block computes a 128 x 128
// output tile from a two-stage cp.async ring of shared-memory tiles; rows of
// another group (and rows past M, columns past K or N) are zero-filled by
// cp.async's src-size operand, never read, and never written. bf16 runs on
// the tensor cores through WMMA (16x16x16, fp32 accumulators; 8 warps, each
// 64 x 32); fp32 runs exact fp32 fused multiply-adds on the CUDA cores (no
// TF32; 256 threads, each 8 x 8). The transposed operands (gmmT's rhs, tgmm's
// lhs) are staged as they lie in memory and read by col_major fragments, so
// every global load is a 16-byte vector along a contiguous row. tgmm gives
// each block one (group, 128 x 128 tile of out[e]) and loops over the
// group's rows: no atomics, so the weight gradient is deterministic.
// Launches go on the caller's stream; nothing is allocated; the C entry
// points return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int BM = 128;     // output rows of a tile (tgmm: rows of out[e])
constexpr int BN = 128;     // output columns of a tile
enum Mode { kGmm = 0, kGmmT = 1, kTgmm = 2 };

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int BK = 32, PAD = 8;   // PAD: 16 bytes, keeps rows aligned
};
template <>
struct Tile<float> {
  static constexpr int BK = 16, PAD = 4;
};

// Shared-memory layout of one pipeline stage. A is the [rows x contraction]
// operand, B the [contraction x columns] one; a *_COL operand is staged
// transposed (contraction-major for A, column-major for B), as it lies in
// device memory.
template <typename T, int MODE>
struct Layout {
  static constexpr int BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  static constexpr bool A_COL = MODE == kTgmm;    // staged [BK][BM]
  static constexpr bool B_COL = MODE == kGmmT;    // staged [BN][BK]
  static constexpr int LDA = A_COL ? BM + PAD : BK + PAD;
  static constexpr int LDB = B_COL ? BK + PAD : BN + PAD;
  static constexpr int A_ELEMS = A_COL ? BK * LDA : BM * LDA;
  static constexpr int B_ELEMS = B_COL ? BN * LDB : BK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int SMEM_BYTES = 2 * STAGE * (int)sizeof(T);
};

__device__ __forceinline__ int64_t clamp_hi(int64_t v, int hi) {
  return v < hi ? v : (int64_t)hi;
}

__device__ __forceinline__ int64_t size_of(const int* group_sizes, int e) {
  const int s = group_sizes[e];
  return s > 0 ? s : 0;     // a negative size counts as empty
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;     // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows r0 .. r0+R-1, columns c0 .. c0+C-1 of the row-major matrix g
// (leading dimension ld) into s[r * LDS + c]. A 16-byte chunk whose row lies
// outside [rlo, rhi) or whose first column is >= chi is zero-filled and not
// read (the caller keeps chi a multiple of the chunk).
template <typename T, int R, int C, int LDS>
__device__ __forceinline__ void load_tile(T* s, const T* g, int64_t ld,
                                          int r0, int rlo, int rhi, int c0,
                                          int chi) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CPR = C / VEC;
  for (int i = threadIdx.x; i < R * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    const int gr = r0 + r, gc = c0 + c;
    const bool ok = gr >= rlo && gr < rhi && gc < chi;
    cp_async16(s + r * LDS + c, ok ? g + gr * ld + gc : g, ok);
  }
}

template <typename T>
struct Args {
  const T* lhs;
  const T* rhs;            // gmm: [E,K,N]; gmmT: [E,N,K]; tgmm: grad [M,N]
  T* out;
  const int* group_sizes;  // [E] int32
  int M, K, N, E;
};

// This block's piece of work.
struct Work {
  int e;          // group
  int gs, ge;     // the group's rows [gs, ge), clamped to M
  int row0, n0;   // the output tile's first row and column
  int rlo, rhi;   // output rows this block may write
  int nk;         // contraction steps
  int64_t out_off;
};

// One pipeline stage: the A and B tiles of contraction step kt.
template <typename T, int MODE>
__device__ __forceinline__ void load_stage(T* st, const Args<T>& a,
                                           const Work& w, int kt) {
  using L = Layout<T, MODE>;
  T* As = st;
  T* Bs = st + L::A_ELEMS;
  if constexpr (MODE == kTgmm) {
    const int m0 = w.gs + kt * L::BK;        // the step's rows of the group
    load_tile<T, L::BK, BM, L::LDA>(As, a.lhs, a.K, m0, w.gs, w.ge, w.row0,
                                    a.K);
    load_tile<T, L::BK, BN, L::LDB>(Bs, a.rhs, a.N, m0, w.gs, w.ge, w.n0,
                                    a.N);
  } else {
    const int k0 = kt * L::BK;
    load_tile<T, BM, L::BK, L::LDA>(As, a.lhs, a.K, w.row0, w.gs, w.ge, k0,
                                    a.K);
    const T* rhs = a.rhs + (int64_t)w.e * a.K * a.N;
    if constexpr (MODE == kGmm)
      load_tile<T, L::BK, BN, L::LDB>(Bs, rhs, a.N, k0, 0, a.K, w.n0, a.N);
    else
      load_tile<T, BN, L::BK, L::LDB>(Bs, rhs, a.K, w.n0, 0, a.N, k0, a.K);
  }
}

// bf16: tensor cores through WMMA; warp (wm, wn) of a 2 x 4 grid owns the
// 64 x 32 sub-tile at (wm * 64, wn * 32).
template <int MODE>
__device__ __forceinline__ void mainloop_store(unsigned char* smem,
                                               const Args<__nv_bfloat16>& a,
                                               const Work& w) {
  using T = __nv_bfloat16;
  using L = Layout<T, MODE>;
  using ALay = std::conditional_t<L::A_COL, wmma::col_major, wmma::row_major>;
  using BLay = std::conditional_t<L::B_COL, wmma::col_major, wmma::row_major>;
  T* stages = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (w.nk > 0) load_stage<T, MODE>(stages, a, w, 0);
  cp_async_commit();
  for (int kt = 0; kt < w.nk; ++kt) {
    if (kt + 1 < w.nk)
      load_stage<T, MODE>(stages + ((kt + 1) & 1) * L::STAGE, a, w, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* As = stages + (kt & 1) * L::STAGE;
    const T* Bs = As + L::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < L::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, ALay> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLay> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16;
        wmma::load_matrix_sync(
            fa[i], L::A_COL ? As + kk * L::LDA + r : As + r * L::LDA + kk,
            L::LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + j * 16;
        wmma::load_matrix_sync(
            fb[j], L::B_COL ? Bs + c * L::LDB + kk : Bs + kk * L::LDB + c,
            L::LDB);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: each fragment through a per-warp 16 x 16 fp32 scratch (the
  // staging buffers, free now); a lane rounds 8 values of one row to bf16
  // and writes them as one 16-byte store
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int grow = w.row0 + wm * 64 + i * 16 + r;
      const int gcol = w.n0 + wn * 32 + j * 16 + c;
      if (grow >= w.rlo && grow < w.rhi && gcol < a.N) {
        const float* v = scratch + r * 16 + c;
        __align__(16) __nv_bfloat162 o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          o[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
        *reinterpret_cast<uint4*>(a.out + w.out_off + (int64_t)grow * a.N +
                                  gcol) = *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
  }
}

// fp32: exact fp32 FMAs on the CUDA cores; thread (ty, tx) of a 16 x 16 grid
// owns rows ty + 16 i and columns tx + 16 j (i, j < 8).
template <int MODE>
__device__ __forceinline__ void mainloop_store(unsigned char* smem,
                                               const Args<float>& a,
                                               const Work& w) {
  using T = float;
  using L = Layout<T, MODE>;
  T* stages = reinterpret_cast<T*>(smem);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if (w.nk > 0) load_stage<T, MODE>(stages, a, w, 0);
  cp_async_commit();
  for (int kt = 0; kt < w.nk; ++kt) {
    if (kt + 1 < w.nk)
      load_stage<T, MODE>(stages + ((kt + 1) & 1) * L::STAGE, a, w, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* As = stages + (kt & 1) * L::STAGE;
    const T* Bs = As + L::A_ELEMS;
#pragma unroll
    for (int k = 0; k < L::BK; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 16 * i;
        av[i] = L::A_COL ? As[k * L::LDA + r] : As[r * L::LDA + k];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        bv[j] = L::B_COL ? Bs[c * L::LDB + k] : Bs[k * L::LDB + c];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int grow = w.row0 + ty + 16 * i;
    if (grow < w.rlo || grow >= w.rhi) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gcol = w.n0 + tx + 16 * j;
      if (gcol < a.N) a.out[w.out_off + (int64_t)grow * a.N + gcol] = acc[i][j];
    }
  }
}

template <typename T>
__device__ void write_zeros(const Args<T>& a, int64_t out_off, int row0,
                            int rlo, int rhi, int n0) {
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int grow = row0 + i / BN, gcol = n0 + i % BN;
    if (grow >= rlo && grow < rhi && gcol < a.N)
      a.out[out_off + (int64_t)grow * a.N + gcol] = T(0.0f);
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const Args<T> a) {
  constexpr int SMEM = Layout<T, MODE>::SMEM_BYTES > 8 * 256 * 4
                           ? Layout<T, MODE>::SMEM_BYTES
                           : 8 * 256 * 4;
  __shared__ __align__(128) unsigned char smem[SMEM];
  using L = Layout<T, MODE>;
  Work w;
  if constexpr (MODE == kTgmm) {
    // grid (tiles of out[e], E): this block's group is blockIdx.y
    const int tiles_n = (a.N + BN - 1) / BN;
    w.e = blockIdx.y;
    w.row0 = (blockIdx.x / tiles_n) * BM;
    w.n0 = (blockIdx.x % tiles_n) * BN;
    int64_t off = 0;
    for (int e = 0; e < w.e; ++e) off += size_of(a.group_sizes, e);
    w.gs = (int)clamp_hi(off, a.M);
    w.ge = (int)clamp_hi(off + size_of(a.group_sizes, w.e), a.M);
    w.rlo = 0;
    w.rhi = a.K;
    w.nk = (w.ge - w.gs + L::BK - 1) / L::BK;
    w.out_off = (int64_t)w.e * a.K * a.N;
  } else {
    // grid (column tiles, upper bound of row tiles): walk the groups (and
    // the tail past them, e == E) to find this block's (group, row tile)
    const int item = blockIdx.y;
    w.n0 = blockIdx.x * BN;
    int64_t off = 0;
    int seen = 0;
    bool found = false;
    for (int e = 0; e <= a.E && !found; ++e) {
      const int64_t size = e < a.E ? size_of(a.group_sizes, e) : a.M;
      const int start = (int)clamp_hi(off, a.M);
      const int end = (int)clamp_hi(off + size, a.M);
      off += size;
      if (end <= start) continue;
      const int first = start / BM, count = (end - 1) / BM - first + 1;
      if (item < seen + count) {
        w.e = e;
        w.gs = start;
        w.ge = end;
        w.row0 = (first + item - seen) * BM;
        found = true;
      }
      seen += count;
    }
    if (!found) return;
    w.rlo = w.gs;
    w.rhi = w.ge;
    w.out_off = 0;
    if (w.e == a.E) {     // rows past sum(group_sizes): zeros
      write_zeros(a, 0, w.row0, w.rlo, w.rhi, w.n0);
      return;
    }
    w.nk = (a.K + L::BK - 1) / L::BK;
  }
  mainloop_store<MODE>(smem, a, w);
}

template <typename T, int MODE>
int launch(const void* lhs, const void* rhs, const void* group_sizes,
           void* out, int M, int K, int N, int E, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(lhs), static_cast<const T*>(rhs),
                  static_cast<T*>(out), static_cast<const int*>(group_sizes),
                  M, K, N, E};
  dim3 grid;
  if (MODE == kTgmm)
    grid = dim3(((K + BM - 1) / BM) * ((N + BN - 1) / BN), E);
  else
    grid = dim3((N + BN - 1) / BN, (M + BM - 1) / BM + E);
  if (grid.x == 0 || grid.y == 0) return 0;
  gmm_kernel<T, MODE><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const void* lhs, const void* rhs, const void* group_sizes,
             void* out, int M, int K, int N, int E, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, MODE>(lhs, rhs, group_sizes, out, M, K, N,
                                       E, s);
  if (dtype == 0)
    return launch<float, MODE>(lhs, rhs, group_sizes, out, M, K, N, E, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// lhs [M,K]; rhs [E,K,N] (transpose_rhs = 0) or [E,N,K] (1); group_sizes
// [E] int32 on the device; out [M,N]. dtype 0 = float32, 1 = bfloat16 (all
// three matrices). K and N multiples of 8, rows 16-byte aligned; the grid's
// y size ceil(M/128) + E stays within 65535 (the wrapper checks).
extern "C" int dstpu_gmm(const void* lhs, const void* rhs,
                         const void* group_sizes, void* out, int M, int K,
                         int N, int E, int transpose_rhs, int dtype,
                         void* stream) {
  if (transpose_rhs)
    return dispatch<kGmmT>(lhs, rhs, group_sizes, out, M, K, N, E, dtype,
                           stream);
  return dispatch<kGmm>(lhs, rhs, group_sizes, out, M, K, N, E, dtype,
                        stream);
}

// lhs [M,K] (the tgmm's lhs^T [K,M] as it lies in memory); grad [M,N];
// out [E,K,N].
extern "C" int dstpu_tgmm(const void* lhs, const void* grad,
                          const void* group_sizes, void* out, int M, int K,
                          int N, int E, int dtype, void* stream) {
  return dispatch<kTgmm>(lhs, grad, group_sizes, out, M, K, N, E, dtype,
                         stream);
}
