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
// Work map. Megablox builds a tile-to-group schedule on the host side of
// the TPU program (`make_group_metadata`); here there is no host step: the
// row tiles are an upper bound of ceil(M/128) + E (a group boundary inside
// a tile adds one tile, the rows past the last group one more), and each
// block walks group_sizes (E int32 on the device) to find the (group, row
// tile) of its slot, or skips it. No host sync, no schedule kernel. Rows of
// another group (and rows past M, columns past K or N) are zero-filled by
// cp.async's src-size operand, never read, and never written. tgmm splits
// each group's rows into chunks of `rc` rows (the last one shorter) and
// gives a block one (chunk, tile of out[e]); the block sums its chunk's
// rows in fp32 and writes the tile to the chunk's slot of an fp32
// workspace (no rounding), and a second kernel adds a group's chunk slots
// in chunk order and rounds the sum once to the output dtype. No atomics,
// so the weight gradient is deterministic. One accumulator over a whole
// group's rows (~10-19 k, as a block summed them before) drifted up to
// 2.8e-3 from the exact sum at outputs of O(100) on the card (the fp32
// body 2.2-6.3e-3), against 0.07-1.3e-3 for the library's fp32 product;
// a chunk of 1024 rows bounds each running sum's length, and the chunk
// sums add in a short second pass. Rows past the groups' chunks are never
// read; the number of chunk slots has the upper bound ceil(M/rc) + E.
//
// bf16: Hopper's warpgroup tensor cores (`wgmma.mma_async` m64n128k16, fp32
// sums; helpers in wgmma.cuh), warp-specialised. A block of 384 threads
// computes 128 x 256 output tiles: warpgroups 0 and 1 (the consumers) each
// own 64 rows of the tile (two n128 accumulator sets, 128 fp32 a thread)
// and issue wgmma from shared memory; warpgroup 2 (the producer) keeps a
// ring of 4 k-steps of 64 in flight with 16-byte cp.async copies, each
// stage's completion tracked by a `full` mbarrier
// (cp.async.mbarrier.arrive.noinc) and its release by an `empty` one. Each
// operand is copied as it lies in device memory into the 128-byte swizzled
// layout wgmma reads, and read with wgmma's transpose flag where its output
// dim is the contiguous one (gmm's rhs [K, N]; tgmm's lhs and grad): one
// body serves the three modes, and no operand is transposed in shared
// memory. The producer plans each thread's copies once a tile (pointers,
// swizzled offsets, row masks), so a k-step costs it 24 copies and a few
// adds: with the addresses recomputed every step it was the bottleneck.
// One wgmma group stays in flight behind the next. The epilogue rounds
// the sums to bf16 in registers, stages each warp's 16 rows x 128 columns
// through a swizzled shared buffer of its own and writes them as 16-byte
// row-contiguous stores, masked to the group's rows and to N. gmm and
// gmmT run persistent (one block per SM, a static stride over the tiles),
// so the producer loads the next tile while the consumers write this one;
// tgmm's tiles differ in depth with the group sizes, so it launches one
// block per tile and lets the hardware balance them. The accumulators fit
// the 168 registers a thread of a 384-thread block has: no setmaxnreg.
//
// fp32: exact fp32 fused multiply-adds on the CUDA cores (no TF32; 256
// threads, each 8 x 8 of a 128 x 128 tile) from a two-stage cp.async ring;
// the transposed operands (gmmT's rhs, tgmm's lhs) are staged as they lie
// in memory.
// Launches go on the caller's stream; nothing is allocated; the C entry
// points return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int BM = 128;     // output rows of a tile (tgmm: rows of out[e])
constexpr int BN = 128;     // output columns of a tile
enum Mode { kGmm = 0, kGmmT = 1, kTgmm = 2 };

template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int BK = 16, PAD = 4;   // PAD: 16 bytes, keeps rows aligned
};

// Shared-memory layout of one pipeline stage of the fp32 body. A is the
// [rows x contraction] operand, B the [contraction x columns] one; a *_COL
// operand is staged transposed (contraction-major for A, column-major for
// B), as it lies in device memory.
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
  float* ws;               // tgmm: [ceil(M/rc) + E, K, N] chunk sums
  int rc;                  // tgmm: rows of a chunk
};

// This block's piece of work.
struct Work {
  int e;          // group
  int gs, ge;     // the group's rows [gs, ge), clamped to M
  int row0, n0;   // the output tile's first row and column
  int rlo, rhi;   // output rows this block may write
  int nk;         // contraction steps (0: the tile is written as zeros)
  int64_t out_off;
};

// The chunks of rc rows group e's rows [start, end) make (none if empty).
__device__ __forceinline__ int chunks_of(int start, int end, int rc) {
  return end > start ? (end - start + rc - 1) / rc : 0;
}

// The work of slot (x, y) for tiles BM x TN. tgmm: x a tile of out[e], y a
// chunk slot; walk the groups' chunks (group by group, each group's in row
// order) to find its (group, chunk), whose sum goes to ws[y], or return
// false. gmm, gmmT: x a column tile, y an upper-bound row tile; walk the
// groups (and the tail past them, e == E) to find its (group, row tile),
// or return false.
template <typename T, int MODE, int BK, int TN = BN>
__device__ __forceinline__ bool find_work(const Args<T>& a, int x, int y,
                                          Work& w) {
  if constexpr (MODE == kTgmm) {
    const int tiles_n = (a.N + TN - 1) / TN;
    int64_t off = 0;
    int seen = 0;
    bool found = false;
    for (int e = 0; e < a.E && !found; ++e) {
      const int64_t size = size_of(a.group_sizes, e);
      const int start = (int)clamp_hi(off, a.M);
      const int end = (int)clamp_hi(off + size, a.M);
      off += size;
      const int count = chunks_of(start, end, a.rc);
      if (y < seen + count) {
        w.e = e;
        w.gs = start + (y - seen) * a.rc;
        w.ge = (int)clamp_hi((int64_t)w.gs + a.rc, end);
        found = true;
      }
      seen += count;
    }
    if (!found) return false;
    w.row0 = (x / tiles_n) * BM;
    w.n0 = (x % tiles_n) * TN;
    w.rlo = 0;
    w.rhi = a.K;
    w.nk = (w.ge - w.gs + BK - 1) / BK;
    w.out_off = (int64_t)y * a.K * a.N;
    return true;
  } else {
    w.n0 = x * TN;
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
      if (y < seen + count) {
        w.e = e;
        w.gs = start;
        w.ge = end;
        w.row0 = (first + y - seen) * BM;
        found = true;
      }
      seen += count;
    }
    if (!found) return false;
    w.rlo = w.gs;
    w.rhi = w.ge;
    w.out_off = 0;
    // rows past sum(group_sizes) (e == E): zeros
    w.nk = w.e == a.E ? 0 : (a.K + BK - 1) / BK;
    return true;
  }
}

// ------------------------------------------------------------------------ //
// bf16: warp-specialised wgmma
// ------------------------------------------------------------------------ //
namespace wg {

constexpr int kThreads = 384;          // warpgroups 0, 1 consume; 2 produces
constexpr int kConsumers = 256;
constexpr int BK = 64;                 // one 128-byte swizzle row of bf16
constexpr int kA = BM * BK * 2;        // the A tile of a k-step, 16 KB
constexpr int kBlock = 64 * 128;       // a 64-wide MN-major block: 64 rows
constexpr int kEpi = 8 * 16 * 128 * 2; // each consumer warp: 16 rows x 128
constexpr int TN = 256;                // output columns of a tile
constexpr int kB = TN * BK * 2;        // the B tile of a k-step, 32 KB
constexpr int kStage = kA + kB;
constexpr int STAGES = 4;              // the most that fit beside kEpi
// 1 KB of slack aligns the ring to the swizzle's 1024 bytes; then the
// barriers. 230,464 bytes of a block's 232,448.
constexpr int kSmemBytes = 1024 + STAGES * kStage + kEpi + 2 * STAGES * 8;
static_assert(kSmemBytes <= 232448, "a block's opt-in shared memory");

// A producer thread's copies of one operand, planned once a tile; each
// call of load() copies the next k-step's 16-byte chunks into a stage's
// tile and moves on (p: the thread's index in the producer warpgroup).
// A chunk outside the valid rows or columns gets src-size 0: zero-filled,
// nothing read (its address is never dereferenced).
//
// K-major, ROWS rows of 64 contraction elements (128 bytes): the thread
// takes chunk c = p % 8 of rows r0 + 16 j, r0 = p / 8; the swizzle of row
// r0 + 16 j is row r0's, so chunk j lies 16 rows (2048 bytes) past chunk 0.
template <int ROWS>
struct FeedK {
  const bf16* src;     // chunk 0 of this k-step
  int64_t jstep;       // 16 rows
  uint32_t off;        // chunk 0's byte offset in the tile
  uint32_t rows_ok;    // bit j: row r0 + 16 j lies in [lo, hi)
  int col, cols;       // the chunk's first contraction index; the bound

  __device__ __forceinline__ void init(const bf16* g, int64_t ld,
                                       int row_base, int lo, int hi,
                                       int cols_, int p) {
    const int c = p & 7, r0 = p >> 3;
    src = g + (int64_t)(row_base + r0) * ld + 8 * c;
    jstep = 16 * ld;
    off = dstpu_wg::swz128(r0, c);
    rows_ok = 0;
#pragma unroll
    for (int j = 0; j < ROWS / 16; ++j) {
      const int r = row_base + r0 + 16 * j;
      rows_ok |= (r >= lo && r < hi ? 1u : 0u) << j;
    }
    col = 8 * c;
    cols = cols_;
  }
  __device__ __forceinline__ void load(uint32_t tile) {
    const bool cok = col < cols;
#pragma unroll
    for (int j = 0; j < ROWS / 16; ++j)
      dstpu_wg::cp_async16(tile + off + j * 2048, src + j * jstep,
                           cok && ((rows_ok >> j) & 1));
    src += 64;
    col += 64;
  }
};

// MN-major, 64 contraction rows of CB chunks (the output dim, CB = 16 or
// 32): the thread takes chunk c = p % CB of rows r0 + RS j, r0 = p / CB,
// RS = 128 / CB; 64-wide column blocks lie kBlock bytes apart.
template <int CB>
struct FeedMN {
  static constexpr int RS = 128 / CB;
  const bf16* src;     // chunk 0 of this k-step
  int64_t jstep, kstep;
  uint32_t off, x0, x1;  // row r0's offset; the swizzled chunk of rows
                         // whose index mod 8 is r0 % 8 (x0), or r0 + 4 (x1)
  bool col_ok;
  int lim;             // rows left from row r0 of this k-step

  __device__ __forceinline__ void init(const bf16* g, int64_t ld,
                                       int krow, int krow_hi, int col_base,
                                       int ncols, int p) {
    const int c = p % CB, r0 = p / CB;
    src = g + (int64_t)(krow + r0) * ld + col_base + 8 * c;
    jstep = RS * ld;
    kstep = 64 * ld;
    off = (c >> 3) * kBlock + r0 * 128;
    x0 = ((c & 7) ^ (r0 & 7)) << 4;
    x1 = ((c & 7) ^ ((r0 + 4) & 7)) << 4;
    col_ok = col_base + 8 * c < ncols;
    lim = krow_hi - krow - r0;
  }
  __device__ __forceinline__ void load(uint32_t tile) {
#pragma unroll
    for (int j = 0; j < 64 / RS; ++j)
      dstpu_wg::cp_async16(
          tile + off + j * RS * 128 + ((RS * j) & 4 ? x1 : x0),
          src + j * jstep, col_ok && RS * j < lim);
    src += kstep;
    lim -= 64;
  }
};

// The producer's plan of one tile: A's feed and B's (gmm: lhs rows K-major,
// rhs[e] [K, N] N-major; gmmT: rhs[e] [N, K] K-major; tgmm: lhs and grad
// over the group's rows, both MN-major).
template <int MODE>
struct Feeds {
  std::conditional_t<MODE == kTgmm, FeedMN<16>, FeedK<BM>> fa;
  std::conditional_t<MODE == kGmmT, FeedK<TN>, FeedMN<TN / 8>> fb;

  __device__ __forceinline__ void init(const Args<bf16>& a, const Work& w,
                                       int p) {
    if constexpr (MODE == kTgmm) {
      fa.init(a.lhs, a.K, w.gs, w.ge, w.row0, a.K, p);
      fb.init(a.rhs, a.N, w.gs, w.ge, w.n0, a.N, p);
    } else {
      fa.init(a.lhs, a.K, w.row0, w.gs, w.ge, a.K, p);
      const bf16* rhs = a.rhs + (int64_t)w.e * a.K * a.N;
      if constexpr (MODE == kGmm)
        fb.init(rhs, a.N, 0, a.K, w.n0, a.N, p);
      else
        fb.init(rhs, a.K, w.n0, 0, a.N, a.K, p);
    }
  }
};

// Consumer warpgroup g's (0 or 1) product of one k-step from stage
// (sA, sB): for each k16, one wgmma a 128-column part of the tile into its
// 64 x TN accumulators.
template <int MODE>
__device__ __forceinline__ void mma_stage(float (&acc)[TN / 128][64],
                                          uint32_t sA, uint32_t sB, int g) {
  constexpr int TA = MODE == kTgmm;    // A MN-major
  constexpr int TB = MODE != kGmmT;    // B MN-major
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t da =
        TA ? dstpu_wg::desc(sA + g * kBlock + kk * 2048, kBlock, 1024)
           : dstpu_wg::desc(sA + g * kBlock + kk * 32, 16, 1024);
#pragma unroll
    for (int h = 0; h < TN / 128; ++h) {
      const uint64_t db =
          TB ? dstpu_wg::desc(sB + 2 * h * kBlock + kk * 2048, kBlock, 1024)
             : dstpu_wg::desc(sB + h * 128 * 128 + kk * 32, 16, 1024);
      dstpu_wg::mma_m64n128k16<TA, TB>(acc[h], da, db);
    }
  }
}

// A consumer warp's 16 rows x 128 columns of the tile (warp 0..7 of the
// block: rows 16 warp ..; columns from n0) rounded to bf16, through its
// own 4 KB of the epilogue buffer (row lr at lr * 256, 16-byte chunk j at
// j ^ (lr & 7)) to 16-byte global stores of whole row pieces.
__device__ __forceinline__ void store_part(unsigned char* epi,
                                           const float (&acc)[64],
                                           const Args<bf16>& a,
                                           const Work& w, int n0, int warp,
                                           int lane) {
  unsigned char* buf = epi + warp * 4096;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    const int off = ((j ^ g) << 4) + 4 * t;      // (g + 8) & 7 == g
    *reinterpret_cast<__nv_bfloat162*>(buf + g * 256 + off) = lo;
    *reinterpret_cast<__nv_bfloat162*>(buf + (g + 8) * 256 + off) = hi;
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int idx = lane + 32 * it, lr = idx >> 4, c = idx & 15;
    const int grow = w.row0 + 16 * warp + lr, gcol = n0 + 8 * c;
    const uint4 v = *reinterpret_cast<const uint4*>(
        buf + lr * 256 + ((c ^ (lr & 7)) << 4));
    if (grow >= w.rlo && grow < w.rhi && gcol < a.N)
      *reinterpret_cast<uint4*>(a.out + w.out_off + (int64_t)grow * a.N +
                                gcol) = v;
  }
  __syncwarp();
}

// A consumer warp's 16 rows x 128 columns of a tgmm chunk's tile (rows
// 16 warp .. of the tile, columns from n0) as fp32 to its workspace slot:
// each thread's column pairs as 8-byte stores, a row's four threads
// covering 32 contiguous bytes.
__device__ __forceinline__ void store_part_f32(const float (&acc)[64],
                                               const Args<bf16>& a,
                                               const Work& w, int n0,
                                               int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r = w.row0 + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= a.N) continue;
    if (r < w.rhi)
      *reinterpret_cast<float2*>(a.ws + w.out_off + (int64_t)r * a.N + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < w.rhi)
      *reinterpret_cast<float2*>(a.ws + w.out_off + (int64_t)(r + 8) * a.N +
                                 col) = make_float2(acc[4 * j + 2],
                                                    acc[4 * j + 3]);
  }
}

// Slot t of the launch → its work: tgmm x = t mod tiles of out[e], y the
// chunk slot; gmm / gmmT x = the column tile, y the row slot.
template <int MODE>
__device__ __forceinline__ bool slot_work(const Args<bf16>& a, int t,
                                          int per_y, Work& w) {
  return find_work<bf16, MODE, BK, TN>(a, t % per_y, t / per_y, w);
}

}  // namespace wg

template <int MODE>
__global__ void __launch_bounds__(wg::kThreads, 1)
    gmm_wgmma_kernel(const Args<bf16> a, int n_slots, int per_y) {
  using namespace wg;
  extern __shared__ unsigned char gg_smem[];
  const uint32_t raw = dstpu_wg::smem_u32(gg_smem);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* epi = gg_smem + (ring - raw) + STAGES * kStage;
  const uint32_t full = ring + STAGES * kStage + kEpi;
  const uint32_t empty = full + STAGES * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      dstpu_wg::mbar_init(full + 8 * s, 128);     // the producer's threads
      dstpu_wg::mbar_init(empty + 8 * s, kConsumers);
    }
    dstpu_wg::mbar_fence_init();
  }
  __syncthreads();

  int it = 0;     // k-steps through the ring so far: stage it % STAGES
  if (threadIdx.x >= kConsumers) {
    // producer
    const int p = threadIdx.x - kConsumers;
    for (int t = blockIdx.x; t < n_slots; t += gridDim.x) {
      Work w;
      if (!slot_work<MODE>(a, t, per_y, w)) continue;
      Feeds<MODE> f;
      f.init(a, w, p);
      for (int kt = 0; kt < w.nk; ++kt, ++it) {
        const int s = it % STAGES, round = it / STAGES;
        if (round > 0) dstpu_wg::mbar_wait(empty + 8 * s, (round - 1) & 1);
        const uint32_t sA = ring + s * kStage;
        f.fa.load(sA);
        f.fb.load(sA + kA);
        dstpu_wg::cp_async_arrive(full + 8 * s);
      }
    }
    dstpu_wg::cp_async_wait_all();
  } else {
    // consumers
    const int g = threadIdx.x >> 7, warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    float acc[TN / 128][64];
    for (int t = blockIdx.x; t < n_slots; t += gridDim.x) {
      Work w;
      if (!slot_work<MODE>(a, t, per_y, w)) continue;
#pragma unroll
      for (int h = 0; h < TN / 128; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
      int prev = 0;
      for (int kt = 0; kt < w.nk; ++kt, ++it) {
        const int s = it % STAGES;
        dstpu_wg::mbar_wait(full + 8 * s, (it / STAGES) & 1);
        dstpu_wg::fence_proxy_async();
#pragma unroll
        for (int h = 0; h < TN / 128; ++h) dstpu_wg::fence_acc(acc[h]);
        dstpu_wg::fence();
        const uint32_t sA = ring + s * kStage;
        mma_stage<MODE>(acc, sA, sA + kA, g);
        dstpu_wg::commit();
        dstpu_wg::wait<1>();           // the previous step's group is done
#pragma unroll
        for (int h = 0; h < TN / 128; ++h) dstpu_wg::fence_acc(acc[h]);
        if (kt > 0) dstpu_wg::mbar_arrive(empty + 8 * prev);
        prev = s;
      }
      dstpu_wg::wait<0>();
#pragma unroll
      for (int h = 0; h < TN / 128; ++h) dstpu_wg::fence_acc(acc[h]);
      if (w.nk > 0) dstpu_wg::mbar_arrive(empty + 8 * prev);
#pragma unroll
      for (int h = 0; h < TN / 128; ++h) {
        if constexpr (MODE == kTgmm)
          store_part_f32(acc[h], a, w, w.n0 + 128 * h, warp, lane);
        else
          store_part(epi, acc[h], a, w, w.n0 + 128 * h, warp, lane);
      }
    }
  }
}

// tgmm's second pass: out[e] = the sum of group e's chunk slots of ws, in
// chunk order, rounded once to T (zeros for an empty group); four
// consecutive elements a thread, grid (element blocks, E).
__device__ __forceinline__ void store4(float* o, float4 v) {
  *reinterpret_cast<float4*>(o) = v;
}
__device__ __forceinline__ void store4(bf16* o, float4 v) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(o);
  p[0] = __floats2bfloat162_rn(v.x, v.y);
  p[1] = __floats2bfloat162_rn(v.z, v.w);
}

template <typename T>
__global__ void __launch_bounds__(256)
    tgmm_reduce_kernel(const float* __restrict__ ws,
                       const int* __restrict__ group_sizes,
                       T* __restrict__ out, int M, int K, int N, int rc) {
  const int e = blockIdx.y;
  int64_t off = 0;
  int first = 0, count = 0;
  for (int i = 0; i <= e; ++i) {
    const int64_t size = size_of(group_sizes, i);
    const int start = (int)clamp_hi(off, M);
    const int end = (int)clamp_hi(off + size, M);
    off += size;
    const int n = chunks_of(start, end, rc);
    if (i < e) first += n; else count = n;
  }
  const int64_t kn = (int64_t)K * N;
  const float* src = ws + (int64_t)first * kn;
  T* dst = out + (int64_t)e * kn;
  for (int64_t i = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
       i < kn; i += 4 * (int64_t)gridDim.x * blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < count; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(src + c * kn + i);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    store4(dst + i, acc);
  }
}

// The chunk slots of a tgmm launch: an upper bound of the groups' chunks.
inline int tgmm_slots(int M, int E, int rc) { return (M + rc - 1) / rc + E; }

template <typename T>
int launch_tgmm_reduce(const Args<T>& a, cudaStream_t stream) {
  const int64_t kn = (int64_t)a.K * a.N;
  int64_t blocks = (kn / 4 + 255) / 256;
  if (blocks > 2048) blocks = 2048;
  if (blocks == 0 || a.E == 0) return 0;
  tgmm_reduce_kernel<T><<<dim3((unsigned)blocks, a.E), 256, 0, stream>>>(
      a.ws, a.group_sizes, a.out, a.M, a.K, a.N, a.rc);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_wgmma(const Args<bf16>& a, cudaStream_t stream) {
  constexpr int TN = wg::TN, kSmem = wg::kSmemBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_wgmma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return (int)attr;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  const int tiles_n = (a.N + TN - 1) / TN;
  int per_y, n_slots, grid;
  if (MODE == kTgmm) {
    per_y = ((a.K + BM - 1) / BM) * tiles_n;
    n_slots = per_y * tgmm_slots(a.M, a.E, a.rc);
    grid = n_slots;
  } else {
    per_y = tiles_n;
    n_slots = tiles_n * ((a.M + BM - 1) / BM + a.E);
    grid = n_slots < sms ? n_slots : sms;
  }
  if (n_slots == 0) return 0;
  gmm_wgmma_kernel<MODE><<<grid, wg::kThreads, kSmem, stream>>>(
      a, n_slots, per_y);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (MODE == kTgmm) return launch_tgmm_reduce(a, stream);
  return 0;
}

// ------------------------------------------------------------------------ //
// fp32
// ------------------------------------------------------------------------ //

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
  __shared__ __align__(128) unsigned char smem[Layout<T, MODE>::SMEM_BYTES];
  Work w;
  if (!find_work<T, MODE, Layout<T, MODE>::BK>(a, blockIdx.x, blockIdx.y, w))
    return;
  if (w.nk == 0 && MODE != kTgmm) {     // rows past sum(group_sizes): zeros
    write_zeros(a, 0, w.row0, w.rlo, w.rhi, w.n0);
    return;
  }
  mainloop_store<MODE>(smem, a, w);
}

// fp32: grid (column tiles, upper bound of row tiles) for gmm / gmmT,
// (tiles of out[e], chunk slots) for tgmm, whose blocks write their chunk
// sums to the workspace (the body's out) before the second pass
template <int MODE>
int launch_fp32(const Args<float>& a, cudaStream_t stream) {
  dim3 grid;
  if (MODE == kTgmm)
    grid = dim3(((a.K + BM - 1) / BM) * ((a.N + BN - 1) / BN),
                tgmm_slots(a.M, a.E, a.rc));
  else
    grid = dim3((a.N + BN - 1) / BN, (a.M + BM - 1) / BM + a.E);
  if (grid.x == 0 || grid.y == 0) return 0;
  if constexpr (MODE == kTgmm) {
    Args<float> body = a;
    body.out = a.ws;
    gmm_kernel<float, MODE><<<grid, kThreads, 0, stream>>>(body);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_tgmm_reduce(a, stream);
  }
  gmm_kernel<float, MODE><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const void* lhs, const void* rhs, const void* group_sizes,
             void* out, void* ws, int M, int K, int N, int E, int rc,
             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (MODE == kTgmm && (ws == nullptr || rc <= 0))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_wgmma<MODE>(
        Args<bf16>{static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs),
                   static_cast<bf16*>(out),
                   static_cast<const int*>(group_sizes), M, K, N, E,
                   static_cast<float*>(ws), rc},
        s);
  if (dtype == 0)
    return launch_fp32<MODE>(
        Args<float>{static_cast<const float*>(lhs),
                    static_cast<const float*>(rhs), static_cast<float*>(out),
                    static_cast<const int*>(group_sizes), M, K, N, E,
                    static_cast<float*>(ws), rc},
        s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// lhs [M,K]; rhs [E,K,N] (transpose_rhs = 0) or [E,N,K] (1); group_sizes
// [E] int32 on the device; out [M,N]. dtype 0 = float32, 1 = bfloat16 (all
// three matrices). K and N multiples of 8, rows 16-byte aligned; the fp32
// grid's y size ceil(M/128) + E stays within 65535 (the wrapper checks).
extern "C" int dstpu_gmm(const void* lhs, const void* rhs,
                         const void* group_sizes, void* out, int M, int K,
                         int N, int E, int transpose_rhs, int dtype,
                         void* stream) {
  if (transpose_rhs)
    return dispatch<kGmmT>(lhs, rhs, group_sizes, out, nullptr, M, K, N, E,
                           0, dtype, stream);
  return dispatch<kGmm>(lhs, rhs, group_sizes, out, nullptr, M, K, N, E, 0,
                        dtype, stream);
}

// lhs [M,K] (the tgmm's lhs^T [K,M] as it lies in memory); grad [M,N];
// out [E,K,N]; ws an fp32 workspace of dstpu_tgmm_ws_elems(M, K, N, E, rc)
// elements; rc the rows of a chunk (> 0).
extern "C" int dstpu_tgmm(const void* lhs, const void* grad,
                          const void* group_sizes, void* out, void* ws,
                          int M, int K, int N, int E, int rc, int dtype,
                          void* stream) {
  return dispatch<kTgmm>(lhs, grad, group_sizes, out, ws, M, K, N, E, rc,
                         dtype, stream);
}

// The fp32 elements of tgmm's chunk workspace: (ceil(M/rc) + E) x K x N.
extern "C" int64_t dstpu_tgmm_ws_elems(int M, int K, int N, int E, int rc) {
  return rc > 0 ? (int64_t)tgmm_slots(M, E, rc) * K * N : 0;
}

// Dynamic shared memory of a launch, every mode alike (bytes; dtype 0 =
// float32, whose kernels take only static shared memory, 1 = bfloat16).
extern "C" int dstpu_gmm_smem_bytes(int dtype) {
  return dtype == 1 ? wg::kSmemBytes : 0;
}
