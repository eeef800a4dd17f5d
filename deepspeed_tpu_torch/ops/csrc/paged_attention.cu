// Paged attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/paged_attention.py `_kernel` (via
// `paged_attention`), the Pallas TPU kernel that FastGen's tick runs per
// layer. Same function: token t's rep = N/K query heads of kv head k attend
// to the first lengths[t] cache slots of its sequence, found through
// tables[t, :] in the pool [NB, bs, K, D]; scale 1/sqrt(D); fp32 scores,
// softmax and sums; slots at index >= lengths[t] masked (lengths clamped to
// [0, MB*bs]); a row of length 0 gives 0 (the TPU kernel's `l_safe`);
// output in q's dtype.
//
// What bounds it on this card: bytes. Each (row, kv head) reads len slots
// of K and V once ([D] each) and does 4*rep*D flops a slot: at rep <= 8 at
// most 8 flops a byte, far below the H100's ridge. A prefill chunk's rows
// share one table row, so their KV need be read only once for all of them.
//
// A tick's rows are split between two kernels by a plan that the wrapper
// builds on the device from `tables` (ops/paged_attention.py
// `build_plan`): a run of at least MIN_RUN consecutive rows with equal
// table rows (a prompt's chunk, or the pad rows) is cut into tiles of up
// to 64 rows for the prefill kernel; every other row is a decode row. Grids
// are sized from what the host knows (T, MB, K); blocks with no work exit.
//
// Decode (paged_attention_decode_kernel): split-KV ("flash-decoding").
// * grid (row slot, kv head, split): each block covers `split` (128) slots
//   of one row; the x blocks walk the decode rows with stride gridDim.x, so
//   the grid is bounded without reading the row count on the host. A split
//   past a row's length exits at once.
// * 128 threads; K/V tiles of 32 slots are gathered through the table by
//   16-byte cp.async into a 2-stage ring (the next tile in flight while
//   one computes; one barrier a tile), chunks XOR-swizzled by the slot (no
//   bank conflicts for the copies or the reads).
// * each warp owns 8 slots of every tile and keeps its own online softmax
//   (m, l, acc) in registers: a lane quad-splits a slot's dot product over
//   D (three shuffles reduce it), so the rep query heads of the kv head
//   share each staged K row; P stays fp32 and is shuffled to the lanes
//   that own the output columns (D / 32 each) for P V.
// * the 4 warps' states merge through shared memory at the end of the
//   split; a row with one split writes its output. A longer row's splits
//   write fp32 (acc, m, l) partials, and the last split of a (row, kv head)
//   to finish (a counter in device memory, reset by that block) merges
//   them: no second kernel, no second launch.
// * fp32 takes only this path (every row a decode row; no tensor cores).
//
// Prefill (paged_attention_prefill_kernel_mma, bf16): flash_attention.cu's
// forward body with a paged KV walk.
// * grid (plan tile, kv head, sub-tile): a block takes per = 64 / rep rows
//   of a tile with their rep heads (up to 64 query-head rows, row-major
//   (row, head)), and walks the KV once, up to the longest of its rows'
//   lengths; ceil(64 / per) sub-tiles cover a tile's 64 rows at any rep
//   (rep 3: 4 blocks of 21 rows).
// * each 64-slot K/V tile is gathered from its pool blocks by cp.async
//   (one table lookup a 16-byte chunk, any bs) into a two-stage ring.
// * Q K^T and P V are mma.sync m16n8k16 with bf16 operands and fp32 sums;
//   the mask is per row (slot < lengths[row]) and applies only to tiles
//   that reach past the shortest row. P is rounded to bf16 before P V, as
//   in the flash forward; the softmax and every sum stay fp32.
//
// Shared memory above 48 KB is opted into once per instantiation; every
// launch returns cudaGetLastError() to the wrapper. Nothing is allocated
// here: the wrapper hands in the partials' scratch and the counters.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "tensor_core.cuh"

namespace {

using dstpu_attn::kNegInf;
using dstpu_attn::store;
using dstpu_attn::to_float;
using dstpu_attn::Vec16;

constexpr int kMaxRep = 8;         // query heads per kv head
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------------ //
// decode (split-KV, the merge in the last split)
// ------------------------------------------------------------------------ //
constexpr int kDecThreads = 128;   // 4 warps
constexpr int kWarps = kDecThreads / 32;
constexpr int kTS = 32;            // slots a staged tile, 8 a warp
constexpr int kStages = 2;         // tiles in the ring

struct DecodeArgs {
  const void* q;
  const void* kpool;
  const void* vpool;
  const int* tables;
  const int* lengths;
  const int* rows;      // the decode rows, or nullptr: rows 0 .. T-1
  const int* n_rows;    // their count (device), read when rows != nullptr
  void* out;
  float* part_acc;      // [T, N, S, D]: a split's unnormalised P V
  float2* part_ml;      // [T, N, S]: its (max, sum)
  int* sem;             // [T, K]: splits done a (row, kv head), 0 between
                        // launches
  int T, N, K, bs, MB, S, split;
  float scale;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte offset of 16-byte chunk c of slot row r in a [kTS][D] tile of T
// (CH >= 8 chunks a row: chunk c lies at c ^ (r & 7))
template <int CH>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return static_cast<uint32_t>((r * CH + (c ^ (r & 7))) << 4);
}

template <typename T, int D>
constexpr int dec_smem_bytes() {
  // the K/V ring, then the rep query rows in fp32
  return kStages * 2 * kTS * D * (int)sizeof(T) + kMaxRep * D * 4;
}

__device__ __forceinline__ int row_len(const DecodeArgs& a, int t) {
  return min(max(a.lengths[t], 0), a.MB * a.bs);
}

// R: the rep (= N / K) rounded up to 1, 2, 4 or 8; the heads' registers
template <typename T, int D, int R>
__global__ void __launch_bounds__(kDecThreads)
paged_attention_decode_kernel(DecodeArgs a) {
  constexpr int ES = sizeof(T);
  constexpr int EPC = 16 / ES;                 // elements a chunk
  constexpr int CH = D / EPC;                  // chunks a slot row
  constexpr int CPL = D / 32;                  // P V columns a lane
  constexpr uint32_t kTile = kTS * D * ES;     // bytes of a K (or V) tile
  static_assert(CH >= 8 && CH % 4 == 0, "swizzle and quad split");
  static_assert(kWarps * kMaxRep * D * 4 <= kStages * 2 * (int)kTile,
                "the warps' states fit in the ring");
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + kStages * 2 * kTile);
  __shared__ float ms[kWarps][kMaxRep], ls[kWarps][kMaxRep];
  __shared__ bool s_last;
  const uint32_t sring = dstpu_tc::smem_u32(smem);

  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.kpool);
  const T* vp = static_cast<const T*>(a.vpool);
  T* out = static_cast<T*>(a.out);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = blockIdx.y, s = blockIdx.z;
  const int rep = a.N / a.K;
  const int n_rows = a.rows ? *a.n_rows : a.T;
  const int jj = lane & 7, part = lane >> 3;   // slot of the warp, D quarter
  const int r = warp * 8 + jj;                 // this lane's slot in a tile
  const int64_t slot_stride = (int64_t)a.K * D;

  for (int i = blockIdx.x; i < n_rows; i += gridDim.x) {
    const int t = a.rows ? a.rows[i] : i;
    const int len = row_len(a, t);
    const int nsplit = max(1, (len + a.split - 1) / a.split);
    if (s >= nsplit) continue;                 // uniform over the block
    const int c_lo = s * a.split, c_hi = min(len, c_lo + a.split);
    const int n_tiles = max(0, c_hi - c_lo + kTS - 1) / kTS;
    const int* table = a.tables + (int64_t)t * a.MB;

    // tile j (slots c_lo + kTS j ..) into its ring stage; slots >= c_hi are
    // zero-filled. One commit group a call, empty or not.
    auto issue = [&](int j) {
      if (j < n_tiles) {
        const uint32_t base = sring + (j % kStages) * 2 * kTile;
        for (int u = tid; u < kTS * CH; u += kDecThreads) {
          const int rr = u / CH, c = u % CH, slot = c_lo + j * kTS + rr;
          const bool ok = slot < c_hi;
          int64_t off = 0;
          if (ok) {
            off = ((int64_t)table[slot / a.bs] * a.bs + slot % a.bs) *
                      slot_stride + (int64_t)kh * D + c * EPC;
          }
          const uint32_t dst = base + chunk_off<CH>(rr, c);
          dstpu_tc::cp_async16(dst, kp + off, ok);
          dstpu_tc::cp_async16(dst + kTile, vp + off, ok);
        }
      }
      dstpu_tc::cp_async_commit();
    };

    __syncthreads();     // the previous row's merge is done with the smem
    const T* qrow = q + ((int64_t)t * a.N + (int64_t)kh * rep) * D;
    for (int u = tid; u < rep * D; u += kDecThreads) qs[u] = to_float(qrow[u]);
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) issue(j);

    float m[R], l[R], acc[R][CPL];
#pragma unroll
    for (int h = 0; h < R; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) acc[h][k] = 0.f;
    }
    for (int j = 0; j < n_tiles; ++j) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // tile j landed everywhere; stage (j - 1) is free
      issue(j + kStages - 1);
      const unsigned char* tk = smem + (j % kStages) * 2 * kTile;
      const unsigned char* tv = tk + kTile;

      // scores: lane (jj, part) sums D / 4 of slot r's dot with each head
      float sc[R];
#pragma unroll
      for (int h = 0; h < R; ++h) sc[h] = 0.f;
#pragma unroll
      for (int u = 0; u < CH / 4; ++u) {
        const int c = part + 4 * u;
        float kf[EPC];
        Vec16<T>::load(reinterpret_cast<const T*>(tk + chunk_off<CH>(r, c)),
                       kf);
#pragma unroll
        for (int h = 0; h < R; ++h) {
          if (h < rep) {
            const float* qq = qs + h * D + c * EPC;
            float d0 = sc[h];
#pragma unroll
            for (int e = 0; e < EPC; ++e) d0 = fmaf(qq[e], kf[e], d0);
            sc[h] = d0;
          }
        }
      }
      const bool live = c_lo + j * kTS + r < c_hi;
      float p[R];
#pragma unroll
      for (int h = 0; h < R; ++h) {
        if (h < rep) {                         // rep is uniform: no divergence
          float x = sc[h];
          x += __shfl_xor_sync(kFull, x, 8);
          x += __shfl_xor_sync(kFull, x, 16);
          x = live ? x * a.scale : -INFINITY;
          float mt = x;
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 4));
          const float mn = fmaxf(m[h], mt);
          const float alpha = expf(m[h] - mn);
          const float pp = expf(x - mn);       // 0 for a masked slot
          float sum = pp;
          sum += __shfl_xor_sync(kFull, sum, 1);
          sum += __shfl_xor_sync(kFull, sum, 2);
          sum += __shfl_xor_sync(kFull, sum, 4);
          l[h] = l[h] * alpha + sum;
          m[h] = mn;
#pragma unroll
          for (int k = 0; k < CPL; ++k) acc[h][k] *= alpha;
          p[h] = pp;
        }
      }
      // P V: lane owns columns CPL*lane ..; slot j2's p comes from lane j2
#pragma unroll
      for (int j2 = 0; j2 < 8; ++j2) {
        const int vr = warp * 8 + j2;
        const int e0 = CPL * lane;
        const T* vrow = reinterpret_cast<const T*>(
            tv + chunk_off<CH>(vr, e0 / EPC)) + e0 % EPC;
        float vf[CPL];
#pragma unroll
        for (int k = 0; k < CPL; ++k) vf[k] = to_float(vrow[k]);
#pragma unroll
        for (int h = 0; h < R; ++h) {
          if (h < rep) {
            const float pj = __shfl_sync(kFull, p[h], j2);
#pragma unroll
            for (int k = 0; k < CPL; ++k)
              acc[h][k] = fmaf(pj, vf[k], acc[h][k]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();     // every warp is done with the ring: merge scratch
    float* accs = reinterpret_cast<float*>(smem);   // [kWarps][kMaxRep][D]
#pragma unroll
    for (int h = 0; h < R; ++h) {
      if (h < rep) {
#pragma unroll
        for (int k = 0; k < CPL; ++k)
          accs[(warp * kMaxRep + h) * D + CPL * lane + k] = acc[h][k];
        if (lane == 0) {
          ms[warp][h] = m[h];
          ls[warp][h] = l[h];
        }
      }
    }
    __syncthreads();
    // the split's (max, sum) of head h and its P V at column d, from the
    // warps' states
    auto split_state = [&](int h, int d, float& M, float& L) {
      M = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ms[w][h]);
      L = 0.f;
      float A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(ms[w][h] - M);
        L += ls[w][h] * e;
        A += accs[(w * kMaxRep + h) * D + d] * e;
      }
      return A;
    };
    if (nsplit == 1) {                         // uniform over the block
      for (int u = tid; u < rep * D; u += kDecThreads) {
        const int h = u / D, d = u % D;
        float M, L;
        const float A = split_state(h, d, M, L);
        store(out + ((int64_t)t * a.N + kh * rep + h) * D + d,
              A / (L == 0.f ? 1.f : L));
      }
      continue;
    }
    // a split of a longer row: its fp32 partials, then the last split of
    // the (row, kv head) to arrive merges them all
    for (int u = tid; u < rep * D; u += kDecThreads) {
      const int h = u / D, d = u % D;
      float M, L;
      const float A = split_state(h, d, M, L);
      const int64_t pi = ((int64_t)i * a.N + kh * rep + h) * a.S + s;
      a.part_acc[pi * D + d] = A;
      if (d == 0) a.part_ml[pi] = make_float2(M, L);
    }
    __threadfence();     // the partials are visible device-wide ...
    __syncthreads();
    int* sem = a.sem + (int64_t)i * a.K + kh;
    if (tid == 0) s_last = atomicAdd(sem, 1) == nsplit - 1;   // ... before
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    for (int u = tid; u < rep * D; u += kDecThreads) {
      const int h = u / D, d = u % D;
      const int64_t p0 = ((int64_t)i * a.N + kh * rep + h) * a.S;
      float M = kNegInf;
      for (int sp = 0; sp < nsplit; ++sp)
        M = fmaxf(M, __ldcg(&a.part_ml[p0 + sp]).x);
      float L = 0.f, A = 0.f;
      // L2 reads (__ldcg): other blocks wrote them
      for (int sp = 0; sp < nsplit; ++sp) {
        const float2 ml = __ldcg(&a.part_ml[p0 + sp]);
        const float e = expf(ml.x - M);
        L += ml.y * e;
        A += __ldcg(&a.part_acc[(p0 + sp) * D + d]) * e;
      }
      store(out + ((int64_t)t * a.N + kh * rep + h) * D + d,
            A / (L == 0.f ? 1.f : L));
    }
    if (tid == 0) *sem = 0;                    // ready for the next launch
  }
}

// ------------------------------------------------------------------------ //
// prefill (bf16, tensor cores)
// ------------------------------------------------------------------------ //
constexpr int kBQ = 64;            // query-head rows a block (4 warps x 16)
constexpr int kBKV = 64;           // slots a kv tile
constexpr int kPreThreads = kBQ / 16 * 32;
constexpr float kLog2e = 1.4426950408889634f;

struct PrefillArgs {
  const dstpu_tc::bf16* q;
  const dstpu_tc::bf16* kpool;
  const dstpu_tc::bf16* vpool;
  const int* tables;
  const int* lengths;
  const int* tile_start;   // first row of each plan tile
  const int* tile_rows;    // its rows (<= kBQ)
  const int* n_tiles;      // tiles in use (device)
  dstpu_tc::bf16* out;
  int N, K, bs, MB;
  float scale;
};

// rows of a plan tile a prefill block takes, and the blocks (grid z) that
// cover a tile of kBQ rows (ops/paged_attention.py prefill_blocks)
__host__ __device__ constexpr int pre_rows(int rep) { return kBQ / rep; }
__host__ __device__ constexpr int pre_blocks(int rep) {
  return (kBQ + pre_rows(rep) - 1) / pre_rows(rep);
}

template <int D>
constexpr int pre_smem_bytes() {
  return (kBQ * D + 4 * kBKV * D) * 2;    // Q, K x 2 stages, V x 2 stages
}

template <int D>
__global__ void __launch_bounds__(kPreThreads)
paged_attention_prefill_kernel_mma(PrefillArgs a) {
  using namespace dstpu_tc;
  constexpr int NT = kPreThreads;
  constexpr int KD = D / 16, NB = kBKV / 8, DB = D / 8, CH = D / 8;
  constexpr uint32_t kKV = kBKV * D * 2;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __shared__ int s_len[kBQ];
  const uint32_t sQ = smem_u32(tc_smem), sK = sQ + kBQ * D * 2,
                 sV = sK + 2 * kKV;

  const int x = blockIdx.x, kh = blockIdx.y;
  if (x >= *a.n_tiles) return;
  const int rep = a.N / a.K, per = pre_rows(rep);  // rows a block
  const int r0 = blockIdx.z * per;
  const int nrows = min(per, a.tile_rows[x] - r0);
  if (nrows <= 0) return;
  const int t0 = a.tile_start[x] + r0, nm = nrows * rep;  // M rows in use
  const int cap = a.MB * a.bs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = lane & 3, g = lane >> 2;
  const Lanes ln(lane);

  if (tid < kBQ) {
    s_len[tid] = tid < nrows ? min(max(a.lengths[t0 + tid], 0), cap) : 0;
  }
  // Q rows m = (row m / rep, head kh * rep + m % rep)
  for (int u = tid; u < kBQ * CH; u += NT) {
    const int mrow = u / CH, c = u % CH;
    const bool ok = mrow < nm;
    const int64_t off = ok ? ((int64_t)(t0 + mrow / rep) * a.N + kh * rep +
                              mrow % rep) * D + c * 8
                           : 0;
    cp_async16(sQ + swz<D>(mrow, c), a.q + off, ok);
  }
  __syncthreads();
  int kv_end = 0, kv_min = cap;
  for (int rr = 0; rr < nrows; ++rr) {
    kv_end = max(kv_end, s_len[rr]);
    kv_min = min(kv_min, s_len[rr]);
  }
  const int ma = 16 * warp + g, mb = ma + 8;       // this thread's rows
  const int len_a = ma < nm ? s_len[ma / rep] : 0;
  const int len_b = mb < nm ? s_len[mb / rep] : 0;
  const bool active = 16 * warp < nm;

  // every row of the tile shares this table row (the plan's run)
  const int* table = a.tables + (int64_t)t0 * a.MB;
  const int64_t slot_stride = (int64_t)a.K * D;
  // the table entries are all read before the first copy (independent
  // loads, one latency a tile)
  auto issue = [&](int c0, int st) {
    constexpr int kPer = kBKV * CH / NT;            // chunks a thread
    int64_t off[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int u = tid + k * NT, slot = c0 + u / CH;
      off[k] = slot < kv_end
                   ? ((int64_t)__ldg(table + slot / a.bs) * a.bs +
                      slot % a.bs) * slot_stride + (int64_t)kh * D +
                         (u % CH) * 8
                   : -1;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int u = tid + k * NT, rr = u / CH, c = u % CH;
      const bool ok = off[k] >= 0;
      cp_async16(sK + st * kKV + swz<D>(rr, c), a.kpool + (ok ? off[k] : 0),
                 ok);
      cp_async16(sV + st * kKV + swz<D>(rr, c), a.vpool + (ok ? off[k] : 0),
                 ok);
    }
  };
  if (kv_end > 0) issue(0, 0);
  cp_async_commit();

  const float c2 = a.scale * kLog2e;   // scores in base-2 units
  float m[2] = {kNegInf, kNegInf};     // running max of rows ma, mb
  float l[2] = {0.f, 0.f};             // this thread's part of the row sums
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[KD][4];
  int stage = 0;
  for (int c0 = 0; c0 < kv_end; c0 += kBKV) {
    cp_async_wait_all();
    __syncthreads();     // tile c0 landed; the other stage is free
    if (c0 == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm4(qf[kk], sQ + swz<D>(16 * warp + ln.a_row, 2 * kk + ln.a_ch));
    }
    if (c0 + kBKV < kv_end) issue(c0 + kBKV, stage ^ 1);
    cp_async_commit();
    if (active) {
      const uint32_t tK = sK + stage * kKV, tV = sV + stage * kKV;
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int j2 = 0; j2 < NB / 2; ++j2) {
          uint32_t bk[4];
          ldsm4(bk, tK + swz<D>(16 * j2 + ln.bn_row, 2 * kk + ln.bn_ch));
          mma(s[2 * j2], qf[kk], bk[0], bk[1]);
          mma(s[2 * j2 + 1], qf[kk], bk[2], bk[3]);
        }
      }
      // per-row mask: slot < lengths[row]; a masked slot gets p = 0
      if (c0 + kBKV > kv_min) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * j + 2 * tq + (e & 1);
            if (col >= ((e >> 1) ? len_b : len_a)) s[j][e] = -INFINITY;
          }
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
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i] * c2);
        alpha[i] = exp2_approx(m[i] - mn);
        m[i] = mn;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        acc[j][0] *= alpha[0], acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1], acc[j][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        s[j][0] = exp2_approx(fmaf(s[j][0], c2, -m[0]));
        s[j][1] = exp2_approx(fmaf(s[j][1], c2, -m[0]));
        s[j][2] = exp2_approx(fmaf(s[j][2], c2, -m[1]));
        s[j][3] = exp2_approx(fmaf(s[j][3], c2, -m[1]));
        l[0] += s[j][0] + s[j][1];
        l[1] += s[j][2] + s[j][3];
      }
      // O += P V: P (bf16, registers) is the A fragment, V through .trans
#pragma unroll
      for (int k2 = 0; k2 < kBKV / 16; ++k2) {
        uint32_t af[4];
        a_from_c(af, s[2 * k2], s[2 * k2 + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          ldsm4_t(bv, tV + swz<D>(16 * k2 + ln.bt_row, 2 * dp + ln.bt_ch));
          mma(acc[2 * dp], af, bv[0], bv[1]);
          mma(acc[2 * dp + 1], af, bv[2], bv[3]);
        }
      }
    }
    stage ^= 1;
  }
  cp_async_wait_all();   // no copy in flight into the Q tile reused below
  __syncthreads();

  float f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    f[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
  }
  // fragments → the warp's own 16 rows of the Q tile (bf16) → 16-byte
  // stores to out[row, head]
#pragma unroll
  for (int j = 0; j < DB; ++j) {
    *reinterpret_cast<uint32_t*>(tc_smem + swz<D>(ma, j) + 4 * tq) =
        pack_bf16(acc[j][0] * f[0], acc[j][1] * f[0]);
    *reinterpret_cast<uint32_t*>(tc_smem + swz<D>(mb, j) + 4 * tq) =
        pack_bf16(acc[j][2] * f[1], acc[j][3] * f[1]);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 16 * CH / 32; ++k) {
    const int u = lane + 32 * k, rr = u / CH, c = u % CH;
    const int mrow = 16 * warp + rr;
    if (mrow < nm) {
      *reinterpret_cast<uint4*>(
          a.out + ((int64_t)(t0 + mrow / rep) * a.N + kh * rep + mrow % rep) *
                      D + c * 8) =
          *reinterpret_cast<const uint4*>(tc_smem + swz<D>(mrow, c));
    }
  }
}

// ------------------------------------------------------------------------ //
// the plan (one block a tick)
// ------------------------------------------------------------------------ //
constexpr int kPlanThreads = 1024;

// inclusive prefix sum of v over the block; *total gets the block's sum.
// Every thread of the block calls it.
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[kPlanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int out = v + (warp ? warp_sums[warp - 1] : 0);
  *total = warp_sums[kPlanThreads / 32 - 1];
  __syncthreads();       // warp_sums is free for the next call
  return out;
}

struct PlanArgs {
  const int* tables;    // [T, MB]
  int* run_id;          // [T] scratch
  int* run_start;       // [T + 1] scratch
  int* dec_rows;        // [T]
  int* counts;          // [2]: decode rows, prefill tiles
  int* tile_start;      // [TM]
  int* tile_rows;       // [TM]
  int T, MB, TM, min_run, tile;
};

// build_plan (ops/paged_attention.py) in one block: rows t and t-1 are one
// run exactly when their table rows are equal; runs of at least min_run
// rows are cut into tiles of `tile` rows, the other rows are decode rows;
// both lists in row order, zero past their counts.
__global__ void __launch_bounds__(kPlanThreads)
paged_attention_plan_kernel(PlanArgs a) {
  const int tid = threadIdx.x;
  int runs = 0;             // runs before this chunk
  for (int c0 = 0; c0 < a.T; c0 += kPlanThreads) {
    const int t = c0 + tid;
    int start = 0;
    if (t < a.T) {
      const int* row = a.tables + (int64_t)t * a.MB;
      int diff = t == 0;
      if (t > 0) {          // independent loads: no early exit to wait on
#pragma unroll 8
        for (int j = 0; j < a.MB; ++j) diff |= row[j] ^ row[j - a.MB];
      }
      start = diff != 0;
    }
    int total;
    const int id = runs + block_scan(start, &total) - 1;
    if (t < a.T) {
      a.run_id[t] = id;
      if (start) a.run_start[id] = t;
    }
    runs += total;
  }
  if (tid == 0) a.run_start[runs] = a.T;
  __syncthreads();
  int n_dec = 0, n_tiles = 0;
  for (int c0 = 0; c0 < a.T; c0 += kPlanThreads) {
    const int t = c0 + tid;
    int dec = 0, head = 0, len = 0, pos = 0;
    if (t < a.T) {
      const int id = a.run_id[t];
      head = a.run_start[id];
      len = a.run_start[id + 1] - head;
      pos = t - head;
      dec = len < a.min_run;
    }
    const int is_tile = t < a.T && !dec && pos % a.tile == 0;
    int dec_total, tile_total;
    const int di = n_dec + block_scan(dec, &dec_total) - 1;
    const int ti = n_tiles + block_scan(is_tile, &tile_total) - 1;
    if (dec) a.dec_rows[di] = t;
    if (is_tile) {
      a.tile_start[ti] = t;
      a.tile_rows[ti] = min(a.tile, len - pos);
    }
    n_dec += dec_total;
    n_tiles += tile_total;
  }
  for (int i = n_dec + tid; i < a.T; i += kPlanThreads) a.dec_rows[i] = 0;
  for (int i = n_tiles + tid; i < a.TM; i += kPlanThreads) {
    a.tile_start[i] = 0;
    a.tile_rows[i] = 0;
  }
  if (tid == 0) {
    a.counts[0] = n_dec;
    a.counts[1] = n_tiles;
  }
}

// ------------------------------------------------------------------------ //
// launches
// ------------------------------------------------------------------------ //
template <typename Kernel>
int opt_in(Kernel* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D, int R>
int decode(const DecodeArgs& a, int grid_rows, cudaStream_t stream) {
  const int bytes = dec_smem_bytes<T, D>();
  // opt in above 48 KB once per instantiation (a function static)
  static const int err =
      opt_in(paged_attention_decode_kernel<T, D, R>, bytes);
  if (err) return err;
  paged_attention_decode_kernel<T, D, R>
      <<<dim3(grid_rows, a.K, a.S), kDecThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int prefill(const PrefillArgs& a, int tiles, cudaStream_t stream) {
  const int bytes = pre_smem_bytes<D>();
  static const int err = opt_in(paged_attention_prefill_kernel_mma<D>, bytes);
  if (err) return err;
  paged_attention_prefill_kernel_mma<D>
      <<<dim3(tiles, a.K, pre_blocks(a.N / a.K)), kPreThreads, bytes,
         stream>>>(a);
  return (int)cudaGetLastError();
}

// the decode kernel for rep = N / K rounded up to 1, 2, 4 or 8
template <typename T, int D>
int decode_rep(const DecodeArgs& a, int g, cudaStream_t s) {
  const int rep = a.N / a.K;
  return rep <= 1   ? decode<T, D, 1>(a, g, s)
         : rep <= 2 ? decode<T, D, 2>(a, g, s)
         : rep <= 4 ? decode<T, D, 4>(a, g, s)
                    : decode<T, D, 8>(a, g, s);
}

int decode_any(int dtype, int D, const DecodeArgs& a, int g,
               cudaStream_t s) {
  if (dtype == 0 && D == 64) return decode_rep<float, 64>(a, g, s);
  if (dtype == 0 && D == 128) return decode_rep<float, 128>(a, g, s);
  if (dtype == 1 && D == 64) return decode_rep<__nv_bfloat16, 64>(a, g, s);
  if (dtype == 1 && D == 128) return decode_rep<__nv_bfloat16, 128>(a, g, s);
  return (int)cudaErrorInvalidValue;
}

bool valid_heads(int N, int K) {
  return K > 0 && N % K == 0 && N / K <= kMaxRep;
}

DecodeArgs decode_args(const void* q, const void* kpool, const void* vpool,
                       const void* tables, const void* lengths,
                       const void* rows, const void* n_rows, void* out,
                       void* part_acc, void* part_ml, void* sem, int T,
                       int N, int K, int D, int bs, int MB, int S,
                       int split) {
  DecodeArgs a;
  a.q = q, a.kpool = kpool, a.vpool = vpool;
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.rows = static_cast<const int*>(rows);
  a.n_rows = static_cast<const int*>(n_rows);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float2*>(part_ml);
  a.sem = static_cast<int*>(sem);
  a.T = T, a.N = N, a.K = K, a.bs = bs, a.MB = MB, a.S = S, a.split = split;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  return a;
}

}  // namespace

// A plan is one int32 buffer (ops/paged_attention.py PagedPlan): the
// decode rows [T], their count, the prefill tiles' count, tile_start [TM],
// tile_rows [TM], then the plan kernel's scratch [2 T + 1].
struct PlanLayout {
  int* base;
  int T, TM;
  int* dec_rows() const { return base; }
  int* n_dec() const { return base + T; }
  int* n_tiles() const { return base + T + 1; }
  int* tile_start() const { return base + T + 2; }
  int* tile_rows() const { return base + T + 2 + TM; }
  int* scratch() const { return base + T + 2 + 2 * TM; }
};

// Paged attention of a tick. Shapes: q/out [T, N, D], pools [NB, bs, K, D]
// (contiguous, 16-byte aligned), tables [T, MB] int32, lengths [T] int32;
// dtype 0 = float32, 1 = bfloat16. plan: the tick's plan buffer (tiles TM,
// bf16 only), or null: every row is then a decode row (fp32, or a tick of
// fewer rows than a run needs). The decode kernel takes the decode rows,
// split by `split` slots into S = ceil(MB * bs / split) splits, grid
// (grid_rows, K, S); part [T, N, S, D + 2] fp32 takes the partials of rows
// with more than one split; sem [T, K] int32 is zero at the launch and
// again after it. With a plan, the prefill kernel then takes its tiles,
// grid (TM, K, pre_blocks(rep)). Returns a cudaError_t (0 = launched).
extern "C" int dstpu_paged_attention(const void* q, const void* kpool,
                                     const void* vpool, const void* tables,
                                     const void* lengths, void* plan,
                                     void* out, void* part, void* sem, int T,
                                     int N, int K, int D, int bs, int MB,
                                     int S, int split, int grid_rows, int TM,
                                     int dtype, void* stream) {
  if (T <= 0) return 0;
  if (!valid_heads(N, K) || bs <= 0 || MB <= 0 || split <= 0 ||
      grid_rows <= 0 || (int64_t)S * split < (int64_t)MB * bs ||
      (plan != nullptr && (TM <= 0 || dtype != 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const PlanLayout pl{static_cast<int*>(plan), T, TM};
  float* part_acc = static_cast<float*>(part);
  const DecodeArgs a = decode_args(
      q, kpool, vpool, tables, lengths, plan ? pl.dec_rows() : nullptr,
      plan ? pl.n_dec() : nullptr, out, part_acc,
      part_acc + (int64_t)T * N * S * D, sem, T, N, K, D, bs, MB, S, split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = decode_any(dtype, D, a, grid_rows, s);
  if (err || plan == nullptr) return err;
  PrefillArgs p;
  p.q = static_cast<const dstpu_tc::bf16*>(q);
  p.kpool = static_cast<const dstpu_tc::bf16*>(kpool);
  p.vpool = static_cast<const dstpu_tc::bf16*>(vpool);
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.tile_start = pl.tile_start();
  p.tile_rows = pl.tile_rows();
  p.n_tiles = pl.n_tiles();
  p.out = static_cast<dstpu_tc::bf16*>(out);
  p.N = N, p.K = K, p.bs = bs, p.MB = MB;
  p.scale = a.scale;
  if (D == 64) return prefill<64>(p, TM, s);
  return prefill<128>(p, TM, s);
}

// The plan of a tick (ops/paged_attention.py build_plan) from tables
// [T, MB] into the plan buffer (tiles TM). One block.
extern "C" int dstpu_paged_plan(const void* tables, void* plan, int T, int MB,
                                int TM, int min_run, int tile, void* stream) {
  if (T <= 0) return 0;
  if (MB <= 0 || TM <= 0 || min_run <= 0 || tile <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const PlanLayout pl{static_cast<int*>(plan), T, TM};
  PlanArgs a;
  a.tables = static_cast<const int*>(tables);
  a.run_id = pl.scratch();
  a.run_start = a.run_id + T;
  a.dec_rows = pl.dec_rows();
  a.counts = pl.n_dec();          // n_dec, then n_tiles
  a.tile_start = pl.tile_start();
  a.tile_rows = pl.tile_rows();
  a.T = T, a.MB = MB, a.TM = TM, a.min_run = min_run, a.tile = tile;
  paged_attention_plan_kernel<<<1, kPlanThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// rows a prefill tile may hold (the plan's tile size)
extern "C" int dstpu_paged_tile_rows() { return kBQ; }

// prefill blocks (grid z) that cover a tile at this rep
extern "C" int dstpu_paged_prefill_blocks(int rep) {
  return rep > 0 && rep <= kMaxRep ? pre_blocks(rep) : -1;
}

// dynamic shared memory of a launch: kernel 0 decode, 1 prefill (bf16
// only); -1 for none
extern "C" int dstpu_paged_smem_bytes(int kernel, int bf16, int D) {
  if (D != 64 && D != 128) return -1;
  if (kernel == 0) {
    if (bf16) return D == 64 ? dec_smem_bytes<__nv_bfloat16, 64>()
                             : dec_smem_bytes<__nv_bfloat16, 128>();
    return D == 64 ? dec_smem_bytes<float, 64>() : dec_smem_bytes<float, 128>();
  }
  if (kernel == 1 && bf16) {
    return D == 64 ? pre_smem_bytes<64>() : pre_smem_bytes<128>();
  }
  return -1;
}
