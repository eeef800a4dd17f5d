// Warpgroup tensor-core helpers for Hopper (sm_90a only): shared-memory
// matrix descriptors with the 128-byte swizzle, the m64n128k16 bf16
// `wgmma.mma_async` with fp32 sums, its fence / commit / wait, `mbarrier`s,
// and 16-byte `cp.async` copies whose completion a stage's `mbarrier`
// tracks. Inline PTX, no library headers. Used by grouped_gemm.cu.
//
// Operand tiles in shared memory (PTX ISA, "Shared memory matrix layout",
// 128-byte swizzle; every region starts 1024-byte aligned):
//   K-major  (the contraction contiguous): rows of 128 bytes (64 bf16 of
//            the contraction), row r at r * 128, its 16-byte chunk c at
//            chunk c ^ (r & 7); 8-row groups 1024 bytes apart (SBO). A
//            k16 step moves the start address by 32 bytes.
//   MN-major (the output dim contiguous): 64-wide blocks of the output
//            dim, each a column of 128-byte rows, one row a contraction
//            index, swizzled as above; 8-row groups 1024 bytes apart
//            (SBO), neighbouring 64-wide blocks LBO bytes apart. A k16
//            step moves the start address by 16 rows, 2048 bytes.
// `wgmma` reads an MN-major operand with its transpose flag set, so each
// operand is copied as it lies in device memory: nothing is transposed in
// shared memory.
//
// Accumulators of m64nNk16 (fp32): warp w of the warpgroup owns rows
// 16 w .. 16 w + 15; lane l (g = l / 4, t = l % 4) holds, for each n8 block
// j, d[4j] = D[g][8j + 2t], d[4j+1] = D[g][8j + 2t + 1], d[4j+2] =
// D[g+8][8j + 2t], d[4j+3] = D[g+8][8j + 2t + 1].
#pragma once

#include <stdint.h>

namespace dstpu_wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of 128-byte row r in a swizzled region
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// matrix descriptor: start address, leading and stride byte offsets (16-
// byte units), base offset 0, layout type 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// every register and shared-memory write before it is seen by the wgmma
// after it (all four warps of the warpgroup)
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// at most N committed groups of this warpgroup still in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to the accumulators across a
// wgmma that is still writing them
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16) B (16 x 128); A, B bf16 in shared memory by descriptor;
// TA / TB: the operand is MN-major (1) or K-major (0)
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  const int scale_d = 1;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// ---- mbarriers (shared-memory addresses) ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// the inits are seen by every thread after the next block barrier
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one arrival on bar once every cp.async this thread has started has
// landed (counted in the barrier's expected arrivals: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// writes of the generic proxy (cp.async) made visible to this thread are
// seen by its async-proxy reads (wgmma's operand loads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global → shared, bypassing L1 (L2 fetches 128-byte lines);
// pred false zero-fills the 16 bytes and reads nothing, so src need not be
// a valid address then
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst),
      "l"(src), "r"(n)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace dstpu_wg
