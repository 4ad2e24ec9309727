// Hopper (sm_90a) primitives of the port's kernels: cp.async staging of
// packed words into shared memory, mbarriers and one-dimensional bulk
// copies (TMA), the bit -> +-1 byte expansion, the no-swizzle K-major
// wgmma descriptor and the register fences around asynchronous wgmmas.
// Included by hamming_pop.cu, hd_exact_scan.cuh and hd_banded_scan.cuh.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sm90 {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// valid == false writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + rows_n) of a (rows, W) word matrix, words
// [w0, w0 + CHUNK), into the shared tile s (row stride STRIDE words); rows
// at or past `rows` and words past W stage as 0. VEC: 16-byte copies
// (W % 4 == 0, the matrix on a 16-byte boundary, STRIDE % 4 == 0).
template <bool VEC, int THREADS, int CHUNK, int STRIDE>
__device__ __forceinline__ void stage_rows(const uint32_t* __restrict__ m,
                                           int rows, int W, int row0,
                                           int rows_n, int w0, uint32_t* s) {
  if (VEC) {
    constexpr int kQuads = CHUNK / 4;
    for (int e = threadIdx.x; e < rows_n * kQuads; e += THREADS) {
      const int row = e / kQuads;
      const int w = w0 + 4 * (e - row * kQuads);
      const bool ok = row0 + row < rows && w < W;  // W % 4 == 0
      cp_async16(s + row * STRIDE + (w - w0),
                 ok ? m + static_cast<size_t>(row0 + row) * W + w : m, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows_n * CHUNK; e += THREADS) {
      const int row = e / CHUNK;
      const int c = e - row * CHUNK;
      const bool ok = row0 + row < rows && w0 + c < W;
      cp_async4(s + row * STRIDE + c,
                ok ? m + static_cast<size_t>(row0 + row) * W + w0 + c : m,
                ok);
    }
  }
}

// mbarrier of `count` arrivals, made visible to the async proxy (the bulk
// copies that complete on it); the block must sync before using it
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on bar that also expects `bytes` of copies to complete on it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of bar with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One-dimensional bulk copy (TMA) of `bytes` (a multiple of 16, both ends
// on a 16-byte boundary) from global to shared memory, completing on bar.
// Orders the block's earlier generic accesses of dst before it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// bytes b in {0, 1} of the 4 k-slot bits -> int8 2b - 1
__device__ __forceinline__ uint32_t pm1(uint32_t x) {
  return (x & 0x01010101u) * 0xFFFFFF02u + 0xFFFFFFFFu;
}

// Word x expanded to 32 bytes of +-1 in the k-slot order: k-slot s (bytes
// 4s .. 4s + 3) holds bits s, s + 8, s + 16, s + 24. lo holds k-slots 0-3,
// hi k-slots 4-7 (the two 16-byte halves of one k = 32 step).
__device__ __forceinline__ void expand_word(uint32_t x, uint4& lo, uint4& hi) {
  lo.x = pm1(x);
  lo.y = pm1(x >> 1);
  lo.z = pm1(x >> 2);
  lo.w = pm1(x >> 3);
  hi.x = pm1(x >> 4);
  hi.y = pm1(x >> 5);
  hi.z = pm1(x >> 6);
  hi.w = pm1(x >> 7);
}

// shared-memory matrix descriptor: no swizzle, K-major core matrices of
// 8 rows x 16 bytes; the two 16-byte halves of a k-step 128 bytes apart
// (leading offset), successive 8-row groups 256 bytes apart (stride)
__device__ __forceinline__ uint64_t desc(unsigned addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// Pins registers for the compiler: no ordinary instruction may touch them
// across this point. Around wgmma accumulators it keeps ptxas from
// serializing the wgmmas; after a wait it keeps the register fragments of
// the wgmmas waited for alive until then.
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared memory written by ordinary stores, read next by wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace sm90
