// The exact search scan of topk_hamming.cu and encode_search.cu (sm_90a):
// per (query block, bank split) the k best rows of the split by (score
// desc, row asc), into the split's candidate slots; hd::launch_merge folds
// the splits. Rows at or past num_valid score INT_MIN but stay candidates.
//
// Which scan runs (launch_exact_scan), by the bank's mode and the query
// block:
// * packed banks (mode 0, the served layout) in 16- or 32-query blocks
//   score on the int8 tensor cores (mma::scan_kernel below);
// * packed banks in 8-query blocks (the plan's block for batches of 8 or
//   fewer) keep hd::scan_rows on the POPC pipe (tile_scan_kernel below):
//   with the bank on the M side the wgmma count does not shrink with the
//   batch, and at 4 or 8 queries the POPC scan was the faster (PERF.md);
// * int8 banks (mode 1, unpacked rows such as D = 1000) keep hd::scan_rows
//   on __dp4a: their rows need not be 4-byte aligned, and no served path
//   uses them.
// The banded kernels have their own bank-major scan (hd_banded_scan.cuh).
//
// Bound on the H100: bytes. At Q = 32 against the iPRG2012-scale bank
// (1,162,392 rows, 256 words) the bank read is 1.19 GB, 0.355 ms at
// 3.35 TB/s; the +-1 products are 609 G int8 operations, 0.31 ms at
// 1,979 TOP/s.
//
// The score as a dot product. With bank bits b and query bits c of the
// staged words, popcount(q ^ r) = pc + pb - 2 sum(b c), where pc = popcount
// of the query's words. The bank side enters the tensor cores as the bytes
// -128 b (0x80 or 0) and the query side as +-1 bytes (2c - 1), so the int32
// sum is acc = -128 sum(b (2c - 1)) = -128 (2 sum(b c) - pb), and
//   dim - 2 popcount(q ^ r) = dim - 2 pc - acc / 64,
// exact (acc is a multiple of 128, |acc| < 2^31 for W < 2^19 words). The
// padding bits inside the last word count as the plain version counts
// them; words staged past W are 0 in the bank, so add nothing. A bank
// byte costs one multiply (a shift by a per-thread power of two, on the
// FMA pipe) and one AND; the +-1 form of both operands (as in
// hamming_pop.cu) costs a shift, an AND and a multiply-add per register.
//
// Design of the tensor-core scan. A block of four warpgroups (512 threads)
// owns N = 16 or 32 queries and one split of the bank, which it walks in
// steps of 256 rows (64 per warpgroup, the M side of
// wgmma.m64nNk32.s32.s8.s8). Packed words
// of the step's rows and of the block's queries stream through a
// two-stage cp.async ring, 32 words (128 bytes of a row) a stage; the bank
// is read once and stays packed (1/8 of the +-1 bytes). Each stage's
// query words are expanded once, by the whole block, to +-1 in shared
// memory in the no-swizzle K-major layout the B descriptor reads (two
// buffers); the expanded queries are N x 1 KB a stage (32 KB at N = 32):
// the whole (N, D) +-1 block (256 KB at N = 32, D = 8192) would not fit
// in shared memory, and expanding it stage by stage costs N / 256 of the
// bank's expansion. Each warp expands its 16 bank rows straight into A
// register fragments, 4 k-steps a commit group, two fragment sets in turn.
// k-slot s of a word (4 bytes) holds bits s, s + 8, s + 16, s + 24 on both
// sides. At the end of a step each warpgroup writes its 64 x N scores to
// a shared tile, and one warp per query offers the step's rows to that
// query's list (hd::warp_offer, whose ballot tests each row against the
// list's current k-th (value, row) first). A warpgroup whose 64 rows lie
// past the split's end (the bank's last rows, or a split off the 256-row
// step) still runs its wgmmas, on zero words: a branch on the warpgroup
// makes ptxas serialize the wgmmas. The order is total, so any split of
// the bank gives the same top-k.
//
// What sets the time on the H100 (PERF.md): with the bank on M, the wgmma
// count is fixed at R / 64 x W x ceil(Q / N), and a small-N wgmma does
// not reach the int8 peak (about 31 clocks for m64n32k32 against 16 at
// peak, with A from registers or from shared memory alike). That tensor
// time, the bank expansion, the staging and the two block barriers of a
// stage add up rather than overlap.
#pragma once

#include "hd_common.cuh"
#include "sm90.cuh"

namespace hd {

// One block of BQ = 8 * QPT queries against one bank split on
// hd::scan_rows (MODE kPacked: the POPC pipe; kInt8: __dp4a).
template <int MODE, int QPT>
__global__ void __launch_bounds__(kThreads)
    tile_scan_kernel(const unsigned char* __restrict__ q,
                     const unsigned char* __restrict__ r, int Q, int R,
                     int row_bytes, int wpr, int qstride, int dim, int k,
                     int num_valid, int rows_per_split, int splits, int* cv,
                     int* ci) {
  constexpr int BQ = kWarps * QPT;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qs = smem;
  uint32_t* rt = qs + BQ * qstride;
  int* lv = reinterpret_cast<int*>(rt + kTileWords);
  int* li = lv + BQ * k;

  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Q - q0);
  const int split = blockIdx.y;
  load_queries(q, q0, nq, BQ, row_bytes, wpr, qstride, qs);
  list_init(lv, li, BQ * k, k, R);
  __syncthreads();

  const int row_begin = split * rows_per_split;
  const int row_end = min(R, row_begin + rows_per_split);
  scan_rows<MODE, QPT>(qs, qstride, nq, r, row_bytes, wpr, row_begin,
                       row_end, num_valid, dim, rt, lv, li, k);
  write_candidates<QPT>(lv, li, k, q0, nq, split, splits, cv, ci);
}

template <int MODE, int QPT>
cudaError_t launch_tiles(const void* q, const void* r, int Q, int R,
                         int row_bytes, int wpr, int qstride, int dim, int k,
                         int num_valid, int rows_per_split, int splits,
                         int* cv, int* ci, cudaStream_t stream) {
  constexpr int BQ = kWarps * QPT;
  const size_t smem = sizeof(uint32_t) *
                      (static_cast<size_t>(BQ) * qstride + kTileWords +
                       2 * static_cast<size_t>(BQ) * k);
  cudaError_t err = cudaFuncSetAttribute(
      tile_scan_kernel<MODE, QPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Q + BQ - 1) / BQ, splits);
  tile_scan_kernel<MODE, QPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(q),
      static_cast<const unsigned char*>(r), Q, R, row_bytes, wpr, qstride, dim,
      k, num_valid, rows_per_split, splits, cv, ci);
  return cudaGetLastError();
}

namespace mma {

constexpr int kGroups = 4;                 // warpgroups a block
constexpr int kThreads = 128 * kGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 64;                  // bank rows of one wgmma (M)
constexpr int kRows = kStep * kGroups;     // bank rows a block scores a step
constexpr int kChunk = 32;                 // words of a row a ring stage holds
constexpr int kStride = kChunk + 4;        // shared row stride in words:
                                           // 16-byte aligned; 8 rows' 16-byte
                                           // loads hit distinct banks
constexpr int kStages = 2;                 // depth of the cp.async ring
constexpr int kGroupK = 4;                 // k-steps (words) a commit group
constexpr int kFragBufs = 2;               // fragment sets in turn
constexpr int kTileStride = kRows + 4;     // score tile: one query's row

// Bytes of shared memory of an N-query block with k-slot lists.
inline size_t smem_bytes(int N, int k) {
  return static_cast<size_t>(2 * kChunk * N * 32) +
         sizeof(int) * (static_cast<size_t>(kStages) * (kRows + N) * kStride +
                        static_cast<size_t>(N) * kTileStride + N +
                        2 * static_cast<size_t>(N) * k);
}

// wgmma.m64nNk32.s32.s8.s8, A from registers, B from the descriptor,
// accumulating into acc
__device__ __forceinline__ void wgmma(int (&acc)[8], const uint32_t (&a)[4],
                                      uint64_t d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p;\n}\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(d), "r"(1));
}

__device__ __forceinline__ void wgmma(int (&acc)[16], const uint32_t (&a)[4],
                                      uint64_t d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p;\n}\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
        "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(acc[12]), "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(d), "r"(1));
}

// Bank words xg, xh of fragment rows g and g + 8 -> the A fragment of one
// k-step: bytes 0x80 where a bit is set (int8 -128), else 0; m_lo and m_hi
// are 2^(7 - tig) and 2^(3 - tig), which move bits tig + 8j and
// tig + 4 + 8j to bit 7 of byte j (k-slots tig and 4 + tig).
__device__ __forceinline__ void bank_fragment(uint32_t (&a)[4], uint32_t xg,
                                              uint32_t xh, uint32_t m_lo,
                                              uint32_t m_hi) {
  a[0] = (xg * m_lo) & 0x80808080u;
  a[1] = (xh * m_lo) & 0x80808080u;
  a[2] = (xg * m_hi) & 0x80808080u;
  a[3] = (xh * m_hi) & 0x80808080u;
}

// Block (query block x, split y): N queries against bank rows
// [y * rows_per_split, (y + 1) * rows_per_split) of a packed (R, W) bank.
template <int N, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    scan_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ r,
                int Q, int R, int W, int dim, int k, int num_valid,
                int rows_per_split, int splits, int* cv, int* ci) {
  static_assert(N == 16 || N == 32, "16- or 32-query blocks");
  constexpr int kRing = (kRows + N) * kStride;  // words of one ring stage
  constexpr int kKStep = N * 32;                // bytes of one expanded k-step
  constexpr int kExp = kChunk * kKStep;         // bytes of one expanded stage
  extern __shared__ __align__(128) unsigned char smem[];
  // [2][kChunk][N / 8][2][8][16 B] expanded queries, then the packed ring
  // [kStages][kRows + N][kStride], the score tile [N][kTileStride], the
  // queries' popcounts and the lists
  unsigned char* qexp = smem;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + 2 * kExp);
  int* tile = reinterpret_cast<int*>(ring + kStages * kRing);
  int* pc = tile + N * kTileStride;
  int* lv = pc + N;
  int* li = lv + N * k;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2;     // fragment row
  const int tig = lane & 3;    // k-slots tig and 4 + tig
  const int q0 = blockIdx.x * N;
  const int nq = min(N, Q - q0);
  const long long begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const int row_begin = static_cast<int>(begin < R ? begin : R);
  const int row_end = min(R, row_begin + rows_per_split);
  const int n_chunks = (W + kChunk - 1) / kChunk;
  const int n_steps = (row_end - row_begin + kRows - 1) / kRows;
  const int total = n_steps * n_chunks;

  list_init(lv, li, N * k, k, R);
  for (int n = warp; n < N; n += kWarps) {
    int c = 0;
    if (n < nq)
      for (int w = lane; w < W; w += 32)
        c += __popc(q[static_cast<size_t>(q0 + n) * W + w]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if (lane == 0) pc[n] = c;
  }

  // flat iteration it = (step it / n_chunks, chunk it % n_chunks)
  auto stage = [&](int it) {
    const int st = it / n_chunks;
    const int w0 = (it - st * n_chunks) * kChunk;
    uint32_t* s = ring + (it % kStages) * kRing;
    sm90::stage_rows<VEC, kThreads, kChunk, kStride>(
        r, row_end, W, row_begin + st * kRows, kRows, w0, s);
    sm90::stage_rows<VEC, kThreads, kChunk, kStride>(q, Q, W, q0, N, w0,
                                                     s + kRows * kStride);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) stage(s);
    sm90::cp_async_commit();
  }

  const uint32_t m_lo = 1u << (7 - tig);
  const uint32_t m_hi = 1u << (3 - tig);
  const int frow = wg * kStep + (warp & 3) * 16 + g;  // fragment row g
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  uint32_t frag[kFragBufs][kGroupK][4] = {};
  sm90::fence_regs(acc);

  // step st of the split, ring stage it = st * n_chunks + chunk
  for (int st = 0; st < n_steps; ++st) {
    const int step0 = row_begin + st * kRows;
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int it = st * n_chunks + chunk;
      sm90::cp_async_wait<kStages - 2>();
      // stage it has landed; every thread is done with stage it - 1's words,
      // and every warpgroup's wgmmas of stage it - 2 are done
      __syncthreads();
      if (it + kStages - 1 < total) stage(it + kStages - 1);
      sm90::cp_async_commit();

      const uint32_t* rs = ring + (it % kStages) * kRing;
      unsigned char* xq = qexp + (it & 1) * kExp;
      for (int e = threadIdx.x; e < kChunk * N; e += kThreads) {
        const int w = e / N;   // 8 neighbouring threads fill one 128-byte
        const int n = e - w * N;  // core matrix
        uint4 lo, hi;
        sm90::expand_word(rs[(kRows + n) * kStride + w], lo, hi);
        unsigned char* p = xq + w * kKStep + (n >> 3) * 256 + (n & 7) * 16;
        *reinterpret_cast<uint4*>(p) = lo;
        *reinterpret_cast<uint4*>(p + 128) = hi;
      }
      sm90::fence_proxy_async();
      __syncthreads();

      // every warpgroup runs its wgmmas, also on rows past the split's end
      // (staged as 0, never offered): a branch on the warpgroup would make
      // ptxas serialize the wgmmas
      const uint32_t* rg = rs + frow * kStride;
      const unsigned eb = sm90::smem_u32(xq);
#pragma unroll
      for (int gr = 0; gr < kChunk / kGroupK; ++gr) {
        uint32_t (&a)[kGroupK][4] = frag[gr % kFragBufs];
#pragma unroll
        for (int v = 0; v < kGroupK; v += 4) {
          const int w = gr * kGroupK + v;
          const uint4 xg = *reinterpret_cast<const uint4*>(rg + w);
          const uint4 xh = *reinterpret_cast<const uint4*>(rg + 8 * kStride + w);
          bank_fragment(a[v], xg.x, xh.x, m_lo, m_hi);
          bank_fragment(a[v + 1], xg.y, xh.y, m_lo, m_hi);
          bank_fragment(a[v + 2], xg.z, xh.z, m_lo, m_hi);
          bank_fragment(a[v + 3], xg.w, xh.w, m_lo, m_hi);
        }
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kGroupK; ++kk)
          wgmma(acc, a[kk], sm90::desc(eb + (gr * kGroupK + kk) * kKStep));
        sm90::wgmma_commit();
        sm90::fence_regs(acc);
        // all but the last kFragBufs - 1 groups' wgmmas are done: the
        // fragments of the set written next may change
        sm90::wgmma_wait<kFragBufs - 1>();
#pragma unroll
        for (int kk = 0; kk < kGroupK; ++kk)
          sm90::fence_regs(frag[(gr + 1) % kFragBufs][kk]);
      }
    }

    // the step's scores: acc[4 j + 2 h + e] is bank row frow + 8 h,
    // query 8 j + 2 tig + e
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = frow + 8 * h;
          const int n = 8 * j + 2 * tig + e;
          int& a = acc[4 * j + 2 * h + e];
          tile[n * kTileStride + row] = step0 + row < num_valid
                                            ? dim - 2 * pc[n] - (a >> 6)
                                            : INT_MIN;
          a = 0;
        }
    sm90::fence_regs(acc);
    __syncthreads();
    // one warp per query offers the step's rows; the tile is rewritten
    // at the next step's end, behind the barriers of its stages
    for (int n = warp; n < nq; n += kWarps) {
      for (int r0 = 0; r0 < kRows && step0 + r0 < row_end; r0 += 32) {
        const int row = step0 + r0 + lane;
        warp_offer(lv + n * k, li + n * k, k, row < row_end,
                   tile[n * kTileStride + r0 + lane], row);
      }
    }
  }
  __syncthreads();  // the owner warps' lists are final
  for (int e = threadIdx.x; e < nq * k; e += kThreads) {
    const int n = e / k;
    const size_t at =
        (static_cast<size_t>(q0 + n) * splits + blockIdx.y) * k + (e - n * k);
    cv[at] = lv[e];
    ci[at] = li[e];
  }
}

template <int N>
cudaError_t launch(const uint32_t* q, const uint32_t* r, int Q, int R, int W,
                   int dim, int k, int num_valid, int rows_per_split,
                   int splits, int* cv, int* ci, cudaStream_t stream) {
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(r) % 16 == 0;
  auto kernel = vec ? scan_kernel<N, true> : scan_kernel<N, false>;
  const size_t smem = smem_bytes(N, k);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Q + N - 1) / N, splits);
  kernel<<<grid, kThreads, smem, stream>>>(q, r, Q, R, W, dim, k, num_valid,
                                           rows_per_split, splits, cv, ci);
  return cudaGetLastError();
}

}  // namespace mma

// The exact scan of q (Q rows) against r (R rows) of row_bytes bytes each
// (mode 0: packed words, wpr = W; mode 1: int8 lanes) into the (Q, splits,
// k) candidate buffers; bq in {8, 16, 32} queries a block. Returns the
// launch's CUDA error.
inline cudaError_t launch_exact_scan(const void* q, const void* r, int Q,
                                     int R, int row_bytes, int wpr,
                                     int qstride, int mode, int dim, int k,
                                     int num_valid, int bq,
                                     int rows_per_split, int splits, int* cv,
                                     int* ci, cudaStream_t s) {
  if (mode == kPacked && bq >= 16) {
    const uint32_t* qw = static_cast<const uint32_t*>(q);
    const uint32_t* rw = static_cast<const uint32_t*>(r);
#define HD_MMA(N)                                                          \
  mma::launch<N>(qw, rw, Q, R, wpr, dim, k, num_valid, rows_per_split,      \
                 splits, cv, ci, s)
    return bq == 32 ? HD_MMA(32) : HD_MMA(16);
#undef HD_MMA
  }
#define HD_TILES(MODE, QPT)                                                \
  launch_tiles<MODE, QPT>(q, r, Q, R, row_bytes, wpr, qstride, dim, k,      \
                          num_valid, rows_per_split, splits, cv, ci, s)
  if (mode == kPacked) return HD_TILES(kPacked, 1);
  return bq == 32   ? HD_TILES(kInt8, 4)
         : bq == 16 ? HD_TILES(kInt8, 2)
                    : HD_TILES(kInt8, 1);
#undef HD_TILES
}

}  // namespace hd
