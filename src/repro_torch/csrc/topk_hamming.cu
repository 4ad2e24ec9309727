// Streaming top-k Hamming search on Hopper (sm_90a), exact and banded.
//
// Replaces the TPU kernels src/repro/kernels/topk_hamming/topk_hamming.py
// _topk_kernel (launched by topk_hamming_pallas_call): per query the k best
// bank rows by (score desc, row asc), where a packed row scores
// dim - 2 * popcount(q ^ r) and an int8 row the integer dot <q, r>; rows at
// or past num_valid score INT_MIN but stay candidates. Only (Q, k) reaches
// device memory. And _topk_banded_kernel (topk_hamming_banded_pallas_call),
// the OMS twin: each query scores only the rows of its own [start, end)
// bands (one per bank block) of a precursor-sorted bank.
//
// Bound on the H100: bytes. The score is a +-1 dot product
// (dim - 2 * popcount(q ^ r) = <q, r>), which the int8 tensor cores compute
// exactly at 1,979 dense TOP/s: at Q = 32 against the iPRG2012-scale bank
// (1,162,392 rows, D = 8192) that is 0.31 ms, under the 0.36 ms it takes to
// read the 1.19 GB bank once at 3.35 TB/s. This design does not reach that
// bound: it scores on the POPC pipe (one XOR, one POPC, one add per
// query-row-word; POPC issues 16 per clock per SM), which caps it at about
// 2.3 ms at Q = 32. A tensor-core scan is the next step.
//
// Design. The TPU carries its running top-k across a sequential R grid
// axis; Hopper blocks run in no order, so the grid is 2-D (query blocks x
// bank splits) and a second kernel merges the splits. Within a block the
// query words stay in shared memory, bank rows stream through a padded
// shared tile in 16-byte coalesced loads (the next chunk is prefetched into
// registers while the current one is scored), and each thread scores a
// 4-query x 4-row register tile, 4 words per shared load, so the loop is
// POPC-bound rather than load-bound. The order is total (row indices are
// distinct), so any split of the bank yields the same top-k: the merge is
// exact.
//
// Banded design. The reference fetches, per 8-query block, num_tiles
// 128-row tiles from a host-computed tile base; a block of 16 or 32 queries
// could not keep to that budget. Here a block holds 8 queries (the block
// the host plan prices), derives its scan window on the device from its
// queries' own bands (lowest start to highest end), and the grid (query
// blocks x splits of that window x bands) covers every band row whatever
// the budget, which only sizes the grid. A warp (one query) skips the
// scoring of tiles its band does not meet, so the POPC work follows the
// rows inside the bands; rows outside a query's band are never offered.
// All bands of a batch go in one launch; the split merge folds them, exact
// because the bands' rows are distinct and the order is total. Bound on
// the H100: bytes, the distinct bank rows inside any band read once.
#include "hd_common.cuh"

namespace {

// Rows q0 .. q0 + nq - 1 of q into the shared query block qs (stride
// qstride words, zero past each row and past nq).
__device__ __forceinline__ void load_queries(const unsigned char* q, int q0,
                                             int nq, int bq, int row_bytes,
                                             int wpr, int qstride,
                                             uint32_t* qs) {
  for (int e = threadIdx.x; e < bq * qstride; e += blockDim.x) {
    const int qi = e / qstride;
    const int w = e - qi * qstride;
    qs[e] = (qi < nq && w < wpr)
                ? hd::load_word(q + static_cast<size_t>(q0 + qi) * row_bytes,
                                w, row_bytes)
                : 0u;
  }
}

template <int MODE, int QPT>
__global__ void __launch_bounds__(hd::kThreads)
    topk_scan_kernel(const unsigned char* __restrict__ q,
                     const unsigned char* __restrict__ r, int Q, int R,
                     int row_bytes, int wpr, int qstride, int dim, int k,
                     int num_valid, int rows_per_split, int splits, int* cv,
                     int* ci) {
  constexpr int BQ = hd::kWarps * QPT;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qs = smem;
  uint32_t* rt = qs + BQ * qstride;
  int* lv = reinterpret_cast<int*>(rt + hd::kTileWords);
  int* li = lv + BQ * k;

  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Q - q0);
  const int split = blockIdx.y;
  load_queries(q, q0, nq, BQ, row_bytes, wpr, qstride, qs);
  hd::list_init(lv, li, BQ * k, k, R);
  __syncthreads();

  const int row_begin = split * rows_per_split;
  const int row_end = min(R, row_begin + rows_per_split);
  hd::scan_rows<MODE, QPT>(qs, qstride, nq, r, row_bytes, wpr, row_begin,
                           row_end, num_valid, dim, nullptr, rt, lv, li, k);
  hd::write_candidates<QPT>(lv, li, k, q0, nq, split, splits, cv, ci);
}

// Block (query block x, split y, band z) of the banded search: 8 queries,
// one per warp. starts/ends are (nbands, Q), already clipped to the valid
// rows, so no row past them is offered.
template <int MODE>
__global__ void __launch_bounds__(hd::kThreads)
    topk_banded_kernel(const unsigned char* __restrict__ q,
                       const unsigned char* __restrict__ r, int Q, int R,
                       int row_bytes, int wpr, int qstride, int dim, int k,
                       const int* __restrict__ starts,
                       const int* __restrict__ ends, int splits, int* cv,
                       int* ci) {
  constexpr int BQ = hd::kWarps;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qs = smem;
  uint32_t* rt = qs + BQ * qstride;
  int* lv = reinterpret_cast<int*>(rt + hd::kTileWords);
  int* li = lv + BQ * k;
  int2* band = reinterpret_cast<int2*>(li + BQ * k);

  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Q - q0);
  load_queries(q, q0, nq, BQ, row_bytes, wpr, qstride, qs);
  hd::list_init(lv, li, BQ * k, k, R);
  hd::load_bands(starts, ends, Q, blockIdx.z, q0, nq, BQ, band);
  __syncthreads();

  const int2 rows =
      hd::split_window(hd::band_window(band, nq), blockIdx.y, splits);
  hd::scan_rows<MODE, 1>(qs, qstride, nq, r, row_bytes, wpr, rows.x, rows.y,
                         R, dim, band, rt, lv, li, k);
  hd::write_candidates<1>(lv, li, k, q0, nq, blockIdx.z * splits + blockIdx.y,
                          gridDim.z * splits, cv, ci);
}

template <int MODE, int QPT>
cudaError_t launch_scan(const void* q, const void* r, int Q, int R,
                        int row_bytes, int wpr, int qstride, int dim, int k,
                        int num_valid, int rows_per_split, int splits,
                        int* cv, int* ci, cudaStream_t stream) {
  constexpr int BQ = hd::kWarps * QPT;
  const size_t smem = sizeof(uint32_t) *
                      (static_cast<size_t>(BQ) * qstride + hd::kTileWords +
                       2 * static_cast<size_t>(BQ) * k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_scan_kernel<MODE, QPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Q + BQ - 1) / BQ, splits);
  topk_scan_kernel<MODE, QPT><<<grid, hd::kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(q),
      static_cast<const unsigned char*>(r), Q, R, row_bytes, wpr, qstride,
      dim, k, num_valid, rows_per_split, splits, cv, ci);
  return cudaGetLastError();
}

}  // namespace

// q (Q rows) and r (R rows) of row_bytes bytes each: int32 words when
// mode == 0 (packed), int8 lanes when mode == 1. wpr = words per row
// (ceil(row_bytes / 4)); qstride = wpr rounded up to 4. bq in {8, 16, 32}.
// cv/ci: (Q, splits, k) scratch; ov/oi: (Q, k) results. Returns the CUDA
// error of the launches (0 on success).
extern "C" int topk_hamming_launch(const void* q, const void* r, int Q, int R,
                                   int row_bytes, int wpr, int qstride,
                                   int mode, int dim, int k, int num_valid,
                                   int bq, int rows_per_split, int splits,
                                   void* cv, void* ci, void* ov, void* oi,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* cvi = static_cast<int*>(cv);
  int* cii = static_cast<int*>(ci);
  cudaError_t err;
#define HD_SCAN(MODE, QPT)                                                   \
  launch_scan<MODE, QPT>(q, r, Q, R, row_bytes, wpr, qstride, dim, k,        \
                         num_valid, rows_per_split, splits, cvi, cii, s)
  if (mode == hd::kPacked) {
    err = bq == 32 ? HD_SCAN(hd::kPacked, 4)
        : bq == 16 ? HD_SCAN(hd::kPacked, 2)
                   : HD_SCAN(hd::kPacked, 1);
  } else {
    err = bq == 32 ? HD_SCAN(hd::kInt8, 4)
        : bq == 16 ? HD_SCAN(hd::kInt8, 2)
                   : HD_SCAN(hd::kInt8, 1);
  }
#undef HD_SCAN
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hd::launch_merge(cvi, cii, Q, splits, k, R,
                                           static_cast<int*>(ov),
                                           static_cast<int*>(oi), s));
}

// The banded search: q, r as in topk_hamming_launch; starts/ends (nbands,
// Q) int32 row bounds, ascending disjoint bands per query, clipped to the
// valid rows; splits per (query block, band) window. cv/ci: (Q, nbands *
// splits, k) scratch; ov/oi: (Q, k) results, INT_MIN-valued slots past the
// bands' rows carrying filler indices >= R. Returns the CUDA error of the
// launches (0 on success).
extern "C" int topk_hamming_banded_launch(const void* q, const void* r, int Q,
                                          int R, int row_bytes, int wpr,
                                          int qstride, int mode, int dim,
                                          int k, const void* starts,
                                          const void* ends, int nbands,
                                          int splits, void* cv, void* ci,
                                          void* ov, void* oi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int BQ = hd::kWarps;
  const size_t smem = sizeof(uint32_t) *
                      (static_cast<size_t>(BQ) * qstride + hd::kTileWords +
                       2 * static_cast<size_t>(BQ) * k + 2 * BQ);
  auto kernel = mode == hd::kPacked ? topk_banded_kernel<hd::kPacked>
                                    : topk_banded_kernel<hd::kInt8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Q + BQ - 1) / BQ, splits, nbands);
  kernel<<<grid, hd::kThreads, smem, s>>>(
      static_cast<const unsigned char*>(q),
      static_cast<const unsigned char*>(r), Q, R, row_bytes, wpr, qstride,
      dim, k, static_cast<const int*>(starts), static_cast<const int*>(ends),
      splits, static_cast<int*>(cv), static_cast<int*>(ci));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hd::launch_merge(
      static_cast<int*>(cv), static_cast<int*>(ci), Q, nbands * splits, k, R,
      static_cast<int*>(ov), static_cast<int*>(oi), s));
}
