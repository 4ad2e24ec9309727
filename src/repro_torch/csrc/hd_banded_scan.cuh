// The banded search scan of topk_hamming.cu and encode_search.cu (sm_90a):
// per (query block, split of the block's scan window, band) the k best
// rows of the split inside each query's own [start, end) band, by (score
// desc, row asc), into the split's candidate slots; hd::launch_merge folds
// the (band, split) slots. starts/ends are (nbands, Q), already clipped to
// the valid rows, so no row past them is offered.
//
// Design (hd::scan_rows, on the POPC pipe for packed words: one XOR, one
// POPC and one add per query-row-word; __dp4a for int8 rows). The
// reference fetches, per 8-query block, num_tiles 128-row tiles from a
// host-computed tile base; a block of 16 or 32 queries could not keep to
// that budget. Here a block holds 8 queries (the block the host plan
// prices), derives its scan window on the device from its queries' own
// bands (lowest start to highest end), and the grid (query blocks x splits
// of that window x bands) covers every band row whatever the budget, which
// only sizes the grid. A warp (one query) skips the scoring of tiles its
// band does not meet, so the POPC work follows the rows inside the bands;
// rows outside a query's band are never offered. All bands of a batch go
// in one launch; the split merge folds them, exact because the bands' rows
// are distinct and the order is total. Bound on the H100: bytes, the
// distinct bank rows inside any band read once.
#pragma once

#include "hd_common.cuh"

namespace hd {

// Block (query block x, split y, band z) of the banded search: 8 queries,
// one per warp.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
    banded_scan_kernel(const unsigned char* __restrict__ q,
                       const unsigned char* __restrict__ r, int Q, int R,
                       int row_bytes, int wpr, int qstride, int dim, int k,
                       const int* __restrict__ starts,
                       const int* __restrict__ ends, int splits, int* cv,
                       int* ci) {
  constexpr int BQ = kWarps;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qs = smem;
  uint32_t* rt = qs + BQ * qstride;
  int* lv = reinterpret_cast<int*>(rt + kTileWords);
  int* li = lv + BQ * k;
  int2* band = reinterpret_cast<int2*>(li + BQ * k);

  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Q - q0);
  load_queries(q, q0, nq, BQ, row_bytes, wpr, qstride, qs);
  list_init(lv, li, BQ * k, k, R);
  load_bands(starts, ends, Q, blockIdx.z, q0, nq, BQ, band);
  __syncthreads();

  const int2 rows = split_window(band_window(band, nq), blockIdx.y, splits);
  scan_rows<MODE, 1>(qs, qstride, nq, r, row_bytes, wpr, rows.x, rows.y, R,
                     dim, band, rt, lv, li, k);
  write_candidates<1>(lv, li, k, q0, nq, blockIdx.z * splits + blockIdx.y,
                      gridDim.z * splits, cv, ci);
}

// The banded scan of q (Q rows) against r (R rows) of row_bytes bytes each
// (mode 0: packed words; mode 1: int8 lanes; wpr = ceil(row_bytes / 4),
// qstride = wpr rounded up to 4) over nbands bands and splits splits of
// each block's window, into the (Q, nbands * splits, k) candidate buffers.
// Returns the launch's CUDA error.
inline cudaError_t launch_banded_scan(const void* q, const void* r, int Q,
                                      int R, int row_bytes, int wpr,
                                      int qstride, int mode, int dim, int k,
                                      const int* starts, const int* ends,
                                      int nbands, int splits, int* cv,
                                      int* ci, cudaStream_t s) {
  constexpr int BQ = kWarps;
  const size_t smem = sizeof(uint32_t) *
                      (static_cast<size_t>(BQ) * qstride + kTileWords +
                       2 * static_cast<size_t>(BQ) * k + 2 * BQ);
  auto kernel = mode == kPacked ? banded_scan_kernel<kPacked>
                                : banded_scan_kernel<kInt8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Q + BQ - 1) / BQ, splits, nbands);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const unsigned char*>(q),
      static_cast<const unsigned char*>(r), Q, R, row_bytes, wpr, qstride,
      dim, k, starts, ends, splits, cv, ci);
  return cudaGetLastError();
}

}  // namespace hd
