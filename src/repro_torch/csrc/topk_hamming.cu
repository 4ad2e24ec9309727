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
// Exact search: hd_exact_scan.cuh (bound, design; packed banks in 16- or
// 32-query blocks on the int8 tensor cores, 8-query blocks and int8 banks
// on hd::scan_rows), then the split merge. The TPU
// carries its running top-k across a sequential R grid axis; Hopper blocks
// run in no order, so the grid is 2-D (query blocks x bank splits) and a
// second kernel merges the splits, exact because the order is total.
//
// Banded design (hd::scan_rows, on the POPC pipe for packed words: one
// XOR, one POPC and one add per query-row-word). The reference fetches,
// per 8-query block, num_tiles 128-row tiles from a host-computed tile
// base; a block of 16 or 32 queries could not keep to that budget. Here a
// block holds 8 queries (the block the host plan prices), derives its scan
// window on the device from its queries' own bands (lowest start to
// highest end), and the grid (query blocks x splits of that window x
// bands) covers every band row whatever the budget, which only sizes the
// grid. A warp (one query) skips the scoring of tiles its band does not
// meet, so the POPC work follows the rows inside the bands; rows outside a
// query's band are never offered. All bands of a batch go in one launch;
// the split merge folds them, exact because the bands' rows are distinct
// and the order is total. Bound on the H100: bytes, the distinct bank rows
// inside any band read once.
#include "hd_exact_scan.cuh"

namespace {

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
  hd::load_queries(q, q0, nq, BQ, row_bytes, wpr, qstride, qs);
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
  cudaError_t err = hd::launch_exact_scan(q, r, Q, R, row_bytes, wpr, qstride,
                                          mode, dim, k, num_valid, bq,
                                          rows_per_split, splits, cvi, cii, s);
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
