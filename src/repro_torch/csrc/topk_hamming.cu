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
// Banded search: hd_banded_scan.cuh (bound, design: bank-major blocks of up
// to 32 queries, each bank tile that a band meets read once), then the
// same split merge over the blocks' slots.
#include "hd_banded_scan.cuh"
#include "hd_exact_scan.cuh"

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
// valid rows; queries in groups of G (<= 32), `blocks` blocks a group.
// cv/ci: (Q, blocks, k) scratch; ov/oi: (Q, k) results, INT_MIN-valued
// slots past the bands' rows carrying filler indices >= R. Returns the
// CUDA error of the launches (0 on success).
extern "C" int topk_hamming_banded_launch(const void* q, const void* r, int Q,
                                          int R, int row_bytes, int wpr,
                                          int mode, int dim, int k,
                                          const void* starts,
                                          const void* ends, int nbands, int G,
                                          int blocks, void* cv, void* ci,
                                          void* ov, void* oi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* cvi = static_cast<int*>(cv);
  int* cii = static_cast<int*>(ci);
  cudaError_t err = hd::launch_banded_scan(
      q, r, Q, R, row_bytes, wpr, mode, dim, k, G,
      static_cast<const int*>(starts), static_cast<const int*>(ends), nbands,
      blocks, cvi, cii, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hd::launch_merge(cvi, cii, Q, blocks, k, R,
                                           static_cast<int*>(ov),
                                           static_cast<int*>(oi), s));
}
