// Streaming top-k Hamming search on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/topk_hamming/topk_hamming.py
// (_topk_kernel, launched by topk_hamming_pallas_call): per query the k best
// bank rows by (score desc, row asc), where a packed row scores
// dim - 2 * popcount(q ^ r) and an int8 row the integer dot <q, r>; rows at
// or past num_valid score INT_MIN but stay candidates. Only (Q, k) reaches
// device memory.
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
#include "hd_common.cuh"

namespace {

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
  for (int e = threadIdx.x; e < BQ * qstride; e += blockDim.x) {
    const int qi = e / qstride;
    const int w = e - qi * qstride;
    qs[e] = (qi < nq && w < wpr)
                ? hd::load_word(q + static_cast<size_t>(q0 + qi) * row_bytes,
                                w, row_bytes)
                : 0u;
  }
  hd::list_init(lv, li, BQ * k, k, R);
  __syncthreads();

  const int row_begin = split * rows_per_split;
  const int row_end = min(R, row_begin + rows_per_split);
  hd::scan_rows<MODE, QPT>(qs, qstride, nq, r, row_bytes, wpr, row_begin,
                           row_end, num_valid, dim, rt, lv, li, k);
  hd::write_candidates<QPT>(lv, li, k, q0, nq, split, splits, cv, ci);
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
