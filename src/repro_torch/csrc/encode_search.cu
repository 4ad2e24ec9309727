// Fused Eq. 1 encode -> sign -> pack -> streaming top-k on Hopper (sm_90a),
// exact and banded.
//
// Replaces the TPU kernels src/repro/kernels/encode_search/encode_search.py
// _encode_search_kernel (launched by encode_search_pallas_call): raw
// quantized levels (Q, F) in, the top-k bank rows of the encoded queries
// out, bit-identical to encode_levels_batch -> bit-pack -> topk_hamming.
// The query hypervector never reaches device memory. And
// _encode_search_banded_kernel (encode_search_banded_pallas_call): the
// same with topk_hamming.cu's banded scan (OMS precursor bands).
//
// Bound on the H100: bytes, as for topk_hamming (the bank read once; the
// +-1 dot products fit under it at the int8 tensor-core rate). The encode
// adds n_present x D products per query, with n_present the present bins of
// a spectrum (~5% of F on the synthetic library), and the packed codebooks
// (1 MB). The scan here is topk_hamming's, on the POPC pipe, so this design
// is capped by the POPC rate, plus each bank split's re-encode of its
// n_present x D / 32 codebook-word XNORs and bit-sliced adds.
//
// Design. The TPU kernel holds the whole (F, D) ID codebook in VMEM (8 MB at
// F = 1024, D = 8192) and a (BQ, D) accumulator; neither fits in 227 KB of
// shared memory. Here the codebooks arrive bit-packed (1 MB, read from L2),
// each thread builds one 32-dim word at a time with 16 bit-sliced counters
// in registers (an exact count of agreeing bits; see encode_block), and only
// the packed (BQ, D/32) block lives in shared memory. Every bank split
// re-encodes its own query block, so no encoded query is written out; the
// scan and merge are topk_hamming's, from hd_common.cuh. The banded kernel
// is topk_hamming.cu's banded design (8-query blocks, the scan window
// derived on the device from the block's bands) with encode_block at the
// start of each block; each (split, band) block re-encodes its 8 queries.
#include "hd_common.cuh"

namespace {

template <int MODE, int QPT>
__global__ void __launch_bounds__(hd::kThreads)
    encode_search_kernel(const int* __restrict__ levels, int Q, int F, int m,
                         const uint32_t* __restrict__ id_words,
                         const uint32_t* __restrict__ lv_words, int wc, int D,
                         const unsigned char* __restrict__ r, int R,
                         int row_bytes, int wpr, int qstride, int dim, int k,
                         int num_valid, int rows_per_split, int splits,
                         int* cv, int* ci) {
  constexpr int BQ = hd::kWarps * QPT;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qs = smem;
  uint32_t* rt = qs + BQ * qstride;
  int* lv = reinterpret_cast<int*>(rt + hd::kTileWords);
  int* li = lv + BQ * k;
  int* counter = li + BQ * k;

  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Q - q0);
  const int split = blockIdx.y;
  for (int e = threadIdx.x; e < BQ * qstride; e += blockDim.x) qs[e] = 0u;
  hd::list_init(lv, li, BQ * k, k, R);
  __syncthreads();
  // the bank tile is free until the scan starts: it holds the compacted
  // present-feature list meanwhile
  hd::encode_block<MODE>(levels, q0, nq, BQ, F, m, id_words, lv_words, wc, D,
                         qs, qstride, reinterpret_cast<int2*>(rt),
                         hd::kTileWords / 2, counter);
  __syncthreads();

  const int row_begin = split * rows_per_split;
  const int row_end = min(R, row_begin + rows_per_split);
  hd::scan_rows<MODE, QPT>(qs, qstride, nq, r, row_bytes, wpr, row_begin,
                           row_end, num_valid, dim, nullptr, rt, lv, li, k);
  hd::write_candidates<QPT>(lv, li, k, q0, nq, split, splits, cv, ci);
}

// Block (query block x, split y, band z) of the banded search: 8 queries,
// one per warp; starts/ends (nbands, Q) as in topk_hamming_banded_launch.
template <int MODE>
__global__ void __launch_bounds__(hd::kThreads)
    encode_search_banded_kernel(const int* __restrict__ levels, int Q, int F,
                                int m, const uint32_t* __restrict__ id_words,
                                const uint32_t* __restrict__ lv_words, int wc,
                                int D, const unsigned char* __restrict__ r,
                                int R, int row_bytes, int wpr, int qstride,
                                int dim, int k,
                                const int* __restrict__ starts,
                                const int* __restrict__ ends, int splits,
                                int* cv, int* ci) {
  constexpr int BQ = hd::kWarps;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qs = smem;
  uint32_t* rt = qs + BQ * qstride;
  int* lv = reinterpret_cast<int*>(rt + hd::kTileWords);
  int* li = lv + BQ * k;
  int* counter = li + BQ * k;
  int2* band = reinterpret_cast<int2*>(counter + 4);

  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Q - q0);
  for (int e = threadIdx.x; e < BQ * qstride; e += blockDim.x) qs[e] = 0u;
  hd::list_init(lv, li, BQ * k, k, R);
  hd::load_bands(starts, ends, Q, blockIdx.z, q0, nq, BQ, band);
  __syncthreads();
  const int2 rows =
      hd::split_window(hd::band_window(band, nq), blockIdx.y, splits);
  if (rows.x < rows.y) {  // block-uniform: a block with no rows skips the encode
    hd::encode_block<MODE>(levels, q0, nq, BQ, F, m, id_words, lv_words, wc,
                           D, qs, qstride, reinterpret_cast<int2*>(rt),
                           hd::kTileWords / 2, counter);
    __syncthreads();
    hd::scan_rows<MODE, 1>(qs, qstride, nq, r, row_bytes, wpr, rows.x, rows.y,
                           R, dim, band, rt, lv, li, k);
  }
  hd::write_candidates<1>(lv, li, k, q0, nq, blockIdx.z * splits + blockIdx.y,
                          gridDim.z * splits, cv, ci);
}

template <int MODE, int QPT>
cudaError_t launch_fused(const int* levels, int Q, int F, int m,
                         const uint32_t* id_words, const uint32_t* lv_words,
                         int wc, int D, const void* r, int R, int row_bytes,
                         int wpr, int qstride, int dim, int k, int num_valid,
                         int rows_per_split, int splits, int* cv, int* ci,
                         cudaStream_t stream) {
  constexpr int BQ = hd::kWarps * QPT;
  const size_t smem = sizeof(uint32_t) *
                      (static_cast<size_t>(BQ) * qstride + hd::kTileWords +
                       2 * static_cast<size_t>(BQ) * k + 4);
  cudaError_t err = cudaFuncSetAttribute(
      encode_search_kernel<MODE, QPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Q + BQ - 1) / BQ, splits);
  encode_search_kernel<MODE, QPT><<<grid, hd::kThreads, smem, stream>>>(
      levels, Q, F, m, id_words, lv_words, wc, D,
      static_cast<const unsigned char*>(r), R, row_bytes, wpr, qstride, dim,
      k, num_valid, rows_per_split, splits, cv, ci);
  return cudaGetLastError();
}

}  // namespace

// levels (Q, F) int32; id_words (F, wc) and lv_words (m, wc) bit-packed
// codebooks, wc = ceil(D / 32); bank r as in topk_hamming_launch (mode 0:
// packed words, D == 32 * wpr; mode 1: int8 rows of D bytes). Returns the
// CUDA error of the launches (0 on success).
extern "C" int encode_search_launch(const void* levels, int Q, int F, int m,
                                    const void* id_words, const void* lv_words,
                                    int wc, int D, const void* r, int R,
                                    int row_bytes, int wpr, int qstride,
                                    int mode, int dim, int k, int num_valid,
                                    int bq, int rows_per_split, int splits,
                                    void* cv, void* ci, void* ov, void* oi,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lev = static_cast<const int*>(levels);
  const uint32_t* idw = static_cast<const uint32_t*>(id_words);
  const uint32_t* lvw = static_cast<const uint32_t*>(lv_words);
  int* cvi = static_cast<int*>(cv);
  int* cii = static_cast<int*>(ci);
  cudaError_t err;
#define HD_FUSED(MODE, QPT)                                                  \
  launch_fused<MODE, QPT>(lev, Q, F, m, idw, lvw, wc, D, r, R, row_bytes,     \
                          wpr, qstride, dim, k, num_valid, rows_per_split,    \
                          splits, cvi, cii, s)
  if (mode == hd::kPacked) {
    err = bq == 32 ? HD_FUSED(hd::kPacked, 4)
        : bq == 16 ? HD_FUSED(hd::kPacked, 2)
                   : HD_FUSED(hd::kPacked, 1);
  } else {
    err = bq == 32 ? HD_FUSED(hd::kInt8, 4)
        : bq == 16 ? HD_FUSED(hd::kInt8, 2)
                   : HD_FUSED(hd::kInt8, 1);
  }
#undef HD_FUSED
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hd::launch_merge(cvi, cii, Q, splits, k, R,
                                           static_cast<int*>(ov),
                                           static_cast<int*>(oi), s));
}

// The banded fused search: levels, codebooks and bank as in
// encode_search_launch; starts/ends/nbands/splits and the outputs as in
// topk_hamming_banded_launch. Returns the CUDA error of the launches (0 on
// success).
extern "C" int encode_search_banded_launch(
    const void* levels, int Q, int F, int m, const void* id_words,
    const void* lv_words, int wc, int D, const void* r, int R, int row_bytes,
    int wpr, int qstride, int mode, int dim, int k, const void* starts,
    const void* ends, int nbands, int splits, void* cv, void* ci, void* ov,
    void* oi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int BQ = hd::kWarps;
  const size_t smem = sizeof(uint32_t) *
                      (static_cast<size_t>(BQ) * qstride + hd::kTileWords +
                       2 * static_cast<size_t>(BQ) * k + 4 + 2 * BQ);
  auto kernel = mode == hd::kPacked ? encode_search_banded_kernel<hd::kPacked>
                                    : encode_search_banded_kernel<hd::kInt8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Q + BQ - 1) / BQ, splits, nbands);
  kernel<<<grid, hd::kThreads, smem, s>>>(
      static_cast<const int*>(levels), Q, F, m,
      static_cast<const uint32_t*>(id_words),
      static_cast<const uint32_t*>(lv_words), wc, D,
      static_cast<const unsigned char*>(r), R, row_bytes, wpr, qstride, dim,
      k, static_cast<const int*>(starts), static_cast<const int*>(ends),
      splits, static_cast<int*>(cv), static_cast<int*>(ci));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hd::launch_merge(
      static_cast<int*>(cv), static_cast<int*>(ci), Q, nbands * splits, k, R,
      static_cast<int*>(ov), static_cast<int*>(oi), s));
}
