// Fused Eq. 1 encode -> sign -> pack -> streaming top-k on Hopper (sm_90a),
// exact and banded.
//
// Replaces the TPU kernels src/repro/kernels/encode_search/encode_search.py
// _encode_search_kernel (launched by encode_search_pallas_call): raw
// quantized levels (Q, F) in, the top-k bank rows of the encoded queries
// out, bit-identical to encode_levels_batch -> bit-pack -> topk_hamming.
// And _encode_search_banded_kernel (encode_search_banded_pallas_call): the
// same with topk_hamming.cu's banded scan (OMS precursor bands).
//
// Bound on the H100: bytes, as for topk_hamming (the bank read once; the
// +-1 dot products fit under it at the int8 tensor-core rate). The encode
// adds n_present x D products per query, with n_present the present bins of
// a spectrum (~5% of F on the synthetic library), and the packed codebooks
// (1 MB).
//
// Exact design: encode once per launch, then topk_hamming's exact scan.
// The TPU kernel holds the whole (F, D) ID codebook in VMEM (8 MB at
// F = 1024, D = 8192) and a (BQ, D) accumulator, and encodes inside the
// search. Here encode_rows_kernel first encodes the batch, one 32-dim word
// per thread over a grid of (query, 128-word) blocks: the codebooks arrive
// bit-packed (1 MB, read from L2), and 16 bit-sliced counters in
// registers count the agreeing bits exactly (hd::sliced_add; tie -> -1,
// levels past m - 1 read LV[m - 1]). The encoded queries pass through
// device memory, a (Q, W) word scratch (32 KB at Q = 32, D = 8192, read
// back from L2), which the scan then stages exactly as topk_hamming's
// scan stages its query operand. Keeping them on chip made each of the
// ~500 bank splits re-encode its query block before its scan, one query
// at a time: ~23 us a query at D = 8192. The encode, the exact scan of
// hd_exact_scan.cuh (the int8 tensor cores for packed banks in 16- or
// 32-query blocks, hd::scan_rows otherwise) and the split merge run in
// turn on the caller's stream.
//
// Banded design: the same encode once per launch into the same scratch,
// then topk_hamming.cu's banded scan (hd_banded_scan.cuh: 8-query blocks,
// the scan window derived on the device from the block's bands, on
// hd::scan_rows) and the merge over the (band, split) slots, in turn on
// the caller's stream. No (query block, split, band) block encodes: the
// banded scan reads the encoded queries as topk_hamming_banded reads its
// query operand.
#include "hd_banded_scan.cuh"
#include "hd_exact_scan.cuh"

namespace {

constexpr int kEncThreads = 128;  // words of one query a block encodes
constexpr int kEncCap = 2048;     // present features compacted per round

// Block (query x, words 128 y ..): Eq. 1 of one query, one 32-dim word per
// thread, into row x of out: packed words (MODE kPacked, rows of wc words)
// or int8 +-1 lanes (kInt8, rows of D bytes).
template <int MODE>
__global__ void __launch_bounds__(kEncThreads)
    encode_rows_kernel(const int* __restrict__ levels, int F, int m,
                       const uint32_t* __restrict__ id_words,
                       const uint32_t* __restrict__ lv_words, int wc, int D,
                       unsigned char* __restrict__ out) {
  __shared__ int2 feats[kEncCap];
  __shared__ int count;
  const int* lrow = levels + static_cast<size_t>(blockIdx.x) * F;
  const int w = blockIdx.y * kEncThreads + threadIdx.x;
  uint32_t planes[hd::kPlanes];
#pragma unroll
  for (int p = 0; p < hd::kPlanes; ++p) planes[p] = 0u;
  int total = 0;
  for (int f0 = 0; f0 < F; f0 += kEncCap) {
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    const int f1 = min(F, f0 + kEncCap);
    for (int f = f0 + threadIdx.x; f < f1; f += kEncThreads) {
      const int l = lrow[f];
      if (l > 0) feats[atomicAdd(&count, 1)] = make_int2(f, min(l, m - 1));
    }
    __syncthreads();
    const int n = count;
    total += n;
    if (w < wc) {
      // four features' codebook words in flight at once
      int e = 0;
      for (; e + 4 <= n; e += 4) {
        uint32_t x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int2 fl = feats[e + u];
          x[u] = ~(__ldg(id_words + static_cast<size_t>(fl.x) * wc + w) ^
                   __ldg(lv_words + static_cast<size_t>(fl.y) * wc + w));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) hd::sliced_add(planes, x[u]);
      }
      for (; e < n; ++e) {
        const int2 fl = feats[e];
        hd::sliced_add(planes,
                       ~(__ldg(id_words + static_cast<size_t>(fl.x) * wc + w) ^
                         __ldg(lv_words + static_cast<size_t>(fl.y) * wc + w)));
      }
    }
    __syncthreads();  // feats is rewritten by the next feature round
  }
  if (w >= wc) return;
  const uint32_t bits =
      hd::sliced_greater(planes, static_cast<uint32_t>(total) >> 1);
  if (MODE == hd::kPacked) {
    reinterpret_cast<uint32_t*>(out)[static_cast<size_t>(blockIdx.x) * wc + w] =
        bits;
  } else {
    unsigned char* row = out + static_cast<size_t>(blockIdx.x) * D;
    for (int j = 0; j < 32 && 32 * w + j < D; ++j)
      row[32 * w + j] = ((bits >> j) & 1u) ? 0x01 : 0xFF;
  }
}

cudaError_t launch_encode(const int* levels, int Q, int F, int m,
                          const uint32_t* id_words, const uint32_t* lv_words,
                          int wc, int D, int mode, unsigned char* out,
                          cudaStream_t s) {
  dim3 grid(Q, (wc + kEncThreads - 1) / kEncThreads);
  if (mode == hd::kPacked) {
    encode_rows_kernel<hd::kPacked><<<grid, kEncThreads, 0, s>>>(
        levels, F, m, id_words, lv_words, wc, D, out);
  } else {
    encode_rows_kernel<hd::kInt8><<<grid, kEncThreads, 0, s>>>(
        levels, F, m, id_words, lv_words, wc, D, out);
  }
  return cudaGetLastError();
}

}  // namespace

// The encode alone: levels (Q, F) int32 and the bit-packed codebooks
// id_words (F, wc) and lv_words (m, wc), wc = ceil(D / 32), into out:
// (Q, wc) packed words (mode 0) or (Q, D) int8 +-1 lanes (mode 1). Returns
// the CUDA error of the launch (0 on success).
extern "C" int encode_rows_launch(const void* levels, int Q, int F, int m,
                                  const void* id_words, const void* lv_words,
                                  int wc, int D, int mode, void* out,
                                  void* stream) {
  return static_cast<int>(launch_encode(
      static_cast<const int*>(levels), Q, F, m,
      static_cast<const uint32_t*>(id_words),
      static_cast<const uint32_t*>(lv_words), wc, D, mode,
      static_cast<unsigned char*>(out), static_cast<cudaStream_t>(stream)));
}

// levels and codebooks as in encode_rows_launch; bank r as in
// topk_hamming_launch (mode 0: packed words, D == 32 * wpr; mode 1: int8
// rows of D bytes); enc: the encoded queries' scratch, (Q, wc) int32 (mode
// 0) or (Q, D) int8 (mode 1). Returns the CUDA error of the launches (0 on
// success).
extern "C" int encode_search_launch(const void* levels, int Q, int F, int m,
                                    const void* id_words, const void* lv_words,
                                    int wc, int D, const void* r, int R,
                                    int row_bytes, int wpr, int qstride,
                                    int mode, int dim, int k, int num_valid,
                                    int bq, int rows_per_split, int splits,
                                    void* enc, void* cv, void* ci, void* ov,
                                    void* oi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* cvi = static_cast<int*>(cv);
  int* cii = static_cast<int*>(ci);
  cudaError_t err = launch_encode(
      static_cast<const int*>(levels), Q, F, m,
      static_cast<const uint32_t*>(id_words),
      static_cast<const uint32_t*>(lv_words), wc, D, mode,
      static_cast<unsigned char*>(enc), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hd::launch_exact_scan(enc, r, Q, R, row_bytes, wpr, qstride, mode,
                              dim, k, num_valid, bq, rows_per_split, splits,
                              cvi, cii, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hd::launch_merge(cvi, cii, Q, splits, k, R,
                                           static_cast<int*>(ov),
                                           static_cast<int*>(oi), s));
}

// The banded fused search: levels, codebooks, bank and enc as in
// encode_search_launch; starts/ends/nbands/splits and the outputs as in
// topk_hamming_banded_launch. Returns the CUDA error of the launches (0 on
// success).
extern "C" int encode_search_banded_launch(
    const void* levels, int Q, int F, int m, const void* id_words,
    const void* lv_words, int wc, int D, const void* r, int R, int row_bytes,
    int wpr, int qstride, int mode, int dim, int k, const void* starts,
    const void* ends, int nbands, int splits, void* enc, void* cv, void* ci,
    void* ov, void* oi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* cvi = static_cast<int*>(cv);
  int* cii = static_cast<int*>(ci);
  cudaError_t err = launch_encode(
      static_cast<const int*>(levels), Q, F, m,
      static_cast<const uint32_t*>(id_words),
      static_cast<const uint32_t*>(lv_words), wc, D, mode,
      static_cast<unsigned char*>(enc), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hd::launch_banded_scan(enc, r, Q, R, row_bytes, wpr, qstride, mode,
                               dim, k, static_cast<const int*>(starts),
                               static_cast<const int*>(ends), nbands, splits,
                               cvi, cii, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hd::launch_merge(cvi, cii, Q, nbands * splits, k,
                                           R, static_cast<int*>(ov),
                                           static_cast<int*>(oi), s));
}
