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
// search. Here the port's one Eq. 1 encoder (hd_encode_rows.cuh: bound,
// design; the kernel of hd_encode.cu too) first encodes the batch over a
// grid of (query, 64-word) blocks into the bank's storage form: packed
// words or int8 +-1 lanes, exact (tie -> -1, levels past m - 1 read
// LV[m - 1]). The encoded queries pass through device memory, a (Q, W)
// word scratch (32 KB at Q = 32, D = 8192, read back from L2), which the
// scan then stages exactly as topk_hamming's scan stages its query
// operand. Keeping them on chip made each of the ~500 bank splits
// re-encode its query block before its scan, one query at a time: ~23 us a
// query at D = 8192. The encode, the exact scan of hd_exact_scan.cuh (the
// int8 tensor cores for packed banks in 16- or 32-query blocks,
// hd::scan_rows otherwise) and the split merge run in turn on the caller's
// stream.
//
// Banded design: the same encode once per launch into the same scratch,
// then topk_hamming.cu's banded scan (hd_banded_scan.cuh: bank-major
// blocks of up to 32 queries, each live bank tile read once) and the
// merge over the blocks' slots, in turn on the caller's stream. The
// banded scan reads the encoded queries as topk_hamming_banded reads its
// query operand.
#include "hd_banded_scan.cuh"
#include "hd_encode_rows.cuh"
#include "hd_exact_scan.cuh"

namespace {

constexpr int kEncWords = 64;  // 32-dim words a block of the encode phase
                               // covers, as hd_encode's default block_d:
                               // a Q = 32, D = 8,192 batch is 128 blocks

cudaError_t launch_encode(const int* levels, int Q, int F, int m,
                          const uint32_t* id_words, const uint32_t* lv_words,
                          int wc, int D, int mode, unsigned char* out,
                          cudaStream_t s) {
  return hd::launch_encode_rows(levels, Q, F, m, id_words, lv_words, wc, D,
                                1, kEncWords, mode, out, s);
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
// encode_search_launch; starts/ends/nbands/G/blocks and the outputs as in
// topk_hamming_banded_launch. Returns the CUDA error of the launches (0 on
// success).
extern "C" int encode_search_banded_launch(
    const void* levels, int Q, int F, int m, const void* id_words,
    const void* lv_words, int wc, int D, const void* r, int R, int row_bytes,
    int wpr, int mode, int dim, int k, const void* starts, const void* ends,
    int nbands, int G, int blocks, void* enc, void* cv, void* ci, void* ov,
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
  err = hd::launch_banded_scan(enc, r, Q, R, row_bytes, wpr, mode, dim, k, G,
                               static_cast<const int*>(starts),
                               static_cast<const int*>(ends), nbands, blocks,
                               cvi, cii, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hd::launch_merge(cvi, cii, Q, blocks, k, R,
                                           static_cast<int*>(ov),
                                           static_cast<int*>(oi), s));
}
