// ID-level HD encoding (SpecPCM Eq. 1) on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hd_encode/hd_encode.py
// _hd_encode_kernel (launched by hd_encode_pallas_call; its accumulator is
// encode_acc): quantized levels (B, F) int32 and bipolar codebooks ID (F, D)
// and LV (m, D) in, (B, D) int8 out,
//   out[b, d] = sign( sum_f [levels[b, f] > 0] LV[levels[b, f], d] ID[f, d] )
// with sign(0) = -1. Levels past m - 1 read LV[m - 1], as the reference's
// clamped gather (hd_encode_ref, encode_levels_batch) does; the TPU kernel's
// one-hot gives 0 there.
//
// The TPU kernel gathers LV rows with a one-hot matmul on the MXU and
// accumulates a (bb, bd) float block in VMEM. Here the codebooks arrive
// bit-packed (encode_search's pack_codebook) and the kernel is the port's
// one Eq. 1 encoder, hd_encode_rows.cuh (bound, design), writing int8
// lanes: a block owns block_b queries by block_d dims. Ragged B and D are
// handled in the kernel, so the wrapper makes no padded copies.
#include "hd_encode_rows.cuh"

// levels (B, F) int32, contiguous; id_words (F, wc) and lv_words (m, wc)
// int32 bit-packed codebooks, wc = ceil(D / 32); out (B, D) int8. block_d a
// multiple of 32. Launches on stream, does not synchronise; returns the CUDA
// error of the launch (0 on success).
extern "C" int hd_encode_launch(const void* levels, int B, int F, int m,
                                const void* id_words, const void* lv_words,
                                int wc, int D, int block_b, int block_d,
                                void* out, void* stream) {
  return static_cast<int>(hd::launch_encode_rows(
      static_cast<const int*>(levels), B, F, m,
      static_cast<const uint32_t*>(id_words),
      static_cast<const uint32_t*>(lv_words), wc, D, block_b, block_d / 32,
      hd::enc::kModeInt8, out, static_cast<cudaStream_t>(stream)));
}
