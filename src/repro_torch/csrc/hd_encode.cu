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
// Bound on the H100: bytes, and at the served batch not even those. At
// B = 32, F = 1,024, D = 8,192 the function reads 128 KB of levels and the
// packed codebooks (1 MB) and writes 256 KB: well under 0.01 ms at
// 3.35 TB/s. The launch and the per-thread serial count bind it.
//
// Design. The TPU kernel gathers LV rows with a one-hot matmul on the MXU
// and accumulates a (bb, bd) float block in VMEM. Here the codebooks arrive
// bit-packed (encode_search's pack_codebook), and hd::encode_block (shared
// with encode_search.cu) counts, for 32 dims per thread, the present
// features whose ID and LV bits agree in 16 bit-sliced counter planes:
// acc = 2 * agree - n, so acc > 0 exactly when agree > n / 2, an exact
// integer sign. A block owns block_b queries by block_d dims (grid
// (B / block_b, D / block_d), one thread per 32-dim word of the slice); it
// encodes its queries one at a time into one shared row of int8 +-1 lanes
// and copies that row out. Ragged B and D are handled in the kernel: only
// in-range queries are encoded and only in-range lanes stored, so the
// wrapper makes no padded copies.
#include <algorithm>

#include "hd_common.cuh"

namespace {

constexpr int kCap = 1024;  // present (feature, level) pairs compacted at once

__global__ void hd_encode_kernel(const int* __restrict__ levels, int B, int F,
                                 int m, const uint32_t* __restrict__ id_words,
                                 const uint32_t* __restrict__ lv_words,
                                 int wc, int D, int block_b, int block_d,
                                 signed char* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* row = smem;  // block_d int8 lanes of one query
  int2* scratch = reinterpret_cast<int2*>(row + block_d / 4);
  int* counter = reinterpret_cast<int*>(scratch + kCap);
  const int b0 = blockIdx.x * block_b;
  const int w0 = blockIdx.y * (block_d / 32);
  const int nw = min(block_d / 32, wc - w0);
  const int d0 = 32 * w0;
  const int nd = min(block_d, D - d0);
  const int nb = min(block_b, B - b0);
  const signed char* lanes = reinterpret_cast<const signed char*>(row);
  for (int i = 0; i < nb; ++i) {
    hd::encode_block<hd::kInt8>(levels, b0 + i, 1, 1, F, m, id_words + w0,
                                lv_words + w0, nw, wc, nd, row, block_d / 4,
                                scratch, kCap, counter);
    __syncthreads();
    signed char* orow = out + static_cast<size_t>(b0 + i) * D + d0;
    for (int e = threadIdx.x; e < nd; e += blockDim.x) orow[e] = lanes[e];
    __syncthreads();  // the next query rewrites row
  }
}

}  // namespace

// levels (B, F) int32, contiguous; id_words (F, wc) and lv_words (m, wc)
// int32 bit-packed codebooks, wc = ceil(D / 32); out (B, D) int8. block_d a
// multiple of 32. Launches on stream, does not synchronise; returns the CUDA
// error of the launch (0 on success).
extern "C" int hd_encode_launch(const void* levels, int B, int F, int m,
                                const void* id_words, const void* lv_words,
                                int wc, int D, int block_b, int block_d,
                                void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a row of block_d lanes, the compacted pairs and their counter
  const int smem = block_d + static_cast<int>(sizeof(int2)) * kCap + 16;
  cudaError_t err = cudaFuncSetAttribute(
      hd_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int words = block_d / 32;
  const int threads =
      std::min(hd::kThreads, std::max(32, (words + 31) / 32 * 32));
  dim3 grid((B + block_b - 1) / block_b, (wc + words - 1) / words);
  hd_encode_kernel<<<grid, threads, smem, s>>>(
      static_cast<const int*>(levels), B, F, m,
      static_cast<const uint32_t*>(id_words),
      static_cast<const uint32_t*>(lv_words), wc, D, block_b, block_d,
      static_cast<signed char*>(out));
  return static_cast<int>(cudaGetLastError());
}
