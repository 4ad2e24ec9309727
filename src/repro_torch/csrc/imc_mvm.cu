// Analog PCM in-memory MVM model (SpecPCM Sec. III.C) on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/imc_mvm/imc_mvm.py
// _imc_mvm_kernel (launched by imc_mvm_pallas_call): packed queries
// (Q, Dp) float32 against programmed weights (R, Dp) float32 -> (Q, R)
// float32 through the array's analog chain. Per tile of tile_cols columns
// (one PCM array):
//   1. DAC: the query rounds half to even and clamps to +-dac_limit;
//   2. the tile's partial dot product in float32;
//   3. ADC: code = clamp(rint(part / lsb), +-adc_levels);
//   4. out = code * lsb + out, tile by tile, t = 0 first, one rounding
//      each (a fused multiply-add, as the reference's kernel accumulates).
// lsb = full_scale / adc_levels arrives computed (in double, rounded once
// to float32, as the reference's Python scalar is).
//
// Bound on the H100: bytes. At the tuner's served shape (Q = 32 against
// R = 581,196 iPRG2012 target rows, Dp = 2,731) the weights are 6.35 GB,
// 1.895 ms at 3.35 TB/s; the 101.6 GFLOP of dot products take 1.52 ms at
// the 66.9 TFLOP/s float32 (non-tensor) peak. This design does not reach
// the bytes bound: to keep every partial's products and sums rounded as
// the plain version rounds them it issues a separate multiply and add per
// product (no FMA contraction), which halves the float32 rate (3.0 ms). Tensor
// cores (TF32, bf16) would round the noisy weights and flip ADC codes, so
// the kernel stays float32 SIMT.
//
// Design. The TPU kernel owns a (bq, br) output block and loops over the
// 128-column tiles with the MXU. Here a 256-thread block owns a
// (8 TQ) x (32 TR) output tile: warp w holds queries w + 8 i, lane l rows
// l + 32 j, each thread TQ x TR outputs in registers. Per column tile the
// block stages its DAC-rounded query slice (row-major: a warp reads one
// address, a broadcast) and its weight slice (column-major with a padded
// stride: lanes read neighbouring words) in shared memory, then walks the
// tile's columns in order, c = 0 first, for every output, a rounded
// multiply and a rounded add each. So a partial sum's order and rounding
// depend on tile_cols alone, never on the output tile: any tile shape
// gives the same bits, and so does the plain version. Weights are read
// once per query tile: once in all at Q <= 8 TQ. Columns past Dp and rows
// past Q or R stage as 0: a zero partial quantizes to a zero code, so the
// wrapper makes no padded copies. No --use_fast_math: the division is IEEE
// (__fdiv_rn), rounding is rintf (half to even), the partials use
// __fmul_rn / __fadd_rn and the accumulation __fmaf_rn.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int TQ, int TR>
__global__ void __launch_bounds__(kThreads)
    imc_mvm_kernel(const float* __restrict__ q, const float* __restrict__ w,
                   int Q, int R, int Dp, int tile_cols, int n_tiles,
                   float dac_limit, float adc_levels, float lsb,
                   float* __restrict__ out) {
  constexpr int BQ = 8 * TQ;
  constexpr int BR = 32 * TR;
  constexpr int WS = BR + 1;  // padded stride of a staged weight column
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][tile_cols]
  float* ws = qs + BQ * tile_cols;     // [tile_cols][WS]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * BQ;
  const int r0 = blockIdx.x * BR;

  float acc[TQ][TR];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * tile_cols;
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < BQ * tile_cols; e += kThreads) {
      const int qi = e / tile_cols;
      const int c = e - qi * tile_cols;
      float v = 0.f;
      if (q0 + qi < Q && c0 + c < Dp) {
        v = rintf(__ldg(q + static_cast<size_t>(q0 + qi) * Dp + c0 + c));
        v = fminf(fmaxf(v, -dac_limit), dac_limit);
      }
      qs[e] = v;
    }
    for (int e = threadIdx.x; e < BR * tile_cols; e += kThreads) {
      const int ri = e / tile_cols;
      const int c = e - ri * tile_cols;
      ws[c * WS + ri] = (r0 + ri < R && c0 + c < Dp)
                            ? __ldg(w + static_cast<size_t>(r0 + ri) * Dp +
                                    c0 + c)
                            : 0.f;
    }
    __syncthreads();

    float part[TQ][TR];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) part[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < tile_cols; ++c) {
      float a[TQ], b[TR];
#pragma unroll
      for (int i = 0; i < TQ; ++i) a[i] = qs[(warp + 8 * i) * tile_cols + c];
#pragma unroll
      for (int j = 0; j < TR; ++j) b[j] = ws[c * WS + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j)
          part[i][j] = __fadd_rn(part[i][j], __fmul_rn(a[i], b[j]));
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        float code = rintf(__fdiv_rn(part[i][j], lsb));
        code = fminf(fmaxf(code, -adc_levels), adc_levels);
        acc[i][j] = __fmaf_rn(code, lsb, acc[i][j]);
      }
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int row = q0 + warp + 8 * i;
    if (row >= Q) continue;
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int col = r0 + lane + 32 * j;
      if (col < R) out[static_cast<size_t>(row) * R + col] = acc[i][j];
    }
  }
}

template <int TQ, int TR>
cudaError_t launch(const float* q, const float* w, int Q, int R, int Dp,
                   int tile_cols, float dac_limit, float adc_levels,
                   float lsb, float* out, cudaStream_t s) {
  const size_t smem = sizeof(float) * static_cast<size_t>(tile_cols) *
                      (8 * TQ + 32 * TR + 1);
  cudaError_t err = cudaFuncSetAttribute(
      imc_mvm_kernel<TQ, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_tiles = (Dp + tile_cols - 1) / tile_cols;
  dim3 grid((R + 32 * TR - 1) / (32 * TR), (Q + 8 * TQ - 1) / (8 * TQ));
  imc_mvm_kernel<TQ, TR><<<grid, kThreads, smem, s>>>(
      q, w, Q, R, Dp, tile_cols, n_tiles, dac_limit, adc_levels, lsb, out);
  return cudaGetLastError();
}

}  // namespace

// queries (Q, Dp) and weights (R, Dp) float32, contiguous; out (Q, R)
// float32. block_q in {8, 16, 32, 64}, block_r in {32, 64, 128, 256}; the
// shared tiles take 4 * tile_cols * (block_q + block_r + 1) bytes. lsb =
// full_scale / adc_levels in float32. Launches on stream, does not
// synchronise; returns the CUDA error of the launch (0 on success).
extern "C" int imc_mvm_launch(const void* queries, const void* weights,
                              int Q, int R, int Dp, int tile_cols,
                              int dac_limit, int adc_levels, float lsb,
                              int block_q, int block_r, void* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  const float dac = static_cast<float>(dac_limit);
  const float adc = static_cast<float>(adc_levels);
  // (block_q / 8, block_r / 32) -> the compiled (TQ, TR) instantiation
#define IMC_CASE(TQ, TR)                                                     \
  if (block_q == 8 * TQ && block_r == 32 * TR)                               \
    return static_cast<int>(launch<TQ, TR>(q, w, Q, R, Dp, tile_cols, dac,    \
                                           adc, lsb, o, s));
#define IMC_ROW(TQ) \
  IMC_CASE(TQ, 1) IMC_CASE(TQ, 2) IMC_CASE(TQ, 4) IMC_CASE(TQ, 8)
  IMC_ROW(1) IMC_ROW(2) IMC_ROW(4) IMC_ROW(8)
#undef IMC_ROW
#undef IMC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
