// Analog PCM in-memory MVM model (SpecPCM Sec. III.C) on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/imc_mvm/imc_mvm.py
// _imc_mvm_kernel (launched by imc_mvm_pallas_call): packed queries
// (Q, Dp) float32 against programmed weights (R, Dp) float32 -> (Q, R)
// float32 through the array's analog chain. Per tile of tile_cols columns
// (one PCM array):
//   1. DAC: the query rounds half to even and clamps to +-dac_limit;
//   2. the tile's partial dot product, part = fmaf(a_c, w_c, part) for
//      c = 0 first: one rounding per column;
//   3. ADC: code = clamp(rint(part / lsb), +-adc_levels);
//   4. acc = fmaf(code, lsb, acc), tile by tile, t = 0 first, as the
//      reference's kernel accumulates.
// lsb = full_scale / adc_levels arrives computed (in double, rounded once
// to float32, as the reference's Python scalar is).
//
// Bound on the H100. At the tuner's served shape (Q = 32 against
// R = 581,196 iPRG2012 target rows, Dp = 2,731: 22 tiles, the last 43
// columns wide) the weights are 6.35 GB, 1.895 ms at 3.35 TB/s, and each
// weight feeds 32 products: 50.8 G fused multiply-adds, 1.52 ms at the
// 33.5 T FMA/s float32 (non-tensor) peak. Bytes and the FMA pipe are
// level, so the design reads the weights once and keeps the FMA pipe fed
// under the reads.
//
// Why fused partials. Each product as a separate rounded multiply and add
// issues two instructions, 3.0 ms at peak: no such kernel could beat one
// float32 matmul over the same tile dots (3.38 ms on the card). With one
// FMA per product the plain version still computes the same bits: the
// product of two float32 values is exact in float64, and a TwoSum with a
// round-to-odd step gives the correctly rounded fmaf in PyTorch
// (kernels/imc_mvm/ops.py:fma_f32). Tensor cores (TF32, bf16) would round
// the noisy weights and flip ADC codes, so the kernel stays float32 SIMT.
//
// Staging. Weight rows are Dp floats apart, 10,924 B at Dp = 2,731: not a
// multiple of 16, so a 2-D tensor map cannot describe them, and 4-byte
// copies cost an instruction a float. Each row's 32-column chunk is copied
// as the 16-byte-aligned quads that cover it (8 or 9, 16-byte cp.async)
// into a 144-byte slot, where it lands shifted by sh = (row Dp + col0)
// mod 4 floats. The weights are read in place: no padded copy is made;
// rows past R and bytes past the weights' end are zero-filled. A
// two-stage ring stages chunk g + 1 while chunk g is summed. A small
// pre-pass kernel DAC-rounds the queries once into a per-chunk layout
// (zero past Q, past each tile and past Dp), staged beside each chunk.
//
// Compute. A lane holds TQ consecutive queries (8 at block_q 32) by 4 rows
// r0 + tr + 8 j in registers; a warp covers 32 queries by 32 rows. A
// lane's rows share one shift (8 Dp is a multiple of 4), so it reads each
// row's weight for column c at slot offset sh + c, one 4-byte load that
// the 8 row lanes of a warp take from 8 distinct banks (slot stride 36
// floats), and the column's TQ queries as TQ / 4 16-byte broadcast
// loads: 4 + TQ / 4 loads for 4 TQ FMAs. Shared memory bounds this: a
// warp moves 12 wavefronts per 8 clocks of FMAs at block_q 32. An 8-row
// lane would balance the two but needs about 225 registers, which halves
// the warps an SM holds. The ADC step
// runs in registers at each tile's last chunk: part * (1 / lsb) decides
// the code whenever it is far from a half-integer, which is exact, and
// only the rest divides (IEEE __fdiv_rn, then rintf, half to even). No
// --use_fast_math; products and sums are __fmaf_rn.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTR = 4;       // weight rows a lane holds
constexpr int kChunk = 32;   // columns per stage
constexpr int kStages = 2;   // depth of the cp.async ring

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy of the first `valid` bytes of src, zero-filling the rest
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           unsigned valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The chunk layout of a launch: full tiles take per_tile chunks, the last
// tile as many as its columns need.
struct Chunks {
  int per_tile, count;
};

__host__ __device__ inline Chunks chunk_plan(int Dp, int tile_cols) {
  const int n_tiles = (Dp + tile_cols - 1) / tile_cols;
  const int per_tile = (tile_cols + kChunk - 1) / kChunk;
  const int last = Dp - (n_tiles - 1) * tile_cols;
  return {per_tile, (n_tiles - 1) * per_tile + (last + kChunk - 1) / kChunk};
}

constexpr int kSlot = kChunk + 4;       // floats of a row's slot
constexpr int kQuads = kSlot / 4;

// queries (Q, Dp) -> qd [Q / bq blocks][chunks][kChunk][bq], DAC-rounded
// and clamped; 0 past Q, past the tile's columns and past Dp
__global__ void imc_dac_kernel(const float* __restrict__ q, int Q, int Dp,
                               int tile_cols, Chunks ch, int bq, float dac,
                               float* __restrict__ qd, int64_t total) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int qi = static_cast<int>(e % bq);
    int64_t rest = e / bq;
    const int cc = static_cast<int>(rest % kChunk);
    rest /= kChunk;
    const int g = static_cast<int>(rest % ch.count);
    const int row = static_cast<int>(rest / ch.count) * bq + qi;
    const int t = g / ch.per_tile;
    const int tc = (g - t * ch.per_tile) * kChunk + cc;
    const int col = t * tile_cols + tc;
    float v = 0.f;
    if (row < Q && tc < tile_cols && col < Dp) {
      v = rintf(q[static_cast<size_t>(row) * Dp + col]);
      v = fminf(fmaxf(v, -dac), dac);
    }
    qd[e] = v;
  }
}

// Shared memory of one launch shape: the weight slots and the query
// stages.
template <int BQ, int BR>
struct Smem {
  static constexpr int kW = BR * kSlot * 4;            // bytes a stage
  static constexpr int kQ = kChunk * BQ * 4;
  static constexpr int kBytes = kStages * (kW + kQ);
};

// clamp(rint(part / lsb), +-adc_levels) with part / lsb rounded as IEEE
// division rounds it. q = part * rcp is within 2^-22.4 |part / lsb| of
// the rounded quotient, so for |q| < 2048 and q farther than 1e-3 from a
// half-integer both round to the same integer; past adc_levels + 1 both
// clamp alike. Only the rest (about 0.2% of random partials) divides.
__device__ __forceinline__ float adc_code(float part, float lsb, float rcp,
                                          float adc_levels) {
  const float q = part * rcp;
  float code = rintf(q);
  const float aq = fabsf(q);
  if (!(aq < 2048.f && fabsf(q - code) < 0.499f) && !(aq > adc_levels + 1.f))
    code = rintf(__fdiv_rn(part, lsb));
  return fminf(fmaxf(code, -adc_levels), adc_levels);
}

// TQ queries per lane (2, 4 or 8), WQ warps along the queries (1 or 2),
// WR warps along the rows (1, 2, 4 or 8): block_q = 4 TQ WQ,
// block_r = 32 WR.
template <int TQ, int WQ, int WR>
__global__ void __launch_bounds__(WQ * WR * 32)
    imc_mvm_kernel(const float* __restrict__ qd, const float* __restrict__ w,
                   int Q, int R, int Dp, int tile_cols, Chunks ch,
                   float adc_levels, float lsb, float* __restrict__ out) {
  constexpr int kThreads = WQ * WR * 32;
  constexpr int BQ = 4 * TQ * WQ;
  constexpr int BR = 8 * kTR * WR;
  using S = Smem<BQ, BR>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);   // [kStages][BR][kSlot]
  float* qsm = reinterpret_cast<float*>(smem + kStages * S::kW);
  // [kStages][kChunk][BQ]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wq = warp / WR;
  const int wr = warp - wq * WR;
  const int tq = lane >> 3;
  const int tr = lane & 7;
  const int qoff = wq * 4 * TQ + tq * TQ;   // first query of the lane, in block
  const int rfirst = wr * 8 * kTR + tr;          // lane's rows rfirst + 8 j
  const int r0 = blockIdx.x * BR;
  const float* qblock = qd + static_cast<size_t>(blockIdx.y) * ch.count *
                                 kChunk * BQ;
  // the weights end here; no copy reads past it
  const uintptr_t w_end = reinterpret_cast<uintptr_t>(
      w + static_cast<size_t>(R) * Dp);

  // chunk g into stage g % kStages: each row's aligned quads as 16-byte
  // copies (zero past R and past the weights' end), the queries as one
  // block; one commit group a chunk
  auto issue = [&](int g) {
    const int s = g % kStages;
    const int t = g / ch.per_tile;
    const int col0 = t * tile_cols + (g - t * ch.per_tile) * kChunk;
    for (int e = threadIdx.x; e < BR * kQuads; e += kThreads) {
      const int r = e / kQuads;
      const int k = e - r * kQuads;
      const uintptr_t a = reinterpret_cast<uintptr_t>(
          w + static_cast<size_t>(r0 + r) * Dp + col0);
      const uintptr_t src = (a & ~uintptr_t(15)) + 16 * k;
      // rows past R and quads past the weights read nothing
      const unsigned valid =
          r0 + r >= R || src >= w_end
              ? 0u
              : static_cast<unsigned>(w_end - src < 16 ? w_end - src : 16);
      cp_async16(wsm + (s * BR + r) * kSlot + 4 * k,
                 valid ? reinterpret_cast<const float*>(src) : w, valid);
    }
    const float* qsrc = qblock + static_cast<size_t>(g) * kChunk * BQ;
    float* qdst = qsm + s * kChunk * BQ;
    for (int e = threadIdx.x; e < kChunk * BQ / 4; e += kThreads)
      cp_async16(qdst + 4 * e, qsrc + 4 * e, 16);
  };
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < ch.count) issue(g);
    cp_async_commit();
  }

  const float rcp = __frcp_rn(lsb);
  float part[TQ][kTR];
  float acc[TQ][kTR];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < kTR; ++j) part[i][j] = acc[i][j] = 0.f;

  for (int g = 0; g < ch.count; ++g) {
    cp_async_wait<kStages - 2>();  // chunk g has landed (this thread's part)
    __syncthreads();  // ... all of it; stage (g - 1) % kStages is free
    if (g + kStages - 1 < ch.count) issue(g + kStages - 1);
    cp_async_commit();
    const int s = g % kStages;

    const int t = g / ch.per_tile;
    const int col0 = t * tile_cols + (g - t * ch.per_tile) * kChunk;
    // this lane's shift: its rows' chunks start sh floats into their slots
    const int sh = static_cast<int>(
        (reinterpret_cast<uintptr_t>(w + static_cast<size_t>(r0 + rfirst) *
                                             Dp + col0) >> 2) & 3);
    const float* ws = wsm + (s * BR + rfirst) * kSlot + sh;
    const float* qs = qsm + s * kChunk * BQ + qoff;
#pragma unroll 8
    for (int c = 0; c < kChunk; ++c) {
      const float* qa = qs + c * BQ;
      float a[TQ];
      if constexpr (TQ == 2) {
        const float2 v = *reinterpret_cast<const float2*>(qa);
        a[0] = v.x;
        a[1] = v.y;
      } else {
#pragma unroll
        for (int hq = 0; hq < TQ / 4; ++hq) {
          const float4 v = *reinterpret_cast<const float4*>(qa + 4 * hq);
          a[4 * hq] = v.x;
          a[4 * hq + 1] = v.y;
          a[4 * hq + 2] = v.z;
          a[4 * hq + 3] = v.w;
        }
      }
#pragma unroll
      for (int j = 0; j < kTR; ++j) {
        const float x = ws[8 * j * kSlot + c];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
          part[i][j] = __fmaf_rn(a[i], x, part[i][j]);
      }
    }

    if (g % ch.per_tile == ch.per_tile - 1 || g == ch.count - 1) {
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < kTR; ++j) {
          const float code = adc_code(part[i][j], lsb, rcp, adc_levels);
          acc[i][j] = __fmaf_rn(code, lsb, acc[i][j]);
          part[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qrow = blockIdx.y * BQ + qoff + i;
    if (qrow >= Q) continue;
    float* o = out + static_cast<size_t>(qrow) * R;
#pragma unroll
    for (int j = 0; j < kTR; ++j) {
      const int col = r0 + rfirst + 8 * j;
      if (col < R) o[col] = acc[i][j];
    }
  }
}

template <int TQ, int WQ, int WR>
cudaError_t launch(const float* q, const float* w, int Q, int R, int Dp,
                   int tile_cols, float dac, float adc, float lsb,
                   float* scratch, float* out, cudaStream_t s) {
  constexpr int BQ = 4 * TQ * WQ;
  constexpr int BR = 8 * kTR * WR;
  const int smem = Smem<BQ, BR>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      imc_mvm_kernel<TQ, WQ, WR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const Chunks ch = chunk_plan(Dp, tile_cols);
  const int n_qb = (Q + BQ - 1) / BQ;
  const int64_t total = static_cast<int64_t>(n_qb) * ch.count * kChunk * BQ;
  const int prep_blocks =
      static_cast<int>((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  imc_dac_kernel<<<prep_blocks, 256, 0, s>>>(q, Q, Dp, tile_cols, ch, BQ,
                                            dac, scratch, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((R + BR - 1) / BR, n_qb);
  imc_mvm_kernel<TQ, WQ, WR><<<grid, WQ * WR * 32, smem, s>>>(
      scratch, w, Q, R, Dp, tile_cols, ch, adc, lsb, out);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch a launch with this block_q needs: the DAC-rounded
// queries in their per-chunk layout.
extern "C" long long imc_mvm_scratch_floats(int Q, int Dp, int tile_cols,
                                            int block_q) {
  const int n_qb = (Q + block_q - 1) / block_q;
  return static_cast<long long>(n_qb) * chunk_plan(Dp, tile_cols).count *
         kChunk * block_q;
}

// queries (Q, Dp) and weights (R, Dp) float32, contiguous, the weights on
// a 16-byte boundary; out (Q, R) float32; scratch of
// imc_mvm_scratch_floats(Q, Dp, tile_cols, block_q) floats. block_q in
// {8, 16, 32, 64}, block_r in {32, 64, 128, 256}. lsb = full_scale /
// adc_levels in float32. Launches on stream, does not synchronise;
// returns the CUDA error of the launches (0 on success).
extern "C" int imc_mvm_launch(const void* queries, const void* weights,
                              int Q, int R, int Dp, int tile_cols,
                              int dac_limit, int adc_levels, float lsb,
                              int block_q, int block_r, void* scratch,
                              void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const float* w = static_cast<const float*>(weights);
  float* sc = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
  const float dac = static_cast<float>(dac_limit);
  const float adc = static_cast<float>(adc_levels);
  // (block_q, block_r) -> (TQ, WQ, WR)
#define IMC_CASE(BQ, TQ, WQ, WR)                                             \
  if (block_q == BQ && block_r == 8 * kTR * WR)                                   \
    return static_cast<int>(launch<TQ, WQ, WR>(q, w, Q, R, Dp, tile_cols,    \
                                               dac, adc, lsb, sc, o, s));
#define IMC_ROW(BQ, TQ, WQ) \
  IMC_CASE(BQ, TQ, WQ, 1) IMC_CASE(BQ, TQ, WQ, 2) IMC_CASE(BQ, TQ, WQ, 4) \
  IMC_CASE(BQ, TQ, WQ, 8)
  IMC_ROW(8, 2, 1) IMC_ROW(16, 4, 1) IMC_ROW(32, 8, 1) IMC_ROW(64, 8, 2)
#undef IMC_ROW
#undef IMC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
