// Full bit-packed Hamming similarity on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hamming_pop/hamming_pop.py
// _hamming_kernel (launched by hamming_pop_pallas_call): for packed
// bipolar rows q (Q, W) and r (R, W) of 32-bit words, the whole (Q, R)
// matrix dim - popcount(q ^ r), int32. It is the distance step of
// clustering: a served batch against the centroid bank, and all pairs of
// a precursor bucket.
//
// Bound on the H100. The score is a +-1 dot product
// (dim - popcount(q ^ r) = (dim + <q, r>) / 2), which the int8 tensor cores
// compute exactly at 1,979 dense TOP/s; the output is written once. At one
// paper-sized bucket (Q = R = 10,624, W = 64) that is 462 G int8 ops
// (0.234 ms) against a 451 MB write (0.135 ms): operations. At a served
// batch (Q <= 32 against a few thousand centroids) both are microseconds
// and the launch dominates. This design does not reach the operations
// bound: it scores on the POPC pipe (one XOR, one POPC, one add per
// query-row-word; the pipe runs 16 POPC per clock per SM), about 1.7 ms
// at the bucket. A tensor-core version is the next step.
//
// Design. The TPU kernel owns a (128, 128) output block per grid step and
// loops over 32-word chunks in VMEM. Here a 256-thread block owns a
// 64 x 64 output tile; both operands' rows stream through shared memory in
// 32-word chunks (row stride 33 words, so the 16 rows a warp reads at one
// word fall in 16 distinct banks), and each thread accumulates a 4 x 4
// register tile, rows ty + 16 i and columns tx + 16 j, so one shared load
// feeds four XOR + POPC. Ragged Q, R and W are masked in the kernel: words
// past W and rows past Q or R stage as 0, and only in-range outputs are
// stored, so the wrapper makes no padded copies. Rows are read in 16-byte
// loads when W % 4 == 0 and both operands start on 16 bytes, else in
// 4-byte loads.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;              // output rows and columns per block
constexpr int kChunk = 32;             // words of a row staged at once
constexpr int kStride = kChunk + 1;    // padded shared row stride
constexpr int kPer = 4;                // outputs per thread along each axis
constexpr int kSide = kTile / kPer;    // 16 threads along each axis

// Words [w0, w0 + kChunk) of rows [row0, row0 + kTile) of a (rows, W) word
// matrix into the shared tile s; zero past W and past rows.
template <bool VEC>
__device__ __forceinline__ void stage(const uint32_t* __restrict__ m,
                                      int rows, int W, int row0, int w0,
                                      uint32_t* s) {
  if (VEC) {
    constexpr int kQuads = kChunk / 4;
    for (int e = threadIdx.x; e < kTile * kQuads; e += kThreads) {
      const int row = e / kQuads;
      const int quad = e - row * kQuads;
      const int w = w0 + 4 * quad;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + row < rows && w < W) {  // W % 4 == 0: whole quad in range
        v = __ldg(reinterpret_cast<const uint4*>(
            m + static_cast<size_t>(row0 + row) * W + w));
      }
      uint32_t* d = s + row * kStride + 4 * quad;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
      const int row = e / kChunk;
      const int c = e - row * kChunk;
      const int w = w0 + c;
      s[row * kStride + c] =
          (row0 + row < rows && w < W)
              ? __ldg(m + static_cast<size_t>(row0 + row) * W + w)
              : 0u;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    hamming_pop_kernel(const uint32_t* __restrict__ q,
                       const uint32_t* __restrict__ r, int Q, int R, int W,
                       int dim, int* __restrict__ out) {
  __shared__ uint32_t qs[kTile * kStride];
  __shared__ uint32_t rs[kTile * kStride];
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int q0 = blockIdx.y * kTile;
  const int r0 = blockIdx.x * kTile;

  int acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0;

  for (int w0 = 0; w0 < W; w0 += kChunk) {
    stage<VEC>(q, Q, W, q0, w0, qs);
    stage<VEC>(r, R, W, r0, w0, rs);
    __syncthreads();
    const uint32_t* qa = qs + ty * kStride;
    const uint32_t* ra = rs + tx * kStride;
    // words past W staged as 0 on both sides: XOR 0, popcount 0
#pragma unroll 8
    for (int c = 0; c < kChunk; ++c) {
      uint32_t a[kPer], b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = qa[i * kSide * kStride + c];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = ra[j * kSide * kStride + c];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] += __popc(a[i] ^ b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + i * kSide;
    if (row >= Q) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = r0 + tx + j * kSide;
      if (col < R) out[static_cast<size_t>(row) * R + col] = dim - acc[i][j];
    }
  }
}

}  // namespace

// q (Q, W) and r (R, W) int32 bit-views of packed words, contiguous; out
// (Q, R) int32. vec: 16-byte loads (W % 4 == 0 and both operands on 16-byte
// boundaries). Launches on stream, does not synchronise; returns the CUDA
// error of the launch (0 on success).
extern "C" int hamming_pop_launch(const void* q, const void* r, int Q, int R,
                                  int W, int dim, int vec, void* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((R + kTile - 1) / kTile, (Q + kTile - 1) / kTile);
  auto kernel = vec ? hamming_pop_kernel<true> : hamming_pop_kernel<false>;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint32_t*>(q),
                                   static_cast<const uint32_t*>(r), Q, R, W,
                                   dim, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
