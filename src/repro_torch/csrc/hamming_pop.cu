// Full bit-packed Hamming similarity on Hopper (sm_90a), on the int8
// tensor cores (wgmma).
//
// Replaces the TPU kernel src/repro/kernels/hamming_pop/hamming_pop.py
// _hamming_kernel (launched by hamming_pop_pallas_call): for packed
// bipolar rows q (Q, W) and r (R, W) of 32-bit words, the whole (Q, R)
// matrix dim - popcount(q ^ r), int32. It is the distance step of
// clustering: a served batch against the centroid bank, and all pairs of
// a precursor bucket.
//
// Bound on the H100. Expanded to +-1, the score is an int8 dot product:
// with each bit b as 2b - 1, <q, r> = 32 W - 2 popcount(q ^ r), so
// dim - popcount(q ^ r) = dim - (32 W - <q, r>) / 2, exact in int32 for
// any dim and whatever the padding bits hold. The int8 tensor cores run
// 1,979 dense TOP/s; the output is written once. At one paper-sized
// bucket (Q = R = 10,624, W = 64) that is 462 G int8 ops (0.234 ms)
// against a 451 MB write (0.135 ms): operations. At a served batch
// (Q <= 32 against a few thousand centroids) both are microseconds and
// the launch dominates. The POPC pipe (16 a clock per SM) caps any
// XOR + POPC design at 1.73 ms for the bucket, and the warp-level
// mma.sync path reaches only part of the int8 peak on Hopper, so the
// design uses the warpgroup MMA.
//
// Design. Operands stay packed in device memory (1/8 of the unpacked
// bytes) and stream through shared memory in 8-word chunks, a
// three-stage cp.async ring (16-byte copies when W % 4 == 0 and both
// operands start on 16 bytes, else 4-byte ones; rows past Q or R and
// words past W stage as 0). One word is one k = 32 step of
// wgmma.mma_async.m64n128k32.s32.s8.s8: a block of two warpgroups owns
// 128 queries by 128 bank rows. The bank side (B) is expanded once per block
// into shared memory in the no-swizzle K-major layout (8-row x 16-byte
// core matrices) that the wgmma descriptor reads; the query side (A) is
// expanded by each warp straight into its register fragments. In both,
// k-slot s (4 bytes) of a word holds bits s, s + 8, s + 16, s + 24: one
// shift and mask, then one multiply-add turns bytes b in {0, 1} into
// 2b - 1 (255 - 254 b, no carries). The dot does not depend on which bit
// sits in which k-slot, as long as both operands agree. Words staged past
// W are 0 on both sides, so they add +1 x 32 to the dot; the formula uses
// the staged word count, which cancels them. The expansion of chunk g + 1
// runs while chunk g's eight wgmmas are in flight (two expanded buffers);
// both warpgroups read the one expanded bank tile, which halves the
// expansion work per output against one warpgroup a block.
// The epilogue writes each accumulator pair as one 8-byte store: a warp
// store fills 8 whole 32-byte sectors.
#include "sm90.cuh"

namespace {

constexpr int kChunk = 8;     // words staged per pipeline stage
constexpr int kStride = 12;   // shared row stride in words: 16-byte
                              // aligned, 8 rows in 8 distinct bank quads
constexpr int kStages = 3;    // depth of the cp.async ring
constexpr int kGroups = 2;    // warpgroups a block, 64 queries each
constexpr int kThreads = 128 * kGroups;
constexpr int BM = 64 * kGroups;  // queries a block
constexpr int BN = 128;       // bank rows a block
constexpr int kStep = BN * 32;            // bytes of one expanded k-step
constexpr int kExp = kChunk * kStep;      // bytes of one expanded chunk

using namespace sm90;

__device__ __forceinline__ void wgmma_s8(int (&acc)[64], const uint32_t (&a)[4],
                                         uint64_t d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, {%64,%65,%66,%67}, %68, p;\n"
      "}\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]), "+r"(acc[12]), "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15]), "+r"(acc[16]), "+r"(acc[17]), "+r"(acc[18]), "+r"(acc[19]), "+r"(acc[20]), "+r"(acc[21]), "+r"(acc[22]), "+r"(acc[23]), "+r"(acc[24]), "+r"(acc[25]), "+r"(acc[26]), "+r"(acc[27]), "+r"(acc[28]), "+r"(acc[29]), "+r"(acc[30]), "+r"(acc[31]), "+r"(acc[32]), "+r"(acc[33]), "+r"(acc[34]), "+r"(acc[35]), "+r"(acc[36]), "+r"(acc[37]), "+r"(acc[38]), "+r"(acc[39]), "+r"(acc[40]), "+r"(acc[41]), "+r"(acc[42]), "+r"(acc[43]), "+r"(acc[44]), "+r"(acc[45]), "+r"(acc[46]), "+r"(acc[47]), "+r"(acc[48]), "+r"(acc[49]), "+r"(acc[50]), "+r"(acc[51]), "+r"(acc[52]), "+r"(acc[53]), "+r"(acc[54]), "+r"(acc[55]), "+r"(acc[56]), "+r"(acc[57]), "+r"(acc[58]), "+r"(acc[59]), "+r"(acc[60]), "+r"(acc[61]), "+r"(acc[62]), "+r"(acc[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(d), "r"(1));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    hamming_pop_kernel(const uint32_t* __restrict__ q,
                       const uint32_t* __restrict__ r, int Q, int R, int W,
                       int dim, int* __restrict__ out) {
  constexpr int ASTAGE = BM * kStride;
  constexpr int BSTAGE = BN * kStride;
  extern __shared__ __align__(128) unsigned char smem[];
  // [2][kChunk][BN / 8][2][8][16 B] expanded bank rows, then the packed ring
  unsigned char* exp = smem;
  uint32_t* As = reinterpret_cast<uint32_t*>(smem + 2 * kExp);
  uint32_t* Bs = As + kStages * ASTAGE;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;     // fragment row
  const int tig = lane & 3;    // k-slots tig and 4 + tig
  const int q0 = blockIdx.y * BM;
  const int r0 = blockIdx.x * BN;
  const int n_chunks = (W + kChunk - 1) / kChunk;

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  fence_regs(acc);

  auto stage = [&](int buf, int ch) {
    stage_rows<VEC, kThreads, kChunk, kStride>(q, Q, W, q0, BM, ch * kChunk,
                                               As + buf * ASTAGE);
    stage_rows<VEC, kThreads, kChunk, kStride>(r, R, W, r0, BN, ch * kChunk,
                                               Bs + buf * BSTAGE);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) stage(s, s);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ch staged; wgmma of ch - 2 long done
    {
      // bank row n = threadIdx.x % BN: kChunk / kGroups of its words, each
      // 32 bytes of +-1
      const int n = threadIdx.x % BN;
      const int kw0 = threadIdx.x / BN * (kChunk / kGroups);
      const uint32_t* src = Bs + (ch % kStages) * BSTAGE + n * kStride;
      unsigned char* dst = exp + (ch & 1) * kExp + (n >> 3) * 256 + (n & 7) * 16;
#pragma unroll
      for (int kw = kw0; kw < kw0 + kChunk / kGroups; ++kw) {
        uint4 lo, hi;
        expand_word(src[kw], lo, hi);
        *reinterpret_cast<uint4*>(dst + kw * kStep) = lo;
        *reinterpret_cast<uint4*>(dst + kw * kStep + 128) = hi;
      }
    }
    // the previous chunk's wgmmas are done: their fragments may change
    wgmma_wait<0>();
    // the expanded rows, written by the generic proxy, are read by wgmma
    fence_proxy_async();
    __syncthreads();
    const int next = ch + kStages - 1;
    if (next < n_chunks) stage(next % kStages, next);
    cp_async_commit();

    // warp w of the block holds query rows 16 w .. 16 w + 15
    const uint32_t* as =
        As + (ch % kStages) * ASTAGE + (warp * 16 + g) * kStride;
    const unsigned eb = smem_u32(exp + (ch & 1) * kExp);
    uint32_t a[kChunk][4];
#pragma unroll
    for (int kw = 0; kw < kChunk; ++kw) {
      const uint32_t lo = as[kw] >> tig;
      const uint32_t hi = as[8 * kStride + kw] >> tig;
      a[kw][0] = pm1(lo);
      a[kw][1] = pm1(hi);
      a[kw][2] = pm1(lo >> 4);
      a[kw][3] = pm1(hi >> 4);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kw = 0; kw < kChunk; ++kw)
      wgmma_s8(acc, a[kw], desc(eb + kw * kStep));
    wgmma_commit();
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // dot over the staged words: 32 x staged - dot = 2 popcount(q ^ r)
  const int staged_bits = 32 * kChunk * n_chunks;
  const bool pairs = (R & 1) == 0;  // 8-byte stores stay aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= Q) continue;
    int* orow = out + static_cast<size_t>(row) * R;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = r0 + 8 * j + 2 * tig;
      const int v0 = dim - ((staged_bits - acc[4 * j + 2 * h]) >> 1);
      const int v1 = dim - ((staged_bits - acc[4 * j + 2 * h + 1]) >> 1);
      if (pairs && col + 1 < R) {
        *reinterpret_cast<int2*>(orow + col) = make_int2(v0, v1);
      } else {
        if (col < R) orow[col] = v0;
        if (col + 1 < R) orow[col + 1] = v1;
      }
    }
  }
}

constexpr int kSmem = 2 * kExp + kStages * (BM + BN) * kStride * 4;

}  // namespace

// q (Q, W) and r (R, W) int32 bit-views of packed words, contiguous; out
// (Q, R) int32. vec: 16-byte copies (W % 4 == 0 and both operands on
// 16-byte boundaries). Launches on stream, does not synchronise; returns
// the CUDA error of the launch (0 on success).
extern "C" int hamming_pop_launch(const void* q, const void* r, int Q, int R,
                                  int W, int dim, int vec, void* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = vec ? hamming_pop_kernel<true> : hamming_pop_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + BN - 1) / BN, (Q + BM - 1) / BM);
  kernel<<<grid, kThreads, kSmem, s>>>(static_cast<const uint32_t*>(q),
                                       static_cast<const uint32_t*>(r), Q, R,
                                       W, dim, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
