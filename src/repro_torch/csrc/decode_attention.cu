// One-token GQA decode attention over an int8 KV store, on Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py _decode_attn_kernel
// (launched by decode_attention_pallas_call). Per (batch b, kv head n), for
// the G query heads of the group and the positions s < valid_len:
//   logits[g, s] = (q[g] . k8[s]) * k_scale[s]          (float32)
//   w = softmax_s(logits)                                (online, float32)
//   out[g]       = sum_s (w[g, s] * v_scale[s]) * v8[s]
// with out = acc / max(denom, 1e-30), as the TPU kernel computes it: the
// scale multiplies after the dot, masked positions take -1e30, and the
// running max, denominator and accumulator are float32. q arrives already
// rope'd and multiplied by head_dim**-0.5. valid_len = 0 masks every
// position, and the softmax of S equal -1e30 logits is uniform over all S
// (the plain version gives the same).
//
// Bound on the H100: bytes. At the served shape (B = 32, S = 1,088, KV = 4,
// G = 7, hd = 128) a launch must read the int8 K and V rows below valid_len
// (up to 35.7 MB) and their float32 scales (1.1 MB): about 0.011 ms at
// 3.35 TB/s, against 0.48 GFLOP of float32 work (0.007 ms at 67 TFLOP/s).
//
// Design. The TPU kernel runs one grid step per (b, n) and streams K/V in
// 512-position chunks through VMEM, on a cache the wrapper first pads to a
// multiple of the chunk. Here one 256-thread block owns one (b, n) pair
// (grid KV x B) and walks S in chunks of 64 positions:
//   1. stage the chunk's K and V rows in shared memory with 16-byte loads
//      (one 128-byte row = 8 threads), rows at a 4-byte padded stride so the
//      threads of a warp, one position each, read distinct banks; rows past
//      S stage as 0, so any S is taken with no padding copy;
//   2. one thread per (g, s) dots q[g] (float32 in shared memory, read as a
//      warp-wide broadcast) with the int8 row, in hd order, then scales and
//      masks;
//   3. one warp per head updates the running max and denominator over the
//      chunk (expf, not __expf, so the kernel rounds as the plain version
//      does) and leaves w * v_scale in shared memory;
//   4. one thread per (g, d) output rescales its float32 accumulator (kept
//      in shared memory) and adds the chunk's weighted V column.
// Chunks wholly at or past valid_len are skipped: their weights are
// exp(-1e30 - m) = 0 exactly. The running max starts at -inf; the first
// chunk always holds a valid position (or, for valid_len = 0, only -1e30
// logits), so it is finite from then on and exp(m_old - m_new) never sees
// -inf - (-inf). With B x KV = 128 blocks at the served shape the card is
// under one block per SM and each block streams its 278 KB alone: this
// design stays well short of the bytes bound; splitting S across blocks
// with a merge pass (flash-decoding) is the redesign.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;   // positions staged per step
constexpr float kMasked = -1e30f;

struct Smem {
  float* q;      // (G, hd)
  float* acc;    // (G, hd)
  float* lw;     // (G, kChunk): logits, then w * v_scale
  float* ks;     // (kChunk,)
  float* vs;     // (kChunk,)
  float* m;      // (G,)
  float* denom;  // (G,)
  float* corr;   // (G,)
  int8_t* k;     // (kChunk, hd + 4)
  int8_t* v;     // (kChunk, hd + 4)
};

__host__ __device__ inline size_t smem_bytes(int G, int hd) {
  const size_t floats = 2 * static_cast<size_t>(G) * hd +
                        static_cast<size_t>(G) * kChunk + 2 * kChunk + 3 * G;
  return floats * 4 + 2 * static_cast<size_t>(kChunk) * (hd + 4);
}

__device__ inline Smem carve(unsigned char* base, int G, int hd) {
  Smem s;
  float* f = reinterpret_cast<float*>(base);
  s.q = f;
  f += G * hd;
  s.acc = f;
  f += G * hd;
  s.lw = f;
  f += G * kChunk;
  s.ks = f;
  f += kChunk;
  s.vs = f;
  f += kChunk;
  s.m = f;
  f += G;
  s.denom = f;
  f += G;
  s.corr = f;
  f += G;
  s.k = reinterpret_cast<int8_t*>(f);
  s.v = s.k + kChunk * (hd + 4);
  return s;
}

// rows [s0, s0 + kChunk) of one (b, n) slice of a (B, S, KV, hd) int8 cache
// into a shared tile of row stride hd + 4; rows past S are zero.
__device__ inline void stage_rows(const int8_t* __restrict__ src, int S,
                                  int KV, int hd, int s0, int8_t* dst) {
  const int segs = hd / 16;
  const int stride = hd + 4;
  for (int e = threadIdx.x; e < kChunk * segs; e += kThreads) {
    const int r = e / segs;
    const int seg = e - r * segs;
    int4 val = make_int4(0, 0, 0, 0);
    if (s0 + r < S) {
      val = __ldg(reinterpret_cast<const int4*>(
          src + static_cast<size_t>(s0 + r) * KV * hd + seg * 16));
    }
    int* d = reinterpret_cast<int*>(dst + r * stride + seg * 16);
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const int8_t* __restrict__ k8,
                        const int8_t* __restrict__ v8,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, int S, int KV,
                        int G, int hd, int valid_len,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, G, hd);
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int GH = G * hd;
  const int stride = hd + 4;

  const float* qb = q + (static_cast<size_t>(b) * KV + n) * GH;
  for (int i = tid; i < GH; i += kThreads) {
    sm.q[i] = qb[i];
    sm.acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    sm.m[g] = -INFINITY;
    sm.denom[g] = 0.f;
  }
  // the (b, n) slices: rows of KV * hd bytes, scales at a stride of KV
  const int8_t* kb = k8 + (static_cast<size_t>(b) * S * KV + n) * hd;
  const int8_t* vb = v8 + (static_cast<size_t>(b) * S * KV + n) * hd;
  const float* ksb = k_scale + static_cast<size_t>(b) * S * KV + n;
  const float* vsb = v_scale + static_cast<size_t>(b) * S * KV + n;
  // positions to walk: up to valid_len, or all S when every one is masked
  const int limit = valid_len > 0 ? min(valid_len, S) : S;

  for (int s0 = 0; s0 < limit; s0 += kChunk) {
    __syncthreads();  // the previous chunk's tiles are consumed
    stage_rows(kb, S, KV, hd, s0, sm.k);
    stage_rows(vb, S, KV, hd, s0, sm.v);
    for (int r = tid; r < kChunk; r += kThreads) {
      const bool in = s0 + r < S;
      sm.ks[r] = in ? ksb[static_cast<size_t>(s0 + r) * KV] : 0.f;
      sm.vs[r] = in ? vsb[static_cast<size_t>(s0 + r) * KV] : 0.f;
    }
    __syncthreads();

    // 2. logits: one thread per (g, s), s fastest
    for (int e = tid; e < G * kChunk; e += kThreads) {
      const int g = e / kChunk;
      const int r = e - g * kChunk;
      const float* qg = sm.q + g * hd;
      const int8_t* kr = sm.k + r * stride;
      float dot = 0.f;
      for (int d = 0; d < hd; d += 4) {
        const char4 c = *reinterpret_cast<const char4*>(kr + d);
        const float4 qq = *reinterpret_cast<const float4*>(qg + d);
        dot = fmaf(qq.x, static_cast<float>(c.x), dot);
        dot = fmaf(qq.y, static_cast<float>(c.y), dot);
        dot = fmaf(qq.z, static_cast<float>(c.z), dot);
        dot = fmaf(qq.w, static_cast<float>(c.w), dot);
      }
      const int pos = s0 + r;
      const bool valid = pos < valid_len && pos < S;
      sm.lw[e] = valid ? dot * sm.ks[r] : kMasked;
    }
    __syncthreads();

    // 3. online softmax: one warp per head
    const int rows = min(kChunk, S - s0);
    for (int g = warp; g < G; g += kThreads / 32) {
      float* lg = sm.lw + g * kChunk;
      float mx = -INFINITY;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, lg[r]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm.m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < kChunk; r += 32) {
        float p = 0.f;
        if (r < rows) p = expf(lg[r] - m_new);
        sum += p;
        lg[r] = p * sm.vs[r];
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sm.corr[g] = corr;
        sm.denom[g] = sm.denom[g] * corr + sum;
        sm.m[g] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * corr + w . V: one thread per (g, d)
    for (int o = tid; o < GH; o += kThreads) {
      const int g = o / hd;
      const int d = o - g * hd;
      const float* w = sm.lw + g * kChunk;
      float part = 0.f;
      for (int r = 0; r < rows; ++r)
        part = fmaf(w[r], static_cast<float>(sm.v[r * stride + d]), part);
      sm.acc[o] = sm.acc[o] * sm.corr[g] + part;
    }
  }
  __syncthreads();
  float* ob = out + (static_cast<size_t>(b) * KV + n) * GH;
  for (int o = tid; o < GH; o += kThreads)
    ob[o] = sm.acc[o] / fmaxf(sm.denom[o / hd], 1e-30f);
}

}  // namespace

// Dynamic shared memory one block needs for G heads of width hd.
extern "C" long long decode_attention_smem_bytes(int G, int hd) {
  return static_cast<long long>(smem_bytes(G, hd));
}

// q (B, KV, G, hd) float32; k8, v8 (B, S, KV, hd) int8; k_scale, v_scale
// (B, S, KV) float32; out (B, KV, G, hd) float32; all contiguous, K/V on
// 16-byte boundaries, hd a multiple of 16. Launches on stream, does not
// synchronise; returns the CUDA error of the launch (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k8,
                                       const void* v8, const void* k_scale,
                                       const void* v_scale, int B, int S,
                                       int KV, int G, int hd, int valid_len,
                                       void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = smem_bytes(G, hd);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KV, B);
  decode_attention_kernel<<<grid, kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), S, KV, G, hd, valid_len,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
