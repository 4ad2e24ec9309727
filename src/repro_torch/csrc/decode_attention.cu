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
// Design: S split across blocks (flash-decoding), merged in the same
// launch. The TPU kernel runs one grid step per (b, n) and streams K/V in
// 512-position chunks through VMEM. One block per (b, n) is 128 blocks at
// the served shape, under one per SM, each streaming its 278 KB alone. Here
// the grid is (split, n, b): split j of a (b, n) pair owns the positions
// [j * per_split, (j + 1) * per_split), and the wrapper picks the split
// count from S and the SM count (never from valid_len, so a decode loop
// launches the same grid at every step): 3 splits of 363 positions at the
// served shape, 384 blocks, all resident at once (PERF.md: more, shorter
// splits lost to their blocks' start-up and merges). A 128-thread block
// (44 KB of shared memory at G = 7, hd = 128) walks its range in chunks of
// 64 positions:
//   1. q (with the first chunk), K and V rows and their scales stage
//      through a two-buffer cp.async ring, the next chunk's copies in
//      flight while this one is scored; rows past the walk stage as 0. K
//      rows keep their 16-byte segments swizzled by row (k_segment), so
//      the 16-byte loads of 8 neighbouring rows hit distinct banks;
//   2. logits: one thread per (position, group of 4 heads) dots 16 K
//      bytes at a time with the 4 heads' q (float32 in shared memory, read
//      as warp-wide broadcasts), 4 fmaf chains interleaved, each in hd
//      order, then scales and masks;
//   3. 16 lanes per head update the running max and denominator (expf,
//      not __expf, so the kernel rounds as the plain version does) and
//      leave w * v_scale in shared memory;
//   4. one thread per (2 columns, group of 4 heads) rescales its float32
//      accumulators (in shared memory) and adds the chunk's weighted V
//      columns, fmaf chains over the chunk's rows.
// Each int8 becomes a float once per thread that reads it, by a byte
// permute into the mantissa of 2^23 and one subtraction (exact), where a
// conversion instruction would run at a quarter of the rate.
// A block walks only up to valid_len: its m_j, l_j and acc_j are the
// running max, denominator and accumulator of its positions. A block whose
// range starts at or past valid_len (valid_len > 0) walks nothing and
// leaves m_j = -inf, l_j = 0, acc_j = 0. With valid_len = 0 every block
// walks its whole range on -1e30 logits, so the merge gives the uniform
// average over S.
//
// What bounds it (PERF.md, per-phase clock stamps on the H100): each warp
// waits on its own dependences (shared-memory loads, the conversion, the
// fmaf chains), about 0.3-0.5 instructions a clock, with the block
// barriers between phases; the last block of each pair adds its merge,
// several L2 round trips under the streaming load, to the kernel's end.
//
// Merge, in the same launch (one launch per layer on a step that the host's
// issue bounds): each block writes its partial (G x (hd + 2) floats) to a
// scratch that stays in L2, fences, and takes a ticket from its (b, n)
// pair's counter; the last block of the pair to arrive resets the counter
// for the next launch and computes, per head, m = max_j m_j and
//   out = sum_j acc_j exp(m_j - m) / max(sum_j l_j exp(m_j - m), 1e-30),
// where an empty split's exp(-inf - m) is exactly 0. The merge's table of
// m_j and l_j (2 * splits * G floats) reuses the block's shared memory,
// which bounds the split count (decode_attention_max_splits). The
// counters start at 0 and are left at 0 by every launch; launches sharing
// counters must run in order (one stream).
//
// The partial form (lse != nullptr; decode_attention_partial in ops.py)
// also writes each head's natural-log log-sum-exp lse = m + log(l) of the
// merged splits, so that a decode whose cache is cut into sequence blocks
// on several ranks combines the blocks' outputs: out = sum_r exp(lse_r -
// M) out_r / sum_r exp(lse_r - M). There valid_len = 0 is an empty block:
// every block walks nothing, the merge's m is -inf, its factors are taken
// as 0 (not exp(-inf + inf)), and it writes out = 0 and lse = -inf, which
// weighs exactly 0 in that combine.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;      // positions staged per step
constexpr int kNH = 4;          // heads a thread carries
constexpr int kMergeSplits = 4;  // splits whose partials the merge loads
                                 // at once
constexpr float kMasked = -1e30f;
constexpr float kMagic = 8388736.0f;  // 2^23 + 128

__host__ __device__ inline int padded_heads(int G) {
  return (G + kNH - 1) / kNH * kNH;
}

struct Smem {
  float* q;      // (Gp, hd)
  float* acc;    // (Gp / kNH, hd, kNH)
  float* lw;     // (Gp / kNH, kChunk, kNH): logits, then w * v_scale
  float* corr;   // (Gp,)
  float* m;      // (Gp,)
  float* denom;  // (Gp,)
  float* ks;     // (2, kChunk)
  float* vs;     // (2, kChunk)
  int8_t* k;     // (2, kChunk, hd), 16-byte segments swizzled by row
  int8_t* v;     // (2, kChunk, hd)
};

// floats of one split's partial, acc (G, hd) then m (G,) and l (G,),
// padded to 16 bytes
__host__ __device__ inline int partial_floats(int G, int hd) {
  return (G * (hd + 2) + 3) / 4 * 4;
}

__host__ __device__ inline size_t smem_bytes(int G, int hd) {
  const size_t Gp = padded_heads(G);
  const size_t floats = 2 * Gp * hd + Gp * kChunk + 3 * Gp + 4 * kChunk;
  return floats * 4 + 4 * static_cast<size_t>(kChunk) * hd;
}

// every array starts on a 16-byte boundary: Gp and kChunk are multiples of 4
__device__ inline Smem carve(unsigned char* base, int Gp, int hd) {
  Smem s;
  float* f = reinterpret_cast<float*>(base);
  s.q = f;
  f += Gp * hd;
  s.acc = f;
  f += Gp * hd;
  s.lw = f;
  f += Gp * kChunk;
  s.corr = f;
  f += Gp;
  s.m = f;
  f += Gp;
  s.denom = f;
  f += Gp;
  s.ks = f;
  f += 2 * kChunk;
  s.vs = f;
  f += 2 * kChunk;
  s.k = reinterpret_cast<int8_t*>(f);
  s.v = s.k + 2 * kChunk * hd;
  return s;
}

// int8 byte j of x as float, exactly: 0x4B0000uu is 2^23 + u for
// u = byte ^ 0x80 = value + 128
template <int J>
__device__ __forceinline__ float byte_to_float(uint32_t x80) {
  return __int_as_float(static_cast<int>(__byte_perm(x80, 0x4B000000u,
                                                     0x7650u + J))) -
         kMagic;
}

// 16 int8 (one 16-byte load) as floats
__device__ __forceinline__ void unpack16(uint4 raw, float (&f)[16]) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                         raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[4 * i + 0] = byte_to_float<0>(w[i]);
    f[4 * i + 1] = byte_to_float<1>(w[i]);
    f[4 * i + 2] = byte_to_float<2>(w[i]);
    f[4 * i + 3] = byte_to_float<3>(w[i]);
  }
}

// p[h] += w[h] * f for the kNH heads of one V column
__device__ __forceinline__ void pv_row(float4 w, float f, float (&p)[kNH]) {
  p[0] = fmaf(w.x, f, p[0]);
  p[1] = fmaf(w.y, f, p[1]);
  p[2] = fmaf(w.z, f, p[2]);
  p[3] = fmaf(w.w, f, p[3]);
}

// acc[h] = acc[h] * corr[h] + p[h] for the kNH heads of one column
__device__ __forceinline__ void rescale_add(float* acc, float4 corr,
                                            const float (&p)[kNH]) {
  float4 a = *reinterpret_cast<float4*>(acc);
  a.x = a.x * corr.x + p[0];
  a.y = a.y * corr.y + p[1];
  a.z = a.z * corr.z + p[2];
  a.w = a.w * corr.w + p[3];
  *reinterpret_cast<float4*>(acc) = a;
}

// one position's kNH logits: the dots scaled by the K scale, or masked
__device__ __forceinline__ void store_logits(const float (&dot)[kNH],
                                             bool valid, float sc, float* at) {
  float4 lg;
  lg.x = valid ? dot[0] * sc : kMasked;
  lg.y = valid ? dot[1] * sc : kMasked;
  lg.z = valid ? dot[2] * sc : kMasked;
  lg.w = valid ? dot[3] * sc : kMasked;
  *reinterpret_cast<float4*>(at) = lg;
}

// 16-byte segment seg of staged K row r sits at segment seg ^ (r & swz),
// swz + 1 the largest power of two up to 8 that divides the row's
// segments: at hd >= 128 the 8 rows a quarter-warp reads at once hit 8
// distinct bank groups
__device__ __forceinline__ int k_swizzle(int segs) {
  return min(segs & -segs, 8) - 1;
}

__device__ __forceinline__ int k_segment(int seg, int r, int swz) {
  return seg ^ (r & swz);
}

// rows [s0, s0 + kChunk) of one (b, n) slice of a (B, S, KV, hd) int8 K and
// V cache, and their scales, into the stage buffers; rows at or past end
// stage as 0 and read nothing.
__device__ inline void stage_chunk(const int8_t* __restrict__ kb,
                                   const int8_t* __restrict__ vb,
                                   const float* __restrict__ ksb,
                                   const float* __restrict__ vsb, int KV,
                                   int hd, int swz, int s0, int end,
                                   int8_t* kd, int8_t* vd, float* ksd,
                                   float* vsd) {
  const int segs = hd / 16;
  for (int e = threadIdx.x; e < kChunk * segs; e += kThreads) {
    const int r = e / segs;
    const int seg = e - r * segs;
    const bool ok = s0 + r < end;
    const size_t off =
        ok ? static_cast<size_t>(s0 + r) * KV * hd + seg * 16 : 0;
    sm90::cp_async16(
        reinterpret_cast<uint32_t*>(kd + r * hd + 16 * k_segment(seg, r, swz)),
        reinterpret_cast<const uint32_t*>(kb + off), ok);
    sm90::cp_async16(reinterpret_cast<uint32_t*>(vd + r * hd + seg * 16),
                     reinterpret_cast<const uint32_t*>(vb + off), ok);
  }
  for (int r = threadIdx.x; r < kChunk; r += kThreads) {
    const bool ok = s0 + r < end;
    const size_t off = ok ? static_cast<size_t>(s0 + r) * KV : 0;
    sm90::cp_async4(reinterpret_cast<uint32_t*>(ksd + r),
                    reinterpret_cast<const uint32_t*>(ksb + off), ok);
    sm90::cp_async4(reinterpret_cast<uint32_t*>(vsd + r),
                    reinterpret_cast<const uint32_t*>(vsb + off), ok);
  }
}

__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const int8_t* __restrict__ k8,
                        const int8_t* __restrict__ v8,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, int S, int KV,
                        int G, int hd, int valid_len, int per_split,
                        int splits, float* __restrict__ part,
                        unsigned* __restrict__ tickets,
                        float* __restrict__ out, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const int Gp = padded_heads(G);
  const Smem sm = carve(smem_raw, Gp, hd);
  const int split = blockIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int bn = b * KV + n;
  const int tid = threadIdx.x;
  const int ng = Gp / kNH;
  const int segs = hd / 16;
  const int swz = k_swizzle(segs);

  // q into (Gp, hd), the padded heads 0, with the first chunk's copies
  const float* qb = q + static_cast<size_t>(bn) * G * hd;
  for (int i = tid; i < Gp * hd / 4; i += kThreads) {
    const bool ok = 4 * i < G * hd;
    sm90::cp_async16(reinterpret_cast<uint32_t*>(sm.q + 4 * i),
                     reinterpret_cast<const uint32_t*>(ok ? qb + 4 * i : qb),
                     ok);
  }
  for (int i = tid; i < Gp * hd; i += kThreads) sm.acc[i] = 0.f;
  for (int g = tid; g < Gp; g += kThreads) {
    sm.m[g] = -INFINITY;
    sm.denom[g] = 0.f;
  }
  // the (b, n) slices: rows of KV * hd bytes, scales at a stride of KV
  const int8_t* kb = k8 + (static_cast<size_t>(b) * S * KV + n) * hd;
  const int8_t* vb = v8 + (static_cast<size_t>(b) * S * KV + n) * hd;
  const float* ksb = k_scale + static_cast<size_t>(b) * S * KV + n;
  const float* vsb = v_scale + static_cast<size_t>(b) * S * KV + n;
  // this split's positions, walked up to valid_len, or all of them when
  // every position is masked (none in the partial form: an empty block)
  const int begin = split * per_split;
  const int limit = valid_len > 0 ? min(valid_len, S) : (lse ? 0 : S);
  const int walk_end = min(min(S, begin + per_split), limit);
  const int nchunks = walk_end > begin
                          ? (walk_end - begin + kChunk - 1) / kChunk : 0;
  const int tile = kChunk * hd;

  if (nchunks > 0)
    stage_chunk(kb, vb, ksb, vsb, KV, hd, swz, begin, walk_end, sm.k, sm.v,
                sm.ks, sm.vs);
  sm90::cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = begin + c * kChunk;
    const int buf = c & 1;
    if (c + 1 < nchunks) {  // the other buffer was freed at the end of c - 1
      const int nb = buf ^ 1;
      stage_chunk(kb, vb, ksb, vsb, KV, hd, swz, s0 + kChunk, walk_end,
                  sm.k + nb * tile, sm.v + nb * tile, sm.ks + nb * kChunk,
                  sm.vs + nb * kChunk);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // chunk c (and q) have landed
    __syncthreads();
    const int8_t* kt = sm.k + buf * tile;
    const int8_t* vt = sm.v + buf * tile;
    const float* kst = sm.ks + buf * kChunk;
    const float* vst = sm.vs + buf * kChunk;
    const int rows = min(kChunk, walk_end - s0);

    // 2. logits: one thread per (row r, group gg of 4 heads)
    for (int e = tid; e < ng * kChunk; e += kThreads) {
      const int gg = e / kChunk;
      const int r = e - gg * kChunk;
      if (r >= rows) continue;
      const int8_t* kr = kt + r * hd;
      const float* qg = sm.q + gg * kNH * hd;
      float dot[kNH];
#pragma unroll
      for (int h = 0; h < kNH; ++h) dot[h] = 0.f;
#pragma unroll 2
      for (int seg = 0; seg < segs; ++seg) {
        float kf[16];
        unpack16(*reinterpret_cast<const uint4*>(
                     kr + 16 * k_segment(seg, r, swz)), kf);
        const float* qs = qg + 16 * seg;
#pragma unroll
        for (int j = 0; j < 16; j += 4) {
          float4 qq[kNH];
#pragma unroll
          for (int h = 0; h < kNH; ++h)
            qq[h] = *reinterpret_cast<const float4*>(qs + h * hd + j);
          // kNH independent chains, each in hd order
#pragma unroll
          for (int h = 0; h < kNH; ++h)
            dot[h] = fmaf(qq[h].x, kf[j + 0], dot[h]);
#pragma unroll
          for (int h = 0; h < kNH; ++h)
            dot[h] = fmaf(qq[h].y, kf[j + 1], dot[h]);
#pragma unroll
          for (int h = 0; h < kNH; ++h)
            dot[h] = fmaf(qq[h].z, kf[j + 2], dot[h]);
#pragma unroll
          for (int h = 0; h < kNH; ++h)
            dot[h] = fmaf(qq[h].w, kf[j + 3], dot[h]);
        }
      }
      store_logits(dot, s0 + r < valid_len, kst[r],
                   sm.lw + (gg * kChunk + r) * kNH);
    }
    __syncthreads();

    // 3. online softmax: 16 lanes per head (Gp is even, so both halves of
    // a warp stay in the loop together)
    for (int g = tid >> 4; g < Gp; g += kThreads / 16) {
      float* lg = sm.lw + (g / kNH) * kChunk * kNH + g % kNH;
      const int l16 = tid & 15;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kChunk / 16; ++i) {
        const int r = l16 + 16 * i;
        if (r < rows) mx = fmaxf(mx, lg[r * kNH]);
      }
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o, 16));
      const float m_old = sm.m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kChunk / 16; ++i) {
        const int r = l16 + 16 * i;
        if (r < rows) {
          const float p = expf(lg[r * kNH] - m_new);
          sum += p;
          lg[r * kNH] = p * vst[r];
        }
      }
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o, 16);
      if (l16 == 0) {
        const float corr = expf(m_old - m_new);
        sm.corr[g] = corr;
        sm.denom[g] = sm.denom[g] * corr + sum;
        sm.m[g] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * corr + w . V: one thread per (2 columns, group gg of 4
    // heads), each output an fmaf chain over the chunk's rows
    const int pairs = hd / 2;
    for (int e = tid; e < ng * pairs; e += kThreads) {
      const int gg = e / pairs;
      const int d = 2 * (e - gg * pairs);
      const float* w = sm.lw + gg * kChunk * kNH;
      const int8_t* vc = vt + d;
      float p0[kNH], p1[kNH];
#pragma unroll
      for (int h = 0; h < kNH; ++h) p0[h] = p1[h] = 0.f;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float4 w4 = *reinterpret_cast<const float4*>(w + r * kNH);
        const uint32_t x =
            *reinterpret_cast<const uint16_t*>(vc + r * hd) ^ 0x8080u;
        pv_row(w4, byte_to_float<0>(x), p0);
        pv_row(w4, byte_to_float<1>(x), p1);
      }
      const float4 c4 = *reinterpret_cast<const float4*>(sm.corr + gg * kNH);
      float* a = sm.acc + (gg * hd + d) * kNH;
      rescale_add(a, c4, p0);
      rescale_add(a + kNH, c4, p1);
    }
    __syncthreads();  // frees this chunk's buffers, lw and acc
  }
  sm90::cp_async_wait<0>();  // a block that walked nothing: q's copies
  __syncthreads();           // and the init are done

  // the partial: acc (G, hd), then m (G,), then l (G,)
  const int slab = partial_floats(G, hd);
  float* pb = part + (static_cast<size_t>(bn) * splits + split) * slab;
  for (int o = tid; o < G * hd; o += kThreads) {
    const int g = o / hd;
    const int d = o - g * hd;
    pb[o] = sm.acc[((g / kNH) * hd + d) * kNH + g % kNH];
  }
  for (int g = tid; g < G; g += kThreads) {
    pb[G * hd + g] = sm.m[g];
    pb[G * hd + G + g] = sm.denom[g];
  }
  __threadfence();  // the partial is visible device-wide before the ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bn, 1u) == splits - 1u;
  __syncthreads();
  if (!last) return;

  // the last block of (b, n): merge the splits. Their m_j and l_j are read
  // into shared memory at once (the block's dynamic shared memory is free
  // now), then per head m = max_j m_j, the factors exp(m_j - m) (in place)
  // and the denominator; each output then sums its splits' acc_j in split
  // order.
  __threadfence();
  if (tid == 0) tickets[bn] = 0u;
  const float* pbn = part + static_cast<size_t>(bn) * splits * slab;
  float* fm = reinterpret_cast<float*>(smem_raw);  // (splits, G)
  float* fl = fm + splits * G;                      // (splits, G)
  float* den = fl + splits * G;                     // (G,)
  for (int i = tid; i < splits * G; i += kThreads) {
    const int j = i / G;
    const int g = i - j * G;
    const float* pj = pbn + static_cast<size_t>(j) * slab + G * hd;
    fm[i] = __ldcg(pj + g);
    fl[i] = __ldcg(pj + G + g);
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float m = -INFINITY;
    for (int j = 0; j < splits; ++j) m = fmaxf(m, fm[j * G + g]);
    // m is -inf only when every split walked nothing (the partial form's
    // empty block): each factor is then 0
    const bool empty = m == -INFINITY;
    float l = 0.f;
    for (int j = 0; j < splits; ++j) {
      const float f = empty ? 0.f : expf(fm[j * G + g] - m);
      fm[j * G + g] = f;
      l += fl[j * G + g] * f;
    }
    den[g] = fmaxf(l, 1e-30f);
    if (lse) lse[static_cast<size_t>(bn) * G + g] = empty ? -INFINITY
                                                          : m + logf(l);
  }
  __syncthreads();
  // outputs in groups of 4 of one head (hd % 4 == 0), the 16-byte loads
  // of kMergeSplits splits in flight at once
  float4* ob =
      reinterpret_cast<float4*>(out + static_cast<size_t>(bn) * G * hd);
  for (int o4 = tid; o4 < G * hd / 4; o4 += kThreads) {
    const int g = 4 * o4 / hd;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < splits; j0 += kMergeSplits) {
      float4 v[kMergeSplits];
#pragma unroll
      for (int jj = 0; jj < kMergeSplits; ++jj)
        v[jj] = j0 + jj < splits
                    ? __ldcg(reinterpret_cast<const float4*>(
                          pbn + static_cast<size_t>(j0 + jj) * slab) + o4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int jj = 0; jj < kMergeSplits; ++jj) {
        if (j0 + jj >= splits) break;
        const float f = fm[(j0 + jj) * G + g];
        num.x += v[jj].x * f;
        num.y += v[jj].y * f;
        num.z += v[jj].z * f;
        num.w += v[jj].w * f;
      }
    }
    const float dn = den[g];
    ob[o4] = make_float4(num.x / dn, num.y / dn, num.z / dn, num.w / dn);
  }
}

}  // namespace

// Floats of one split's partial in the part scratch.
extern "C" int decode_attention_partial_floats(int G, int hd) {
  return partial_floats(G, hd);
}

// Dynamic shared memory one block needs for G heads of width hd.
extern "C" long long decode_attention_smem_bytes(int G, int hd) {
  return static_cast<long long>(smem_bytes(G, hd));
}

// The most splits whose merge table fits in that shared memory.
extern "C" int decode_attention_max_splits(int G, int hd) {
  return static_cast<int>((smem_bytes(G, hd) / 4 - G) / (2 * G));
}

// q (B, KV, G, hd) float32; k8, v8 (B, S, KV, hd) int8; k_scale, v_scale
// (B, S, KV) float32; out (B, KV, G, hd) float32; all contiguous, q and
// K/V on 16-byte boundaries, hd a multiple of 16. S is cut into `splits`
// ranges of per_split positions (splits = ceil(S / per_split)); part:
// (B * KV * splits, decode_attention_partial_floats(G, hd)) float32
// scratch; tickets: B * KV uint32 counters, 0 on entry and left 0; lse:
// null, or (B, KV, G) float32 for the partial form (the header).
// Launches on stream, does not synchronise; returns the CUDA error of the
// launch (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k8,
                                       const void* v8, const void* k_scale,
                                       const void* v_scale, int B, int S,
                                       int KV, int G, int hd, int valid_len,
                                       int per_split, int splits, void* part,
                                       void* tickets, void* out, void* lse,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = smem_bytes(G, hd);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(splits, KV, B);
  decode_attention_kernel<<<grid, kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), S, KV, G, hd, valid_len, per_split,
      splits, static_cast<float*>(part), static_cast<unsigned*>(tickets),
      static_cast<float*>(out), static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}
