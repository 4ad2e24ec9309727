// The Eq. 1 encoder of the port (sm_90a): hd_encode.cu's kernel and the
// encode phase of both fused routes of encode_search.cu.
//
//   out[b, d] = sign( sum_f [levels[b, f] > 0] LV[min(levels[b, f], m - 1), d]
//                                               * ID[f, d] ),  sign(0) = -1,
//
// written as packed words (MODE kPacked, bit 1 for +1) or int8 +-1 lanes
// (kInt8). The codebooks arrive bit-packed (+1 -> bit 1; pad bits 0),
// id_words (F, wc) and lv_words (m, wc), wc = ceil(D / 32). The product
// LV[l, d] * ID[f, d] is +1 exactly when the two bits agree, so over the n
// present features of a query acc[d] = 2 * agree[d] - n, and acc[d] > 0
// exactly when agree[d] > n / 2: agree[d] is counted exactly for 32 dims
// at once in 16 bit-sliced counter planes (sliced_add / sliced_greater).
//
// Bound on the H100: bytes, and at the served batch (B = 32, F = 1,024,
// D = 8,192) not even those (128 KB of levels, 1 MB of packed codebooks,
// 256 KB out: under a microsecond). Two latency chains set its time: the
// compaction of a query's present features and the codebook loads.
//
// Design: a block of 256 threads owns block_b queries by a range of wpb
// 32-dim words (grid (queries / block_b, words / wpb): at the default
// 64 words a B = 32, D = 8,192 launch is 128 blocks, one an SM). For each
// of its queries it compacts the present (feature, level) pairs once:
// every thread loads its run of up to 32 consecutive levels in 16-byte
// vectors (all in flight at once), and a warp scan of the per-thread
// counts plus the warps' totals place each pair, in feature order,
// without atomics. Then the 256 threads split into 256 / ws slices of ws
// word-threads (ws = wpb rounded up to a warp): each thread counts one
// word over every slices-th pair, 16 pairs' codebook words in flight at
// once, so at 64 words a block each thread counts about a quarter of a
// query's features (about 13 at 5% of 1,024 bins) in one round of loads.
// The slices' counter planes are summed exactly through shared memory
// (bit-sliced ripple adds), and the first slice signs the words and
// stores them as words or, for int8 rows, as two 16-byte vectors a word.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace hd {

namespace enc {

constexpr int kPlanes = 16;       // bit-sliced counter planes: counts up to
                                  // 65535 features
constexpr int kThreads = 256;     // a block
constexpr int kVecs = 8;          // 16-byte level loads a thread a round
constexpr int kCap = 4096;        // features compacted a round at most
constexpr int kInFlight = 16;     // features counted at once
constexpr int kModePacked = 0;
constexpr int kModeInt8 = 1;

// Adds word x into the bit-sliced per-dim counters (ripple carry).
__device__ __forceinline__ void sliced_add(uint32_t (&planes)[kPlanes],
                                           uint32_t x) {
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const uint32_t carry = planes[p] & x;
    planes[p] ^= x;
    x = carry;
    if (!x) break;
  }
}

// Per-dim bit: counter > t, compared plane by plane from the top.
__device__ __forceinline__ uint32_t sliced_greater(
    const uint32_t (&planes)[kPlanes], uint32_t t) {
  uint32_t gt = 0u, eq = 0xffffffffu;
#pragma unroll
  for (int p = kPlanes - 1; p >= 0; --p) {
    if ((t >> p) & 1u) {
      eq &= planes[p];
    } else {
      gt |= eq & planes[p];
      eq &= ~planes[p];
    }
  }
  return gt;
}

// Bits 4t .. 4t + 3 of `bits` as four int8 lanes, 0x01 for a set bit and
// 0xFF (-1) for a clear one.
__device__ __forceinline__ uint32_t lanes4(uint32_t bits, int t) {
  const uint32_t nib = (bits >> (4 * t)) & 0xFu;
  const uint32_t e = (nib * 0x00204081u) & 0x01010101u;  // bit j -> byte j
  return e * 0xFFFFFF02u + 0xFFFFFFFFu;                   // byte b -> 2b - 1
}

// Features compacted a round by a block of kThreads.
constexpr int kRound = 4 * kVecs * kThreads < kCap ? 4 * kVecs * kThreads
                                                   : kCap;

// Word-threads of a slice for blocks of wpb words: wpb rounded up to a
// warp, at most kThreads; the block's kThreads / that slices each count
// every slices-th present feature of the same words.
__host__ __device__ __forceinline__ int slice_words(int wpb) {
  const int w = (wpb + 31) / 32 * 32;
  return w < kThreads ? w : kThreads;
}

// Shared bytes of a block: the round's pairs, the warps' counts and the
// counter planes of every slice but the first.
inline size_t smem_bytes(int wpb) {
  const int ws = slice_words(wpb);
  return sizeof(int2) * kRound + sizeof(int) * 32 +
         sizeof(uint32_t) * (kThreads / ws - 1) * kPlanes * ws;
}

// Compacts the present (feature, min(level, m - 1)) pairs of levels
// [f0, f1) of one query row into pairs, in feature order; returns their
// count (the same in every thread). Thread t takes a run of 4 * vecs
// consecutive features (vecs <= kVecs). Must be called by the whole block.
__device__ __forceinline__ int compact(const int* __restrict__ lrow, int F,
                                       int m, int f0, int f1, int vecs,
                                       int2* pairs, int* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const int fb = f0 + threadIdx.x * 4 * vecs;
  int lv[4 * kVecs];
  const bool vec = (F & 3) == 0 &&  // rows on a 16-byte boundary
                   (reinterpret_cast<uintptr_t>(lrow) & 15) == 0;
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int f = fb + 4 * u;
    if (u < vecs && vec && f + 4 <= f1) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(lrow + f));
      lv[4 * u] = v.x;
      lv[4 * u + 1] = v.y;
      lv[4 * u + 2] = v.z;
      lv[4 * u + 3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        lv[4 * u + j] = u < vecs && f + j < f1 ? __ldg(lrow + f + j) : 0;
    }
  }
  unsigned present = 0u;  // bit i: feature fb + i is present
#pragma unroll
  for (int i = 0; i < 4 * kVecs; ++i) present |= (lv[i] > 0 ? 1u : 0u) << i;
  const int mine = __popc(present);
  int incl = mine;  // inclusive scan over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int c = wsum[w];
    base += w < warp ? c : 0;
    total += c;
  }
  int pos = base + incl - mine;
#pragma unroll
  for (int i = 0; i < 4 * kVecs; ++i) {
    if ((present >> i) & 1u)
      pairs[pos++] = make_int2(fb + i, min(lv[i], m - 1));
  }
  __syncthreads();  // the pairs are complete; wsum may be rewritten
  return total;
}

// Block (x, y): queries [x * block_b, + block_b) by words [y * wpb, + wpb).
// Thread t counts word w0 + t % ws (ws = slice_words(wpb)) over the present
// features e = t / ws, + slices, ...; the slices' counters are summed into
// the first slice's, which signs and stores them. out: (B, wc) int32 words
// (MODE kModePacked) or (B, D) int8 lanes.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const int* __restrict__ levels, int B, int F, int m,
                  const uint32_t* __restrict__ id_words,
                  const uint32_t* __restrict__ lv_words, int wc, int D,
                  int block_b, int wpb, void* __restrict__ out) {
  extern __shared__ __align__(16) int2 pairs[];
  int* wsum = reinterpret_cast<int*>(pairs + kRound);
  uint32_t* red = reinterpret_cast<uint32_t*>(wsum + 32);
  const int ws = slice_words(wpb);
  const int slices = kThreads / ws;
  const int slice = threadIdx.x / ws;
  const int wl = threadIdx.x - slice * ws;
  // 16-byte loads a thread a round: enough for F, within the round
  const int vecs = max(1, min(kRound / (4 * kThreads),
                              (F + 4 * kThreads - 1) / (4 * kThreads)));
  const int per = 4 * vecs * kThreads;  // features a round
  const int w_lo = blockIdx.y * wpb;
  const int w_hi = min(wc, w_lo + wpb);
  for (int i = 0; i < block_b; ++i) {
    const int b = blockIdx.x * block_b + i;
    if (b >= B) break;  // block-uniform
    const int* lrow = levels + static_cast<size_t>(b) * F;
    for (int w0 = w_lo; w0 < w_hi; w0 += ws) {
      const int w = w0 + wl;
      const bool word = w < w_hi;
      uint32_t planes[kPlanes];
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) planes[p] = 0u;
      int total = 0;
      for (int f0 = 0; f0 < F; f0 += per) {
        const int n = compact(lrow, F, m, f0, min(F, f0 + per), vecs, pairs,
                              wsum);
        total += n;
        if (word) {
          for (int e0 = slice; e0 < n; e0 += slices * kInFlight) {
            // every load issued before any is used: past n re-read the
            // last pair and count nothing
            uint32_t a[kInFlight], c[kInFlight];
#pragma unroll
            for (int u = 0; u < kInFlight; ++u) {
              const int2 fl = pairs[min(e0 + u * slices, n - 1)];
              a[u] = __ldg(id_words + static_cast<size_t>(fl.x) * wc + w);
              c[u] = __ldg(lv_words + static_cast<size_t>(fl.y) * wc + w);
            }
#pragma unroll
            for (int u = 0; u < kInFlight; ++u)
              sliced_add(planes, e0 + u * slices < n ? ~(a[u] ^ c[u]) : 0u);
          }
        }
        __syncthreads();  // the next round rewrites the pairs
      }
      if (slices > 1 && total > 0) {  // block-uniform: fold the slices'
                                       // counters
        if (slice > 0) {
#pragma unroll
          for (int p = 0; p < kPlanes; ++p)
            red[((slice - 1) * kPlanes + p) * ws + wl] = planes[p];
        }
        __syncthreads();
        if (slice == 0) {
          for (int s2 = 1; s2 < slices; ++s2) {
            uint32_t carry = 0u;
#pragma unroll
            for (int p = 0; p < kPlanes; ++p) {
              const uint32_t x = planes[p];
              const uint32_t y = red[((s2 - 1) * kPlanes + p) * ws + wl];
              planes[p] = x ^ y ^ carry;
              carry = (x & y) | (carry & (x ^ y));
            }
          }
        }
        __syncthreads();  // red is rewritten by the next word pass
      }
      if (slice > 0 || !word) continue;
      const uint32_t bits =
          sliced_greater(planes, static_cast<uint32_t>(total) >> 1);
      if (MODE == kModePacked) {
        static_cast<uint32_t*>(out)[static_cast<size_t>(b) * wc + w] = bits;
      } else {
        unsigned char* row =
            static_cast<unsigned char*>(out) + static_cast<size_t>(b) * D;
        if ((D & 15) == 0 && 32 * w + 32 <= D) {
          uint4* dst = reinterpret_cast<uint4*>(row + 32 * w);
          dst[0] = make_uint4(lanes4(bits, 0), lanes4(bits, 1),
                              lanes4(bits, 2), lanes4(bits, 3));
          dst[1] = make_uint4(lanes4(bits, 4), lanes4(bits, 5),
                              lanes4(bits, 6), lanes4(bits, 7));
        } else {
          for (int j = 0; j < 32 && 32 * w + j < D; ++j)
            row[32 * w + j] = ((bits >> j) & 1u) ? 0x01 : 0xFF;
        }
      }
    }
  }
}

}  // namespace enc

// Launches the encoder over B queries on stream s: block_b queries and
// wpb 32-dim words a block; mode 0 writes (B, wc) packed words, mode 1
// (B, D) int8 lanes. Returns the launch's CUDA error.
inline cudaError_t launch_encode_rows(const int* levels, int B, int F, int m,
                                      const uint32_t* id_words,
                                      const uint32_t* lv_words, int wc, int D,
                                      int block_b, int wpb, int mode,
                                      void* out, cudaStream_t s) {
  const size_t smem = enc::smem_bytes(wpb);
  dim3 grid((B + block_b - 1) / block_b, (wc + wpb - 1) / wpb);
  if (mode == enc::kModePacked) {
    enc::encode_kernel<enc::kModePacked><<<grid, enc::kThreads, smem, s>>>(
        levels, B, F, m, id_words, lv_words, wc, D, block_b, wpb, out);
  } else {
    enc::encode_kernel<enc::kModeInt8><<<grid, enc::kThreads, smem, s>>>(
        levels, B, F, m, id_words, lv_words, wc, D, block_b, wpb, out);
  }
  return cudaGetLastError();
}

}  // namespace hd
