// Shared device code of the HD search kernels (sm_90a).
//
// * the ordered top-k list: (value desc, index asc), kept in shared memory
//   per query and fed by a warp at a time (better / list_insert / warp_offer);
// * the row loads (load_word / load_quad / load_queries) and the word score
//   (word_score: XOR + popcount on the POPC pipe for packed words, __dp4a
//   for int8);
// * the streaming tile scorer over a range of bank rows (scan_rows), on
//   which the exact scan runs in int8 mode and in 8-query packed blocks
//   (hd_exact_scan.cuh; its 16- and 32-query packed blocks score on the
//   int8 tensor cores);
// * the split merge (merge_splits_kernel).
//
// topk_hamming.cu and encode_search.cu include this file (through
// hd_exact_scan.cuh and hd_banded_scan.cuh); each builds into its own
// shared library with a plain C entry point.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace hd {

constexpr int kThreads = 256;                   // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerLane = 4;
constexpr int kTileRows = 32 * kRowsPerLane;    // bank rows per tile
constexpr int kChunkWords = 32;                 // words of a row staged at once
constexpr int kTileStride = kChunkWords + 4;    // padded: 16-byte loads of
                                                // 8 neighbouring rows hit
                                                // 32 distinct banks
constexpr int kTileWords = kTileRows * kTileStride;

enum Mode { kPacked = 0, kInt8 = 1 };

// Strict total order of candidates: higher value first, then lower row.
__device__ __forceinline__ bool better(int v, int i, int tv, int ti) {
  return v > tv || (v == tv && i < ti);
}

// Insert (v, i) into a sorted list of length k, best first. One thread.
__device__ __forceinline__ void list_insert(int* lv, int* li, int k, int v,
                                            int i) {
  if (!better(v, i, lv[k - 1], li[k - 1])) return;
  int p = k - 1;
  while (p > 0 && better(v, i, lv[p - 1], li[p - 1])) {
    lv[p] = lv[p - 1];
    li[p] = li[p - 1];
    --p;
  }
  lv[p] = v;
  li[p] = i;
}

// Initial slots (INT_MIN, base + slot): any real row, masked or not,
// beats them, since real rows lie below base.
__device__ __forceinline__ void list_init(int* lv, int* li, int n, int k,
                                          int base) {
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    lv[s] = INT_MIN;
    li[s] = base + s % k;
  }
}

// Every lane of a warp offers one candidate (or none). Candidates that beat
// the list's last slot are inserted one at a time by lane 0; the order of
// insertion does not change the final list, because the order is total.
// The whole warp must call this.
__device__ __forceinline__ void warp_offer(int* lv, int* li, int k,
                                           bool active, int v, int i) {
  const int lane = threadIdx.x & 31;
  unsigned mask =
      __ballot_sync(0xffffffffu, active && better(v, i, lv[k - 1], li[k - 1]));
  while (mask) {
    const int src = __ffs(mask) - 1;
    const int sv = __shfl_sync(0xffffffffu, v, src);
    const int si = __shfl_sync(0xffffffffu, i, src);
    if (lane == 0) list_insert(lv, li, k, sv, si);
    __syncwarp();
    mask &= mask - 1;
  }
}

// Word w (4 bytes) of a row of row_bytes bytes; bytes past the row are 0.
__device__ __forceinline__ uint32_t load_word(const unsigned char* row, int w,
                                              int row_bytes) {
  const int b0 = 4 * w;
  if ((row_bytes & 3) == 0) {
    return b0 < row_bytes
               ? __ldg(reinterpret_cast<const uint32_t*>(row) + w)
               : 0u;
  }
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (b0 + j < row_bytes) x |= static_cast<uint32_t>(__ldg(row + b0 + j))
                                 << (8 * j);
  }
  return x;
}

// Words [4*wq, 4*wq + 4) of a row, 16-byte loads where the row allows.
__device__ __forceinline__ uint4 load_quad(const unsigned char* row, int wq,
                                           int row_bytes) {
  if ((row_bytes & 15) == 0) {
    return 16 * wq < row_bytes
               ? __ldg(reinterpret_cast<const uint4*>(row) + wq)
               : make_uint4(0u, 0u, 0u, 0u);
  }
  return make_uint4(load_word(row, 4 * wq, row_bytes),
                    load_word(row, 4 * wq + 1, row_bytes),
                    load_word(row, 4 * wq + 2, row_bytes),
                    load_word(row, 4 * wq + 3, row_bytes));
}

template <int MODE>
__device__ __forceinline__ int word_score(uint32_t a, uint32_t b, int acc) {
  if (MODE == kPacked) return acc + __popc(a ^ b);
  return __dp4a(static_cast<int>(a), static_cast<int>(b), acc);
}

// One tile chunk into registers: thread t stages quad (t & 7) of rows
// (t >> 3) + 32p, p = 0..3, so 8 neighbouring threads read one row's
// 128 contiguous bytes.
__device__ __forceinline__ void load_chunk(uint4 (&pf)[4],
                                           const unsigned char* r,
                                           int row_bytes, int tile0,
                                           int row_end, int chunk) {
  const int quad = threadIdx.x & 7;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int row = tile0 + (threadIdx.x >> 3) + 32 * p;
    pf[p] = row < row_end
                ? load_quad(r + static_cast<size_t>(row) * row_bytes,
                            chunk * (kChunkWords / 4) + quad, row_bytes)
                : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_chunk(const uint4 (&pf)[4],
                                            uint32_t* rt) {
  const int quad = threadIdx.x & 7;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int row = (threadIdx.x >> 3) + 32 * p;
    *reinterpret_cast<uint4*>(rt + row * kTileStride + 4 * quad) = pf[p];
  }
}

// Rows q0 .. q0 + nq - 1 of q into the shared query block qs (stride
// qstride words, zero past each row and past nq).
__device__ __forceinline__ void load_queries(const unsigned char* q, int q0,
                                             int nq, int bq, int row_bytes,
                                             int wpr, int qstride,
                                             uint32_t* qs) {
  for (int e = threadIdx.x; e < bq * qstride; e += blockDim.x) {
    const int qi = e / qstride;
    const int w = e - qi * qstride;
    qs[e] = (qi < nq && w < wpr)
                ? load_word(q + static_cast<size_t>(q0 + qi) * row_bytes, w,
                            row_bytes)
                : 0u;
  }
}

// Streams bank rows [row_begin, row_end) against the block's BQ = 8 * QPT
// resident query rows qs (stride qstride words, zero past the row) and
// offers the scored rows to the owning warp's per-query top-k lists.
// Warp w owns queries w*QPT .. w*QPT + QPT - 1; lane l scores rows
// tile0 + l + 32j. Rows at or past num_valid score INT_MIN but stay
// candidates. Must be called by the whole block.
template <int MODE, int QPT>
__device__ void scan_rows(const uint32_t* qs, int qstride, int nq,
                          const unsigned char* r, int row_bytes, int wpr,
                          int row_begin, int row_end, int num_valid, int dim,
                          uint32_t* rt, int* lv, int* li, int k) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nchunks = (wpr + kChunkWords - 1) / kChunkWords;
  for (int tile0 = row_begin; tile0 < row_end; tile0 += kTileRows) {
    const int tile1 = min(tile0 + kTileRows, row_end);
    int acc[QPT][kRowsPerLane];
#pragma unroll
    for (int a = 0; a < QPT; ++a)
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) acc[a][j] = 0;

    uint4 pf[4];
    load_chunk(pf, r, row_bytes, tile0, row_end, 0);
    for (int c = 0; c < nchunks; ++c) {
      __syncthreads();  // the previous chunk's readers are done with rt
      store_chunk(pf, rt);
      __syncthreads();
      if (c + 1 < nchunks) load_chunk(pf, r, row_bytes, tile0, row_end, c + 1);
      const int cw = min(kChunkWords, wpr - c * kChunkWords);
      const int nquads = (cw + 3) / 4;
      for (int wq = 0; wq < nquads; ++wq) {
        uint4 rv[kRowsPerLane];
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j)
          rv[j] = *reinterpret_cast<const uint4*>(
              rt + (lane + 32 * j) * kTileStride + 4 * wq);
#pragma unroll
        for (int a = 0; a < QPT; ++a) {
          const uint4 qv = *reinterpret_cast<const uint4*>(
              qs + (warp * QPT + a) * qstride + c * kChunkWords + 4 * wq);
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) {
            int s = acc[a][j];
            s = word_score<MODE>(qv.x, rv[j].x, s);
            s = word_score<MODE>(qv.y, rv[j].y, s);
            s = word_score<MODE>(qv.z, rv[j].z, s);
            s = word_score<MODE>(qv.w, rv[j].w, s);
            acc[a][j] = s;
          }
        }
      }
    }

#pragma unroll
    for (int a = 0; a < QPT; ++a) {
      const int qloc = warp * QPT + a;
      if (qloc >= nq) continue;  // warp-uniform
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const int row = tile0 + lane + 32 * j;
        int s = MODE == kPacked ? dim - 2 * acc[a][j] : acc[a][j];
        if (row >= num_valid) s = INT_MIN;
        warp_offer(lv + qloc * k, li + qloc * k, k, row < tile1, s, row);
      }
    }
  }
}

// Writes the block's lists to the (Q, splits, k) candidate buffers. Each
// warp writes the queries it owns.
template <int QPT>
__device__ void write_candidates(const int* lv, const int* li, int k, int q0,
                                 int nq, int split, int splits, int* cv,
                                 int* ci) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncwarp();
#pragma unroll
  for (int a = 0; a < QPT; ++a) {
    const int qloc = warp * QPT + a;
    if (qloc >= nq) continue;
    const size_t base =
        (static_cast<size_t>(q0 + qloc) * splits + split) * static_cast<size_t>(k);
    for (int s = lane; s < k; s += 32) {
      cv[base + s] = lv[qloc * k + s];
      ci[base + s] = li[qloc * k + s];
    }
  }
}

// Second pass: one warp per query folds its splits * k candidates into the
// final (value desc, index asc) top-k. Dynamic shared memory: 2 * kWarps * k
// ints.
__global__ void __launch_bounds__(kThreads)
    merge_splits_kernel(const int* __restrict__ cv, const int* __restrict__ ci,
                        int Q, int n, int k, int R, int* __restrict__ ov,
                        int* __restrict__ oi) {
  extern __shared__ int merge_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* lv = merge_smem + warp * k;
  int* li = merge_smem + kWarps * k + warp * k;
  list_init(merge_smem, merge_smem + kWarps * k, kWarps * k, k, R);
  __syncthreads();
  const int q = blockIdx.x * kWarps + warp;
  if (q >= Q) return;  // warp-uniform; no block barrier follows
  const size_t base = static_cast<size_t>(q) * n;
  for (int e0 = 0; e0 < n; e0 += 32) {
    const int e = e0 + lane;
    const bool active = e < n;
    warp_offer(lv, li, k, active, active ? cv[base + e] : 0,
               active ? ci[base + e] : 0);
  }
  __syncwarp();
  for (int s = lane; s < k; s += 32) {
    ov[static_cast<size_t>(q) * k + s] = lv[s];
    oi[static_cast<size_t>(q) * k + s] = li[s];
  }
}

// Launches merge_splits_kernel over (Q, splits, k) candidates on stream s;
// returns the launch's CUDA error.
inline cudaError_t launch_merge(const int* cv, const int* ci, int Q,
                                int splits, int k, int R, int* ov, int* oi,
                                cudaStream_t s) {
  const size_t smem = sizeof(int) * 2 * kWarps * static_cast<size_t>(k);
  cudaError_t err = cudaFuncSetAttribute(
      merge_splits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  merge_splits_kernel<<<(Q + kWarps - 1) / kWarps, kThreads, smem, s>>>(
      cv, ci, Q, splits * k, k, R, ov, oi);
  return cudaGetLastError();
}

}  // namespace hd
