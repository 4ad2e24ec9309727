// The banded search scan of topk_hamming.cu and encode_search.cu (sm_90a):
// per (query group, block) the k best rows of the block's bank tiles
// inside each query's own [start, end) bands, by (score desc, row asc),
// into the block's candidate slots; hd::launch_merge folds the blocks'
// slots. starts/ends are (nbands, Q), ascending disjoint bands per query,
// already clipped to the valid rows, so no row past them is offered.
//
// Bound on the H100: bytes, the distinct bank rows inside any band read
// once; this design's own floor is the POPC pipe (one XOR, one POPC and
// one add per in-band query-row-word at 16 POPC per clock per SM; __dp4a
// for int8 rows).
//
// Design: bank-major. A block holds a group of up to 32 queries (32 KB at
// 256 words a row), their bands and one top-k list per query in shared
// memory; larger batches run in groups on grid axis y. The group's window
// (lowest band start to highest band end) is cut into 32-row tiles, and
// block x of the group's gridDim.x blocks walks tiles x, x + gridDim.x, ...
// (interleaved, so dense and sparse precursor regions spread over every
// block), skipping tiles that no band meets. Each live tile is read from
// device memory once, by one block: warp 0 walks the tiles and its lanes
// issue one bulk copy (TMA) a row into a 2-stage ring of padded rows,
// completing on the stage's mbarrier, with a record of the stage's tile,
// chunk and live queries beside it, so the other warps spend no
// instructions on loads or on finding tiles. In a stage lane l owns row
// l, and warp w of the 16 the 16-word slice [16 w, 16 w + 16) of every
// row: it keeps its slice of the row in registers and scores it against
// every query live on the tile (a ballot over the group's lanes), the
// query words one broadcast load a quad. So all 16 warps score whenever
// any band meets the tile, and each adds its slice's sums into a shared
// (live query, row) buffer. One stage later, after the stage barrier, one
// warp a live query offers that query's 32 rows to its list (one ballot),
// while the other warps score the next tile into the second buffer: a
// list is written by one warp at a time, and the offers overlap the
// scoring. Two blocks fit an SM (107 KB each at 32 queries of 256 words):
// 32 warps to hide the latency of each warp's chain of shared loads,
// POPCs and shared atomics, which, with the per-stage work around it, set
// this scan's time on the H100 (PERF.md). Rows wider than 256 words take
// several stages a tile, their sums accumulating in the same buffer. The
// merge over blocks is exact because each band row is offered once and
// the order is total.
#pragma once

#include "hd_common.cuh"
#include "sm90.cuh"

namespace hd {

namespace band {

constexpr int kGroup = 32;        // queries a block holds (a ballot lane each)
constexpr int kRows = 32;         // bank rows a tile: one a lane
constexpr int kChunk = 256;       // words of a row one stage holds
constexpr int kBlockWarps = 16;   // warps a block: one word slice each
constexpr int kBlockThreads = 32 * kBlockWarps;
constexpr int kSlice = kChunk / kBlockWarps;  // words of a warp's slice
constexpr int kQuads = kSlice / 4;
constexpr int kStages = 2;        // depth of the ring of stages
constexpr int kPad = 4;           // words after each staged row: 16-byte
                                  // loads of 8 rows hit 32 distinct banks
constexpr int kBarWords = (2 * kStages + 3) / 4 * 4;  // the stage barriers,
                                                      // padded to 16 bytes

// Shared words of one block: the stage barriers, the group's queries (row
// stride qstride, zero past the row), the ring (row stride sstride), each
// stage's record, two buffers of (live query, row) partial sums, the
// bands and the top-k lists.
inline size_t smem_bytes(int G, int wpr, int nbands, int k) {
  const size_t qstride = (wpr + 31) / 32 * 32;
  const size_t sstride = (qstride < kChunk ? qstride : kChunk) + kPad;
  return sizeof(uint32_t) *
         (kBarWords + G * qstride + kStages * kRows * sstride + 4 * kStages +
          2 * kGroup * kRows + 2 * size_t(nbands) * G + 2 * size_t(G) * k);
}

// Whether any band of query j meets rows [a, b).
__device__ __forceinline__ bool meets(const int2* bands, int nbands, int G,
                                      int j, int a, int b) {
  bool any = false;
  for (int x = 0; x < nbands; ++x) {
    const int2 v = bands[x * G + j];
    any |= v.x < b && v.y > a && v.x < v.y;
  }
  return any;
}

// Whether row lies in any band of query j.
__device__ __forceinline__ bool in_band(const int2* bands, int nbands, int G,
                                        int j, int row) {
  bool in = false;
  for (int x = 0; x < nbands; ++x) {
    const int2 v = bands[x * G + j];
    in |= row >= v.x && row < v.y;
  }
  return in;
}

// The group's live-query mask over rows [a, b): bit j set when a band of
// query j meets them. Called by a whole warp; every lane gets the mask.
__device__ __forceinline__ unsigned live_mask(const int2* bands, int nbands,
                                              int G, int nq, int a, int b) {
  const int lane = threadIdx.x & 31;
  return __ballot_sync(0xffffffffu,
                       lane < nq && meets(bands, nbands, G, lane, a, b));
}

// The first tile at or after t (in steps of `step`) that a band meets,
// its live-query mask in live; ntiles when none. Every warp that calls it
// computes the same answer.
__device__ __forceinline__ int next_tile(const int2* bands, int nbands, int G,
                                         int nq, int lo, int hi, int ntiles,
                                         int t, int step, unsigned& live) {
  for (; t < ntiles; t += step) {
    const int a = lo + t * kRows;
    live = live_mask(bands, nbands, G, nq, a, min(a + kRows, hi));
    if (live) break;
  }
  return t;
}

// Block (x, group y): queries [G y, G y + G) against tiles x, x +
// gridDim.x, ... of the group's window; its lists into candidate slot x of
// each query's gridDim.x slots. VEC: rows of a multiple of 16 bytes on a
// 16-byte boundary, staged by bulk copies; else by loads through
// registers.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(kBlockThreads, 2)
    banded_scan_kernel(const unsigned char* __restrict__ q,
                       const unsigned char* __restrict__ r, int Q, int R,
                       int row_bytes, int wpr, int dim, int k, int G,
                       const int* __restrict__ starts,
                       const int* __restrict__ ends, int nbands, int* cv,
                       int* ci) {
  const int qstride = (wpr + 31) / 32 * 32;
  const int sstride = min(qstride, kChunk) + kPad;
  const int nchunks = (wpr + kChunk - 1) / kChunk;
  extern __shared__ __align__(16) uint32_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // one a stage
  uint32_t* qs = smem + kBarWords;
  uint32_t* ring = qs + G * qstride;
  int4* meta = reinterpret_cast<int4*>(ring + kStages * kRows * sstride);
  int* red = reinterpret_cast<int*>(meta + kStages);
  int2* bands = reinterpret_cast<int2*>(red + 2 * kGroup * kRows);
  int* lv = reinterpret_cast<int*>(bands + nbands * G);
  int* li = lv + G * k;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * G;
  const int nq = min(G, Q - q0);
  if (VEC && threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(bars + s, 1);
  load_queries(q, q0, nq, G, row_bytes, wpr, qstride, qs);
  list_init(lv, li, G * k, k, R);
  for (int e = threadIdx.x; e < nbands * G; e += kBlockThreads) {
    const int x = e / G;
    const int i = e - x * G;
    const size_t at = static_cast<size_t>(x) * Q + q0 + i;
    bands[e] = i < nq ? make_int2(starts[at], ends[at]) : make_int2(0, 0);
  }
  for (int e = threadIdx.x; e < 2 * kGroup * kRows; e += kBlockThreads)
    red[e] = 0;
  __syncthreads();

  // the group's window: lowest start to highest end of its non-empty bands
  int lo = INT_MAX, hi = INT_MIN;
  if (lane < nq) {
    for (int x = 0; x < nbands; ++x) {
      const int2 v = bands[x * G + lane];
      if (v.x < v.y) {
        lo = min(lo, v.x);
        hi = max(hi, v.y);
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int ntiles = lo < hi ? (hi - lo + kRows - 1) / kRows : 0;
  const int step = gridDim.x;

  // the producer's position (next stage to load): a stage is chunk c
  // (words [kChunk c, + kChunk)) of tile t's 32 rows. With bulk copies only
  // warp 0 stages, so only it walks the tiles; it records each staged
  // slot's (tile start, chunk, live mask, 1) in meta, (.., 0) past the end
  const bool producer = !VEC || warp == 0;
  unsigned plive = 0u;
  int pt = producer ? next_tile(bands, nbands, G, nq, lo, hi, ntiles,
                                blockIdx.x, step, plive)
                    : ntiles;
  int pc = 0;
  // stage (pt, pc) into `slot`: warp 0's lanes bulk-copy one row each (rows
  // at or past R are not copied and are never offered), or every thread
  // loads words through registers (zero past the row and past R)
  auto stage = [&](int slot) {
    if (pt >= ntiles) {
      if (threadIdx.x == 0) meta[slot] = make_int4(0, 0, 0, 0);
      return;
    }
    const int t0 = lo + pt * kRows;
    uint32_t* dst = ring + slot * kRows * sstride;
    const int w0 = kChunk * pc;
    if (threadIdx.x == 0)
      meta[slot] = make_int4(t0, pc, static_cast<int>(plive), 1);
    if (VEC) {
      const int rows = min(kRows, R - t0);
      const unsigned bytes = 4u * min(kChunk, wpr - w0);
      if (lane == 0) sm90::mbar_expect(bars + slot, rows * bytes);
      __syncwarp();
      if (lane < rows)
        sm90::bulk_load(dst + lane * sstride,
                        r + static_cast<size_t>(t0 + lane) * row_bytes +
                            4 * static_cast<size_t>(w0),
                        bytes, bars + slot);
    } else {
      for (int e = threadIdx.x; e < kRows * sstride; e += kBlockThreads) {
        const int row = e / sstride;
        const int w = w0 + (e - row * sstride);
        dst[e] = t0 + row < R && w < wpr && w < w0 + kChunk
                     ? load_word(r + static_cast<size_t>(t0 + row) * row_bytes,
                                 w, row_bytes)
                     : 0u;
      }
    }
    if (++pc == nchunks) {
      pc = 0;
      pt = next_tile(bands, nbands, G, nq, lo, hi, ntiles, pt + step, step,
                     plive);
    }
  };
  if (producer)
    for (int s = 0; s < kStages - 1; ++s) stage(s);  // the first in flight

  const int ws = kSlice * warp;  // this warp's word slice of a stage
  // a finished tile's offers: each live query's 32 rows, one warp a query,
  // from (and clearing) its partial sums in buffer pb
  auto offer = [&](int t0, unsigned live, int pb) {
    int* sums = red + pb * kGroup * kRows;
    const int row = t0 + lane;
    const int nl = __popc(live);
    for (int s = warp; s < nl; s += kBlockWarps) {
      const int j = __fns(live, 0, s + 1);
      const int total = sums[s * kRows + lane];
      sums[s * kRows + lane] = 0;
      const int score = MODE == kPacked ? dim - 2 * total : total;
      warp_offer(lv + j * k, li + j * k, k, in_band(bands, nbands, G, j, row),
                 score, row);
    }
  };

  // the last finished tile, offered one stage later so that its offers
  // overlap the next stage's scoring (partial sums double-buffered)
  int done_t0 = 0, done_buf = 0;
  unsigned done_live = 0u;
  int buf = 0;  // the partial-sum buffer of the tile being scored
  for (int it = 0;; ++it) {
    const int slot = it % kStages;
    // every warp is done with the last stage and every partial sum of the
    // last finished tile is in; this stage's record is visible
    __syncthreads();
    const int4 md = meta[slot];
    if (!md.w) break;  // block-uniform: past the last tile
    if (VEC) sm90::mbar_wait(bars + slot, (it / kStages) & 1);
    if (producer) stage((slot + kStages - 1) % kStages);
    if (done_live) offer(done_t0, done_live, done_buf);
    done_live = 0u;

    const int t0 = md.x;
    const int cc = md.y;
    const unsigned live = static_cast<unsigned>(md.z);
    const int cw = min(kChunk, wpr - kChunk * cc);  // words of this stage
    if (ws < cw) {  // warp-uniform
      // lane l: its row's slice words, kept for every live query
      const uint32_t* srow = ring + (slot * kRows + lane) * sstride + ws;
      uint4 rv[kQuads];
#pragma unroll
      for (int i = 0; i < kQuads; ++i)
        rv[i] = ws + 4 * i < cw
                    ? *reinterpret_cast<const uint4*>(srow + 4 * i)
                    : make_uint4(0u, 0u, 0u, 0u);
      int* sums = red + buf * kGroup * kRows;
      for (unsigned m = live; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const uint32_t* qrow = qs + j * qstride + kChunk * cc + ws;
        int sum = 0;
#pragma unroll
        for (int i = 0; i < kQuads; ++i) {
          if (ws + 4 * i < cw) {  // the query words: one broadcast load
            const uint4 qv = *reinterpret_cast<const uint4*>(qrow + 4 * i);
            int t = word_score<MODE>(qv.x, rv[i].x, 0);
            t = word_score<MODE>(qv.y, rv[i].y, t);
            int v = word_score<MODE>(qv.z, rv[i].z, 0);
            v = word_score<MODE>(qv.w, rv[i].w, v);
            sum += t + v;
          }
        }
        // the live query's rank in the tile's mask: its partial-sum row
        atomicAdd(sums + __popc(live & ((1u << j) - 1u)) * kRows + lane, sum);
      }
    }
    if (cc == nchunks - 1) {  // block-uniform: the tile's last stage
      done_t0 = t0;
      done_live = live;
      done_buf = buf;
      buf ^= 1;
    }
  }
  if (done_live) offer(done_t0, done_live, done_buf);

  __syncthreads();
  for (int j = warp; j < nq; j += kBlockWarps) {
    const size_t base =
        (static_cast<size_t>(q0 + j) * gridDim.x + blockIdx.x) * k;
    for (int s = lane; s < k; s += 32) {
      cv[base + s] = lv[j * k + s];
      ci[base + s] = li[j * k + s];
    }
  }
}

}  // namespace band

// The banded scan of q (Q rows) against r (R rows) of row_bytes bytes each
// (mode 0: packed words; mode 1: int8 lanes; wpr = ceil(row_bytes / 4))
// over nbands bands, in query groups of G (<= 32) and `blocks` blocks a
// group, into the (Q, blocks, k) candidate buffers. Returns the launch's
// CUDA error.
inline cudaError_t launch_banded_scan(const void* q, const void* r, int Q,
                                      int R, int row_bytes, int wpr, int mode,
                                      int dim, int k, int G,
                                      const int* starts, const int* ends,
                                      int nbands, int blocks, int* cv,
                                      int* ci, cudaStream_t s) {
  const size_t smem = band::smem_bytes(G, wpr, nbands, k);
  const bool vec = row_bytes % 16 == 0;
  auto kernel = mode == kPacked
                    ? (vec ? band::banded_scan_kernel<kPacked, true>
                           : band::banded_scan_kernel<kPacked, false>)
                    : (vec ? band::banded_scan_kernel<kInt8, true>
                           : band::banded_scan_kernel<kInt8, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(blocks, (Q + G - 1) / G);
  kernel<<<grid, band::kBlockThreads, smem, s>>>(
      static_cast<const unsigned char*>(q),
      static_cast<const unsigned char*>(r), Q, R, row_bytes, wpr, dim, k, G,
      starts, ends, nbands, cv, ci);
  return cudaGetLastError();
}

}  // namespace hd
