// Kernel K12: the stream count's sort-count of one batch, the distinct
// live keys of its window stream ascending with their counts
// (ops/sortcount.py).
//
// Replaces the XLA sort-count of kmer_denovo_filter_tpu/ops/device.py
// sort_count (:121: jax.lax.sort over the W word columns, then
// _run_lengths :145), with the sentinel mask of the StreamCounter
// (engine.py:381).  The port ran it as torch.unique (narrow keys) or Q
// stable torch.sorts and gathers (wide rows).
//
// In:  the segment-local dedup of the batch, kernel K9d's (or K9dw's)
//      slots as they stand: (S * 8192, Q) int64 rows (Q = 1: flat keys),
//      (S * 8192,) int64 weights and (S,) int32 counts; segment s holds
//      its counts[s] distinct live rows ascending at the front of its
//      slot and nothing else that is read.  K9d and K9dw drop the
//      sentinel.
// Out: the distinct rows ascending (Q limbs each) with their summed
//      weights, and their number in totals[1] (the wrapper's one sync).
//
// The slots are S sorted runs, so the sort is a merge of them: a tree
// of ceil(log2 S) rounds, each reading and writing every live row once.
//
// 1. sc_offsets (one block) scans the counts into run offsets off[0..S]
//    and writes the live total, off[S], to totals[0].  Nothing reaches
//    the host.
// 2. sc_merge, a launch a round.  Round r merges runs 2j and 2j + 1 of
//    2^r segments each (a pair); its output run j covers
//    [off[2j * 2^r], off[min((2j + 2) * 2^r, S)]) of a compacted buffer,
//    so every run's bounds are a stride over off and no length is kept.
//    Round 0 reads the slots in place (segment s at s * 8192) and writes
//    compacted rows: it is the compaction too.  A run with no partner
//    (odd S) is merged with nothing, a copy.  The buffers ping-pong
//    between K9d's slot buffers and a scratch pair.
//    The blocks are persistent (the grid is the SMs times the blocks an
//    SM holds) and walk tiles of T rows of the round's output up to the
//    live total read on the card; T = 2,048 at Q = 1, 1,024 at Q <= 3,
//    512 past it, so a tile takes 21-36 KB of shared memory and an SM
//    holds five blocks (48 registers a thread).  A form that
//    double-buffered the next tile by cp.async (its searches and copies
//    in flight while this tile merged) held three blocks an SM at Q = 1
//    and 7, and its kernels ran 7-14 % longer on an H100, but for 4 %
//    less on 40x reads at k = 31: the copies stay synchronous.  A tile:
//    a. finds the pairs of its first and last rows (the last pair that
//       starts at or before them) and, in those, the merge path's split
//       at its start and end (how many of its rows come from the left
//       run), each by a search over global memory that half the block
//       runs, 128 candidates a step: three steps cover 2^21 rows;
//    b. stages its input in shared memory in output order of pieces: a
//       piece is a pair's part of the tile, its left rows then its
//       right rows (a tile straddles several pairs when runs are shorter
//       than T; a pair wholly inside the tile needs no split);
//    c. merges: each thread takes T / 256 consecutive outputs, finds the
//       split at its first output by a binary search of the staged
//       piece, then merges on, into the next piece at (0, 0) where one
//       ends, and writes each output's staged index;
//    d. writes the rows and weights out in order, coalesced.
//    Rows compare lexicographically, limb 0 first; the other limbs are
//    read only on a tie.  A tie between runs takes the left run first.
// 3. The run combine, on the merged rows: sc_starts counts the run
//    starts (a row that differs from the row before) of each block's
//    rows, sc_scan ranks them and writes their number to totals[1], and
//    sc_combine writes each run's row at its rank with the sum of its
//    weights (a run holds a key's rows from different segments: at most
//    S rows).
//
// Bound: by bytes, the batch's keys read once (8Q B a window) and the
// distinct rows and counts written once (8Q + 8 B each): ~0.01 ms for a
// 32,768 x 152 bp batch at k = 31.  K12 reads and writes K9d's live
// rows once a round, ceil(log2 S) times (9 rounds for the 488 segments
// of that batch), in ceil(log2 S) + 4 launches.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "sorted_table.cuh"

namespace {

constexpr int kThreads = 256;  // the offsets scan and the combine
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 7;
constexpr int kCombineBlocks = 512;  // blocks the combine splits rows among
constexpr int kScanPerThread = kCombineBlocks / kThreads;
constexpr int kMergeThreads = 256;
constexpr int kGroup = kMergeThreads / 2;  // threads of one global search
constexpr int kGroupWarps = kGroup / 32;
constexpr unsigned kFull = 0xffffffffu;

// A merge round's tile: its rows, each thread's outputs, and its shared
// memory (the staged rows and weights, a uint16 staged index an output).
template <int Q>
struct MergeTile {
  static constexpr int kRows = Q == 1 ? 2048 : Q <= 3 ? 1024 : 512;
  static constexpr int kPerThread = kRows / kMergeThreads;
  static constexpr size_t kSmemBytes = kRows * (8 * Q + 8) + kRows * 2;
};

// Block b's rows [lo, hi): equal runs, a multiple of kThreads each.
__device__ void block_range(long long rows, int blocks, long long* lo,
                            long long* hi) {
  const long long per_round = static_cast<long long>(blocks) * kThreads;
  const long long per = (rows + per_round - 1) / per_round * kThreads;
  *lo = min(rows, blockIdx.x * per);
  *hi = min(rows, *lo + per);
}

__device__ __forceinline__ bool same_row(const long long* keys, int q,
                                         long long a, long long b) {
  for (int j = 0; j < q; ++j) {
    if (keys[a * q + j] != keys[b * q + j]) return false;
  }
  return true;
}

// x <= y, limb 0 first.
template <int Q>
__device__ __forceinline__ bool row_le(const long long* x,
                                       const long long* y) {
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (x[j] != y[j]) return x[j] < y[j];
  }
  return true;
}

// The exclusive prefix of `local` over the block's threads, in thread
// order; *all gets the block's total.  `warp_total` is kWarps of shared
// memory.
__device__ long long block_exclusive_scan(long long local,
                                          long long* warp_total,
                                          long long* all) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long inclusive = local;
  for (int off = 1; off < 32; off <<= 1) {
    const long long up = __shfl_up_sync(kFull, inclusive, off);
    if (lane >= off) inclusive += up;
  }
  if (lane == 31) warp_total[warp] = inclusive;
  __syncthreads();
  long long before = 0;
  *all = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_total[w];
    *all += warp_total[w];
  }
  return before + inclusive - local;
}

// off[s] = the rows of segments before s, off[n] = *total = all of them.
__global__ void __launch_bounds__(kThreads)
    sc_offsets(const int* __restrict__ counts, int n,
               long long* __restrict__ off, long long* __restrict__ total) {
  __shared__ long long warp_total[kWarps];
  const int per = (n + kThreads - 1) / kThreads;
  const int first = threadIdx.x * per;
  const int last = min(n, first + per);
  long long local = 0;
  for (int s = first; s < last; ++s) local += counts[s];
  long long all;
  long long at = block_exclusive_scan(local, warp_total, &all);
  for (int s = first; s < last; ++s) {
    off[s] = at;
    at += counts[s];
  }
  if (threadIdx.x == 0) {
    off[n] = all;
    *total = all;
  }
}

// One merge round: rows of the input runs in, the merged runs out.
struct Round {
  const long long* keys;
  const long long* weights;
  long long* keys_out;
  long long* weights_out;
  const long long* off;
  int n_segments;
  long long width;  // segments a run
  int slot_shift;   // round 0: segment s starts at s << slot_shift; 0: off[s]
};

// Pair p of a round: its first output row, the rows of its left run (A)
// and right run (B), and the input rows where they start.
struct Pair {
  long long start, a_len, b_len, a_base, b_base;
};

__device__ __forceinline__ Pair pair_of(const Round& r, long long p) {
  const long long s0 = p * 2 * r.width;
  const long long s1 = min(s0 + r.width, static_cast<long long>(r.n_segments));
  const long long s2 =
      min(s0 + 2 * r.width, static_cast<long long>(r.n_segments));
  const long long off1 = __ldg(r.off + s1);
  Pair x;
  x.start = __ldg(r.off + s0);
  x.a_len = off1 - x.start;
  x.b_len = __ldg(r.off + s2) - off1;
  x.a_base = r.slot_shift > 0 ? s0 << r.slot_shift : x.start;
  x.b_base = r.slot_shift > 0 ? s1 << r.slot_shift : off1;
  return x;
}

// The tile [o0, o1) of a round's output: its first and last pairs, and
// the rows of A before the tile's start in the first and before its end
// in the last.
struct TileSpan {
  long long o0, o1, first, last, split_first, split_last;
};

// A pair's part of the tile: its first row in the tile, its rows, how
// many of them come from A, and the input rows of its first A and B rows.
struct Piece {
  int begin, len, a_len;
  long long a_src, b_src;
};

__device__ Piece piece_of(const Round& r, const TileSpan& s, long long p) {
  const Pair x = pair_of(r, p);
  const long long lo = max(x.start, s.o0);
  const long long hi = min(x.start + x.a_len + x.b_len, s.o1);
  const long long a0 = p == s.first ? s.split_first : 0;
  const long long a1 = p == s.last ? s.split_last : x.a_len;
  Piece c;
  c.begin = static_cast<int>(lo - s.o0);
  c.len = static_cast<int>(hi - lo);
  c.a_len = static_cast<int>(a1 - a0);
  c.a_src = x.a_base + a0;
  c.b_src = x.b_base + (lo - x.start - a0);
  return c;
}

// The pair that holds row i of the tile: the last that starts at or
// before it (an empty pair starts where the next one does).
__device__ long long pair_at(const Round& r, const TileSpan& s, int i) {
  const long long at = s.o0 + i;
  long long lo = s.first;
  long long hi = s.last;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) / 2;
    if (__ldg(r.off + mid * 2 * r.width) <= at) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The first index in [lo, hi) where pred, true and then false, is
// false, or hi.  Each half of the block searches its own range, kGroup
// candidates a step; every thread of the block must call it.
template <typename Pred>
__device__ long long group_search(long long lo, long long hi, Pred pred,
                                  int (*first_false)[kGroupWarps]) {
  const int g = threadIdx.x / kGroup;
  const int t = threadIdx.x % kGroup;
  while (__syncthreads_or(lo < hi)) {
    const long long len = hi - lo;
    const long long stride = len > 0 ? (len + kGroup - 1) / kGroup : 1;
    const long long at = lo + t * stride;
    const unsigned fell = __ballot_sync(kFull, at < hi && !pred(at));
    if ((t & 31) == 0) {
      first_false[g][t >> 5] = fell ? (t & ~31) + __ffs(fell) - 1 : kGroup;
    }
    __syncthreads();
    int first = kGroup;
    for (int w = 0; w < kGroupWarps; ++w) {
      first = min(first, first_false[g][w]);
    }
    if (lo < hi) {
      if (first < kGroup) {  // the answer lies in (the last true, at_false]
        const long long at_false = lo + first * stride;
        lo = first > 0 ? at_false - stride + 1 : lo;
        hi = at_false;
      } else {  // past the last candidate
        lo += (len - 1) / stride * stride + 1;
      }
    }
  }
  return lo;
}

// a. The tile [o0, o1) of the round's output and its bounds: half 0 of
//    the block searches at its start, half 1 at its end.
template <int Q>
__device__ TileSpan tile_bounds(const Round& r, long long o0, long long o1,
                                int (*first_false)[kGroupWarps],
                                long long (*bounds)[2]) {
  const int g = threadIdx.x / kGroup;
  const long long span = 2 * r.width;
  const long long pairs = (r.n_segments + span - 1) / span;
  const long long row = g == 0 ? o0 : o1 - 1;
  const long long p = group_search(0, pairs, [&](long long i) {
                        return __ldg(r.off + i * span) <= row;
                      }, first_false) - 1;
  const Pair x = pair_of(r, p);
  const long long d = (g == 0 ? o0 : o1) - x.start;
  const long long* a = r.keys + x.a_base * Q;
  const long long* b = r.keys + x.b_base * Q;
  const long long split = group_search(
      max(0LL, d - x.b_len), min(d, x.a_len), [&](long long i) {
        return row_le<Q>(a + i * Q, b + (d - 1 - i) * Q);
      }, first_false);
  if (threadIdx.x % kGroup == 0) {
    bounds[g][0] = p;
    bounds[g][1] = split;
  }
  __syncthreads();
  return TileSpan{o0, o1, bounds[0][0], bounds[1][0], bounds[0][1],
                  bounds[1][1]};
}

// b. Stage the tile's pieces, each its A rows then its B rows, copied as
//    contiguous words.
template <int Q>
__device__ void stage_tile(const Round& r, const TileSpan& s,
                           long long* skeys, long long* sweights) {
  for (long long p = s.first; p <= s.last; ++p) {
    const Piece c = piece_of(r, s, p);
    const int na = c.a_len;
    const int nb = c.len - c.a_len;
    const long long* a = r.keys + c.a_src * Q;
    const long long* b = r.keys + c.b_src * Q;
    long long* to = skeys + c.begin * Q;
    for (int e = threadIdx.x; e < na * Q; e += kMergeThreads) to[e] = a[e];
    for (int e = threadIdx.x; e < nb * Q; e += kMergeThreads) {
      to[na * Q + e] = b[e];
    }
    for (int e = threadIdx.x; e < na; e += kMergeThreads) {
      sweights[c.begin + e] = r.weights[c.a_src + e];
    }
    for (int e = threadIdx.x; e < nb; e += kMergeThreads) {
      sweights[c.begin + na + e] = r.weights[c.b_src + e];
    }
  }
}

// c. Merge this thread's outputs of the staged tile: order[i] = the
//    staged row of output i.
template <int Q>
__device__ void merge_tile(const Round& r, const TileSpan& s,
                           const long long* skeys, unsigned short* order) {
  const int n = static_cast<int>(s.o1 - s.o0);
  const int i0 = threadIdx.x * MergeTile<Q>::kPerThread;
  if (i0 >= n) return;
  long long p = pair_at(r, s, i0);
  Piece c = piece_of(r, s, p);
  const int d = i0 - c.begin;
  const long long* a = skeys + c.begin * Q;
  const long long* b = a + c.a_len * Q;
  int lo = max(0, d - (c.len - c.a_len));
  int hi = min(d, c.a_len);
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (row_le<Q>(a + mid * Q, b + (d - 1 - mid) * Q)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int ia = lo;
  int ib = d - lo;
  const int end = min(i0 + MergeTile<Q>::kPerThread, n);
  for (int i = i0; i < end; ++i) {
    while (ia + ib == c.len) {  // into the next piece
      c = piece_of(r, s, ++p);
      a = skeys + c.begin * Q;
      b = a + c.a_len * Q;
      ia = ib = 0;
    }
    const bool take_a =
        ia < c.a_len &&
        (ib == c.len - c.a_len || row_le<Q>(a + ia * Q, b + ib * Q));
    order[i] = static_cast<unsigned short>(
        c.begin + (take_a ? ia++ : c.a_len + ib++));
  }
}

// d. Write the tile out in order, coalesced.
template <int Q>
__device__ void store_tile(const Round& r, const TileSpan& s,
                           const long long* skeys, const long long* sweights,
                           const unsigned short* order) {
  const int n = static_cast<int>(s.o1 - s.o0);
  for (int e = threadIdx.x; e < n * Q; e += kMergeThreads) {
    const int i = e / Q;
    const int j = e - i * Q;
    r.keys_out[(s.o0 + i) * Q + j] = skeys[order[i] * Q + j];
  }
  for (int i = threadIdx.x; i < n; i += kMergeThreads) {
    r.weights_out[s.o0 + i] = sweights[order[i]];
  }
}

template <int Q>
__global__ void __launch_bounds__(kMergeThreads)
    sc_merge(Round r, const long long* __restrict__ total) {
  using Tile = MergeTile<Q>;
  extern __shared__ long long smem[];
  long long* skeys = smem;                       // kRows x Q
  long long* sweights = smem + Tile::kRows * Q;  // kRows
  auto* order = reinterpret_cast<unsigned short*>(sweights + Tile::kRows);
  __shared__ int first_false[2][kGroupWarps];
  __shared__ long long bounds[2][2];  // (pair, split) at the start, the end
  const long long live = *total;
  const long long tiles = (live + Tile::kRows - 1) / Tile::kRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long o0 = tile * Tile::kRows;
    const TileSpan s = tile_bounds<Q>(r, o0, min(o0 + Tile::kRows, live),
                                      first_false, bounds);
    stage_tile<Q>(r, s, skeys, sweights);
    __syncthreads();
    merge_tile<Q>(r, s, skeys, order);
    __syncthreads();
    store_tile<Q>(r, s, skeys, sweights, order);
    __syncthreads();
  }
}

// The run starts among each block's share of the first *n_live rows.
__global__ void __launch_bounds__(kThreads)
    sc_starts(const long long* __restrict__ keys, int q,
              const long long* __restrict__ n_live, int blocks,
              long long* __restrict__ counts) {
  __shared__ unsigned starts;
  if (threadIdx.x == 0) starts = 0;
  __syncthreads();
  long long lo, hi;
  block_range(*n_live, blocks, &lo, &hi);
  for (long long first = lo; first < hi; first += kThreads) {
    const long long r = first + threadIdx.x;
    const unsigned start = __ballot_sync(
        kFull, r < hi && (r == 0 || !same_row(keys, q, r, r - 1)));
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(&starts, static_cast<unsigned>(__popc(start)));
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) counts[blockIdx.x] = starts;
}

// One block scans the combine blocks' counts exclusively in place and
// writes their sum, the distinct rows, to *total.
__global__ void __launch_bounds__(kThreads)
    sc_scan(long long* __restrict__ counts, int blocks,
            long long* __restrict__ total) {
  __shared__ long long warp_total[kWarps];
  const int per = (blocks + kThreads - 1) / kThreads;
  const int first = threadIdx.x * per;
  long long v[kScanPerThread];
  long long local = 0;
#pragma unroll
  for (int j = 0; j < kScanPerThread; ++j) {
    v[j] = j < per && first + j < blocks ? counts[first + j] : 0;
    local += v[j];
  }
  long long all;
  long long offset = block_exclusive_scan(local, warp_total, &all);
#pragma unroll
  for (int j = 0; j < kScanPerThread; ++j) {
    if (j < per && first + j < blocks) counts[first + j] = offset;
    offset += v[j];
  }
  if (threadIdx.x == 0) *total = all;
}

__global__ void __launch_bounds__(kThreads)
    sc_combine(const long long* __restrict__ keys,
               const long long* __restrict__ weights, int q,
               const long long* __restrict__ n_live, int blocks,
               const long long* __restrict__ offsets,
               long long* __restrict__ keys_out,
               long long* __restrict__ counts_out) {
  __shared__ int warp_starts[kWarps];
  const long long n = *n_live;
  long long lo, hi;
  block_range(n, blocks, &lo, &hi);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long next = offsets[blockIdx.x];
  for (long long first = lo; first < hi; first += kThreads) {
    const long long r = first + threadIdx.x;
    const bool start = r < hi && (r == 0 || !same_row(keys, q, r, r - 1));
    const unsigned starts = __ballot_sync(kFull, start);
    if (lane == 0) warp_starts[warp] = __popc(starts);
    __syncthreads();
    if (start) {
      long long rank = next + __popc(starts & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) rank += warp_starts[w];
      for (int j = 0; j < q; ++j) keys_out[rank * q + j] = keys[r * q + j];
      long long sum = weights[r];
      for (long long e = r + 1; e < n && same_row(keys, q, e, r); ++e) {
        sum += weights[e];
      }
      counts_out[rank] = sum;
    }
    for (int w = 0; w < kWarps; ++w) next += warp_starts[w];
    __syncthreads();
  }
}

std::atomic<uint64_t> merge_opted_in[kMaxQ + 1];

// The merge rounds over keys[*src] / weights[*src]; *src ends on the
// buffer that holds the merged rows.
template <int Q>
cudaError_t merge_rounds(long long* const keys[2],
                         long long* const weights[2], const long long* off,
                         int n_segments, int segment_shift,
                         const long long* live, cudaStream_t stream,
                         int* src) {
  using Tile = MergeTile<Q>;
  cudaError_t err =
      kdf::opt_in_smem(sc_merge<Q>, Tile::kSmemBytes, merge_opted_in[Q]);
  int sms = 0;
  int per_sm = 0;
  if (err == cudaSuccess) err = kdf::sm_count(&sms);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sc_merge<Q>, kMergeThreads, Tile::kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(n_segments) << segment_shift;
  const long long need = (slots + Tile::kRows - 1) / Tile::kRows;
  const long long cap =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(need < cap ? need : cap);
  for (long long width = 1; width < n_segments; width *= 2) {
    const Round r{keys[*src],  weights[*src], keys[1 - *src],
                  weights[1 - *src], off, n_segments, width,
                  width == 1 ? segment_shift : 0};
    sc_merge<Q><<<blocks, kMergeThreads, Tile::kSmemBytes, stream>>>(r, live);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    *src = 1 - *src;
  }
  return cudaSuccess;
}

}  // namespace

// The int64 scratch kdf_sort_count takes for n_segments segments: the
// live and distinct rows, the run offsets and the combine's counts.
extern "C" long long kdf_sort_count_aux(int n_segments) {
  return 2LL + (n_segments + 1LL) + kCombineBlocks;
}

// K12 over the slots of K9d / K9dw: n_segments segments of
// 2^segment_shift rows of q limbs.  `keys1` / `weights1` hold as many
// rows of scratch, `aux` kdf_sort_count_aux(n_segments) int64: totals
// (the live rows, the distinct rows), then the run offsets, then the
// combine's counts; `keys_out` / `counts_out` hold as many rows.  The
// slots' buffers are overwritten (the merge's second buffer).  Returns
// the first CUDA error, 0 on success.
extern "C" int kdf_sort_count(void* keys0, void* weights0,
                              const void* seg_counts, int segment_shift,
                              int n_segments, int q, void* keys1,
                              void* weights1, void* aux, void* keys_out,
                              void* counts_out, void* stream) {
  if (q < 1 || q > kMaxQ || segment_shift < 1 || segment_shift > 30 ||
      n_segments < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<long long*>(aux);
  long long* off = t + 2;
  long long* counts = off + n_segments + 1;
  long long* const key_buf[2] = {static_cast<long long*>(keys0),
                                 static_cast<long long*>(keys1)};
  long long* const weight_buf[2] = {static_cast<long long*>(weights0),
                                    static_cast<long long*>(weights1)};
  sc_offsets<<<1, kThreads, 0, s>>>(static_cast<const int*>(seg_counts),
                                    n_segments, off, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int src = 0;
  switch (q) {
    case 1: err = merge_rounds<1>(key_buf, weight_buf, off, n_segments,
                                  segment_shift, t, s, &src); break;
    case 2: err = merge_rounds<2>(key_buf, weight_buf, off, n_segments,
                                  segment_shift, t, s, &src); break;
    case 3: err = merge_rounds<3>(key_buf, weight_buf, off, n_segments,
                                  segment_shift, t, s, &src); break;
    case 4: err = merge_rounds<4>(key_buf, weight_buf, off, n_segments,
                                  segment_shift, t, s, &src); break;
    case 5: err = merge_rounds<5>(key_buf, weight_buf, off, n_segments,
                                  segment_shift, t, s, &src); break;
    case 6: err = merge_rounds<6>(key_buf, weight_buf, off, n_segments,
                                  segment_shift, t, s, &src); break;
    default: err = merge_rounds<7>(key_buf, weight_buf, off, n_segments,
                                   segment_shift, t, s, &src); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = static_cast<long long>(n_segments) << segment_shift;
  const int blocks = static_cast<int>(
      slots < static_cast<long long>(kCombineBlocks) * kThreads
          ? (slots + kThreads - 1) / kThreads
          : kCombineBlocks);
  sc_starts<<<blocks, kThreads, 0, s>>>(key_buf[src], q, t, blocks, counts);
  sc_scan<<<1, kThreads, 0, s>>>(counts, blocks, t + 1);
  sc_combine<<<blocks, kThreads, 0, s>>>(
      key_buf[src], weight_buf[src], q, t, blocks, counts,
      static_cast<long long*>(keys_out), static_cast<long long*>(counts_out));
  return static_cast<int>(cudaGetLastError());
}
