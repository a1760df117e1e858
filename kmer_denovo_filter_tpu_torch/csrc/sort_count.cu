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
// A stable LSD radix sort of the slots' live rows, weights carried, by
// K10's stable counting pass (route.cu) with an 8-bit digit of the key
// in place of the owner: limb Q - 1 first, its low digit first; a
// limb's passes stop at its top bit (2 x its bases), so k = 31 takes 8
// passes and k = 63 takes 8 + 8 + 1.  A pass is three launches:
//
// 1. sc_count: each block takes an equal run of rows, 256 a round, and
//    counts their digits in a shared histogram (one shared atomic per
//    digit a warp, by __match_any_sync); it writes its counts
//    digit-major, counts[d * blocks + block].
// 2. sc_scan: block d scans digit d's counts over the blocks,
//    exclusively in place, and writes their sum, the digit's total.
// 3. sc_scatter: each block first scans the digit totals (the rows of
//    lower digits) and adds its own counts, then walks its rows again in
//    order and writes each row and weight to its digit's next slot in
//    the block, plus the rows of that digit in lower warps of the round
//    (a uint8 count a warp and digit) and in lower lanes of its warp
//    (__match_any_sync).
//
// The scan and the scatter's rounds set the shape.  One block scanning
// every block's counts of every digit was the first form's longest
// launch, so a scan takes a block a digit.  A round of the scatter waits
// on four barriers and a load, so the rows are spread over up to 512
// blocks (ops/sortcount.py plan): 5 rounds of a 40x batch and 31 of 4M
// random rows.  The digit is 8 bits, the fastest of 6, 8 and 10 on an
// H100 over a 40x batch at k = 31 and 63 (PERF.md, kernel table).
// Random rows are bound by the scatter, wide rows by the bytes each pass
// moves (k = 201: 52 passes of 56-byte rows).
//
// The first pass reads the slots and drops the rows past each
// segment's count, so its output is compacted; the later passes read
// the first totals[0] rows.  The row count is never brought to the
// host: each launch covers every slot and its blocks split the rows
// they find in totals[0] among themselves.  Then the run combine:
// sc_count counts the run starts (a row that differs from the row
// before) in one bin, sc_scan ranks them and writes their number to
// totals[1] (the first pass's scatter writes the live rows to
// totals[0]), and sc_combine writes each run's row at its rank with the
// sum of the run's weights (a run holds a key's rows from different
// segments: at most S rows).
//
// Bound: by bytes, the batch's keys read once (8Q B a window) and the
// distinct rows and counts written once (8Q + 8 B each): ~0.01 ms for
// a 32,768 x 152 bp batch at k = 31.  K12 reads K9d's output P + 2
// times and writes it P times, in 3P + 3 launches, each of them short.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 8;   // ops/sortcount.py DIGIT_BITS
constexpr int kBins = 1 << kDigitBits;
constexpr int kLimbBits = 62;   // 31 bases a limb
constexpr int kMaxQ = 7;
constexpr int kMaxBlocks = 512;  // ops/sortcount.py MAX_BLOCKS
constexpr int kScanPerThread = kMaxBlocks / kThreads;
constexpr unsigned kFull = 0xffffffffu;

// The rows a launch reads: the slots (seg_counts given: a row is live
// when it lies before its segment's count, the segments 2^segment_shift
// rows each) or the first *n_live rows.
struct Rows {
  long long n_slots;
  const int* seg_counts;
  int segment_shift;
  const long long* n_live;

  __device__ long long count() const {
    return seg_counts != nullptr ? n_slots : *n_live;
  }
  __device__ bool live(long long r) const {
    return seg_counts == nullptr ||
           (r & ((1LL << segment_shift) - 1)) < seg_counts[r >> segment_shift];
  }
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

// The digit of a row (bins = 2^its bits, at most kBins) or, with runs,
// bin 0 for a run start; `bins` for a row that takes no bin.
template <bool kRuns>
__device__ __forceinline__ int bin_of(const long long* keys, int q,
                                      long long r, int limb, int shift,
                                      int bins) {
  if (kRuns) return r == 0 || !same_row(keys, q, r, r - 1) ? 0 : bins;
  return static_cast<int>((keys[r * q + limb] >> shift) & (bins - 1));
}

template <bool kRuns>
__global__ void __launch_bounds__(kThreads)
    sc_count(const long long* __restrict__ keys, int q, Rows rows,
             int limb, int shift, int bins, int blocks,
             long long* __restrict__ counts) {
  __shared__ unsigned hist[kBins];
  for (int b = threadIdx.x; b < bins; b += kThreads) hist[b] = 0;
  __syncthreads();
  long long lo, hi;
  block_range(rows.count(), blocks, &lo, &hi);
  const int lane = threadIdx.x & 31;
  for (long long first = lo; first < hi; first += kThreads) {
    const long long r = first + threadIdx.x;
    const int d = r < hi && rows.live(r)
                      ? bin_of<kRuns>(keys, q, r, limb, shift, bins)
                      : bins;
    const unsigned peers = __match_any_sync(kFull, d);
    if (d < bins && lane == __ffs(peers) - 1) {
      atomicAdd(&hist[d], static_cast<unsigned>(__popc(peers)));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kThreads) {
    counts[static_cast<long long>(b) * blocks + blockIdx.x] = hist[b];
  }
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

// Block d scans digit d's counts over the blocks, counts[d * blocks ..),
// exclusively in place, and writes their sum to digit_totals[d].
__global__ void __launch_bounds__(kThreads)
    sc_scan(long long* __restrict__ counts, int blocks,
            long long* __restrict__ digit_totals) {
  __shared__ long long warp_total[kWarps];
  long long* c = counts + static_cast<long long>(blockIdx.x) * blocks;
  const int per = (blocks + kThreads - 1) / kThreads;
  const int first = threadIdx.x * per;
  long long v[kScanPerThread];
  long long local = 0;
#pragma unroll
  for (int j = 0; j < kScanPerThread; ++j) {
    v[j] = j < per && first + j < blocks ? c[first + j] : 0;
    local += v[j];
  }
  long long all;
  long long offset = block_exclusive_scan(local, warp_total, &all);
#pragma unroll
  for (int j = 0; j < kScanPerThread; ++j) {
    if (j < per && first + j < blocks) c[first + j] = offset;
    offset += v[j];
  }
  if (threadIdx.x == 0) digit_totals[blockIdx.x] = all;
}

__global__ void __launch_bounds__(kThreads)
    sc_scatter(const long long* __restrict__ keys,
               const long long* __restrict__ weights, int q, Rows rows,
               int limb, int shift, int bins, int blocks,
               const long long* __restrict__ offsets,
               const long long* __restrict__ digit_totals,
               long long* __restrict__ keys_out,
               long long* __restrict__ weights_out,
               long long* __restrict__ total) {
  __shared__ unsigned long long next[kBins];
  __shared__ unsigned char warp_count[kWarps][kBins];
  __shared__ long long staged[kThreads * kMaxQ];
  __shared__ long long dest[kThreads];
  __shared__ long long warp_total[kWarps];
  {  // digit d's first slot: the rows of lower digits (an exclusive scan
     // of the digit totals, a digit a thread), plus its rows in lower
     // blocks
    static_assert(kBins == kThreads, "a digit a thread");
    const int b = threadIdx.x;
    const long long v = b < bins ? digit_totals[b] : 0;
    long long all;
    const long long base = block_exclusive_scan(v, warp_total, &all);
    if (b < bins) {
      next[b] = static_cast<unsigned long long>(
          base + offsets[static_cast<long long>(b) * blocks + blockIdx.x]);
      for (int w = 0; w < kWarps; ++w) warp_count[w][b] = 0;
    }
    if (total != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      *total = all;
    }
  }
  long long lo, hi;
  block_range(rows.count(), blocks, &lo, &hi);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (long long first = lo; first < hi; first += kThreads) {
    const int count =
        hi - first < kThreads ? static_cast<int>(hi - first) : kThreads;
    for (int e = threadIdx.x; e < count * q; e += kThreads) {
      staged[e] = keys[first * q + e];
    }
    __syncthreads();
    const long long r = first + threadIdx.x;
    const int d = threadIdx.x < count && rows.live(r)
                      ? static_cast<int>(
                            (staged[threadIdx.x * q + limb] >> shift) &
                            (bins - 1))
                      : bins;
    const unsigned peers = __match_any_sync(kFull, d);
    const bool leader = d < bins && lane == __ffs(peers) - 1;
    if (leader) {
      warp_count[warp][d] = static_cast<unsigned char>(__popc(peers));
    }
    __syncthreads();
    dest[threadIdx.x] = -1;
    if (d < bins) {
      long long slot = static_cast<long long>(next[d]) +
                       __popc(peers & below);
      for (int w = 0; w < warp; ++w) slot += warp_count[w][d];
      dest[threadIdx.x] = slot;
      weights_out[slot] = weights[r];
    }
    __syncthreads();
    if (leader) {
      atomicAdd(&next[d], static_cast<unsigned long long>(__popc(peers)));
      warp_count[warp][d] = 0;
    }
    for (int e = threadIdx.x; e < count * q; e += kThreads) {
      const long long slot = dest[e / q];
      if (slot >= 0) keys_out[slot * q + e % q] = staged[e];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    sc_combine(const long long* __restrict__ keys,
               const long long* __restrict__ weights, int q, Rows rows,
               int blocks, const long long* __restrict__ offsets,
               long long* __restrict__ keys_out,
               long long* __restrict__ counts_out) {
  __shared__ int warp_starts[kWarps];
  const long long n = rows.count();
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

}  // namespace

// K12 over the slots of K9d / K9dw: `n_slots` rows of q limbs in
// segments of 2^segment_shift rows, the last limb's key bits `last_bits`
// (2 x its bases; the others 62), kDigitBits a pass.
// `keys1` / `weights1` hold n_slots rows of scratch, `counts` kBins x
// blocks int64 (blocks <= kMaxBlocks), `totals` 2 + kBins int64: the
// live rows, the distinct rows, then a pass's digit totals;
// `keys_out` / `counts_out` n_slots rows.
// The slots' buffers are overwritten (the sort's second buffer).
// Returns the first CUDA error, 0 on success.
extern "C" int kdf_sort_count(void* keys0, void* weights0,
                              const void* seg_counts, int segment_shift,
                              long long n_slots, int q, int last_bits,
                              int blocks, void* keys1, void* weights1,
                              void* counts, void* totals, void* keys_out,
                              void* counts_out, void* stream) {
  if (q < 1 || q > kMaxQ || last_bits < 1 || last_bits > kLimbBits ||
      segment_shift < 1 || segment_shift > 30 ||
      blocks < 1 || blocks > kMaxBlocks || n_slots < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<long long*>(counts);
  auto* t = static_cast<long long*>(totals);
  long long* digit_totals = t + 2;
  long long* key_buf[2] = {static_cast<long long*>(keys0),
                           static_cast<long long*>(keys1)};
  long long* weight_buf[2] = {static_cast<long long*>(weights0),
                              static_cast<long long*>(weights1)};
  const Rows slots{n_slots, static_cast<const int*>(seg_counts),
                   segment_shift, nullptr};
  const Rows live{n_slots, nullptr, 0, t};
  int src = 0;
  for (int limb = q - 1; limb >= 0; --limb) {
    const int bits = limb == q - 1 ? last_bits : kLimbBits;
    for (int shift = 0; shift < bits; shift += kDigitBits) {
      const int bins = 1 << min(kDigitBits, bits - shift);
      const bool first = limb == q - 1 && shift == 0;
      const Rows& rows = first ? slots : live;
      sc_count<false><<<blocks, kThreads, 0, s>>>(
          key_buf[src], q, rows, limb, shift, bins, blocks, c);
      sc_scan<<<bins, kThreads, 0, s>>>(c, blocks, digit_totals);
      sc_scatter<<<blocks, kThreads, 0, s>>>(
          key_buf[src], weight_buf[src], q, rows, limb, shift, bins, blocks,
          c, digit_totals, key_buf[1 - src], weight_buf[1 - src],
          first ? t : nullptr);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      src = 1 - src;
    }
  }
  sc_count<true><<<blocks, kThreads, 0, s>>>(key_buf[src], q, live, 0, 0, 1,
                                             blocks, c);
  sc_scan<<<1, kThreads, 0, s>>>(c, blocks, t + 1);
  sc_combine<<<blocks, kThreads, 0, s>>>(
      key_buf[src], weight_buf[src], q, live, blocks, c,
      static_cast<long long*>(keys_out), static_cast<long long*>(counts_out));
  return static_cast<int>(cudaGetLastError());
}
