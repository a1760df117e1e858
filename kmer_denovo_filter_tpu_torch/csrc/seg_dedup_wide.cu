// Kernel K9dw: the dedup local to each 8,192-row segment of a stream of
// wide window keys (k = 33..207: rows of Q = 2..7 int64 limbs, limb 0
// first, compared row-lexicographically, the sentinel INT64_MAX in every
// limb).
//
// It replaces the XLA front half of the JAX dedup-first wide tally,
// kmer_denovo_filter_tpu/ops/pallas_join.py:_dedup_compact_wide (:1494,
// via join_tally_flat_wide_dedup :1564): each segment's distinct live
// rows, ascending, with their multiplicities (int64 weights) at the front
// of the segment's slot, and the segment's distinct count.  Rows past the
// count are left unwritten; sentinel rows form no run.  Kernel K7
// (probe_wide.cu) reads the slots as they stand, so the step K1w -> K9dw
// -> K7 needs no compaction, no host sync and no global sort.  The TPU's
// route-hash order, its 13-step log-shift compaction and its u_chunk
// capacity (with an overflow flag) are workarounds for a slow TPU
// scatter; nothing here can overflow.
//
// Design.  One block of 512 threads a segment, K9d's recipe carried to
// rows (seg_sort.cu):
//  1. Count the segment into a shared-memory hash of 8,192 slots: a
//     64-bit word holds 50 bits of the row's fingerprint and the index of
//     its first occurrence in the segment (claimed by one atomicCAS, so
//     the index arrives with the fingerprint), beside a 32-bit count.  A
//     fingerprint match is confirmed on all Q limbs, the claimer's read
//     from global memory through L1; a false match probes on.  The hash
//     gives up, as K9d's does, when more than 7/8 of the live rows among
//     the first 512 are distinct (random-like data) or past 6,144
//     distinct rows.
//  2. Sort the distinct rows (or, after a give-up, all 8,192) by limb 0
//     with their element index as the payload carried: K9's register
//     network (block_sort.cuh), on p = max(512, 2^ceil(log2(rows)))
//     elements.
//  3. Order each run of equal limb 0 by limbs 1..Q-1.  Two distinct rows
//     tie on limb 0 only when they share their first 31 bases (a read
//     error in the last k - 31 bases): such a group of up to 32 rows is
//     sorted by one thread, by insertion, its rows read through L1 (a
//     40x batch at k = 201 holds ~1,000 such groups a segment, of up to
//     ~10 rows: a thread takes its groups one after another, so a warp's
//     lanes work side by side).  A larger group (past a give-up: one that
//     is not a single repeated row) makes the block sort all its elements
//     again, limb by limb from the last (an LSD sort: each pass keyed by
//     the limb, the element's position in the pass before in the
//     payload's high bits, pairs ordered lexicographically, so every
//     pass is stable).
//  4. Write the rows and weights: from the hash's counts, or, after a
//     give-up, the run lengths of the sorted rows (a run starts at a live
//     row that differs from the row before; their ranks by a block scan).
// Every step is exact and the output deterministic: the hash's slot order
// depends on the race of its inserts, the sorted rows do not.
//
// Shared memory: 96 KB of hash (8,192 words, 8,192 counts) that the sort
// then reuses for its key buffer (64 KB) and payload buffer (32 KB), and
// 32 KB for the hash path's element table (row index | count << 13) or
// the run starts; one block an SM.
//
// The unordered form (seg_dedup_wide_kernel<Q, false>), for a consumer
// that reads no order among a segment's rows and adds weights that
// commute (the parent filter's K7): step 1, then no sort and no tie
// pass.  A segment the hash kept writes its distinct rows (each row's
// first occurrence) with their counts; one it gave up on is passed
// through: every live row, of weight 1, their number its count (a
// name-sorted batch's segments hold no repeats, so every one is passed
// through).  A kept segment leaves in the hash's slot order, a passed
// one in row order (block_sort.cuh's RowOrder); a per-segment flag says
// which segments were passed through.  K7 on a 2^28-row table probes
// row-ordered rows about 1.1x slower than sorted ones (PERF.md), less
// than the sort and the tie pass cost here.  The hash's 96 KB of shared
// memory and a 1 KB row-order table, at most 64 registers: two blocks
// an SM (the ordered form: 128 KB, 128 registers, one).

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "block_sort.cuh"

namespace {

using kdf::block_exclusive_sum;
using kdf::block_sort;
using kdf::kLogSegment;
using kdf::kSegment;
using kdf::kSentinel;
using kdf::row_order_count;
using kdf::row_order_place;
using kdf::row_order_scan;
using kdf::RowOrder;
using kdf::swizzle;

constexpr int kThreads = kdf::kSortThreads;
constexpr int kRegs = kdf::kSortRegs;
constexpr int kWarps = kdf::kSortWarps;
constexpr int kLogSlots = 13;
constexpr int kSlots = 1 << kLogSlots;  // hash slots
constexpr int kLimit = 6144;  // distinct rows past which a block sorts all
constexpr int kSerialTie = 32;  // limb-0 ties a thread sorts by insertion
constexpr int kIndexMask = kSegment - 1;
constexpr unsigned long long kWordIndexMask = kIndexMask;
constexpr unsigned long long kClaimed = 1ull << 63;  // 0 is an empty slot
// the hash (or the sort's buffers), then the element table
constexpr size_t kSmemBytes = kSegment * (sizeof(long long) + 2 * sizeof(int));
constexpr size_t kHashBytes = kSlots * (sizeof(long long) + sizeof(int));
static_assert(kSlots == kSegment, "the sort's buffers reuse the hash's bytes");

// 64-bit fingerprint of a row: a multiply-xorshift round per limb.  Its
// top 13 bits pick the first slot; bits 13..62 are kept in the slot.
template <int Q>
__device__ __forceinline__ unsigned long long row_hash(
    const long long (&v)[Q]) {
  unsigned long long h = 0;
#pragma unroll
  for (int l = 0; l < Q; ++l) {
    h = (h ^ static_cast<unsigned long long>(v[l])) * 0x9E3779B97F4A7C15ull;
    h ^= h >> 29;
  }
  return h * 0xBF58476D1CE4E5B9ull;
}

// Row `row` of the segment at `rows` (Q limbs), sentinel at or past
// `live_rows` (the stream's end).
template <int Q>
__device__ __forceinline__ void load_row(const long long* __restrict__ rows,
                                         int live_rows, int row,
                                         long long (&v)[Q]) {
#pragma unroll
  for (int l = 0; l < Q; ++l) {
    v[l] = row < live_rows ? __ldg(rows + static_cast<long long>(row) * Q + l)
                           : kSentinel;
  }
}

// Both compares load all the row's limbs first: one round trip.
template <int Q>
__device__ __forceinline__ bool row_equals(const long long* __restrict__ r,
                                           const long long (&v)[Q]) {
  long long x[Q];
#pragma unroll
  for (int l = 0; l < Q; ++l) x[l] = __ldg(r + l);
  bool equal = true;
#pragma unroll
  for (int l = 0; l < Q; ++l) equal &= x[l] == v[l];
  return equal;
}

// Whether (limbs 1..Q-1 of row r, er) sort after (those of v, ev): the
// rows' limbs 0 tie.
template <int Q>
__device__ __forceinline__ bool tail_after(const long long* __restrict__ r,
                                           int er, const long long (&v)[Q],
                                           int ev) {
  long long x[Q];
#pragma unroll
  for (int l = 1; l < Q; ++l) x[l] = __ldg(r + l);
#pragma unroll
  for (int l = 1; l < Q; ++l) {
    if (x[l] != v[l]) return x[l] > v[l];
  }
  return er > ev;
}

// Counts the segment's rows [0, live_rows) into the hash; returns the
// number of distinct live rows, or -1 once more than kLimit have been
// claimed, or when more than 7/8 of the live rows among the first
// kThreads are distinct.  Threads stop inserting at their next row after
// the flag is raised, so at most kLimit + kThreads of the kSlots slots
// are ever claimed and every probe sequence ends.
template <int Q>
__device__ __forceinline__ int hash_rows(const long long* __restrict__ rows,
                                         int live_rows,
                                         unsigned long long* hword,
                                         int* hcount, int* n_distinct,
                                         int* n_live, int* overflow) {
  const int t = threadIdx.x;
  for (int s = t; s < kSlots; s += kThreads) {
    hword[s] = 0;
    hcount[s] = 0;
  }
  if (t == 0) {
    *n_distinct = 0;
    *n_live = 0;
    *overflow = 0;
  }
  __syncthreads();
  // one row of the segment: a live row claims a slot or finds its own
  const auto insert = [&](int r) {
    const int idx = t + r * kThreads;
    long long v[Q];
    load_row<Q>(rows, live_rows, idx, v);
    if (r == 0) {  // the first round counts its live rows, a warp at once
      const unsigned live = __ballot_sync(0xFFFFFFFFu, v[0] != kSentinel);
      if ((t & 31) == 0) atomicAdd(n_live, __popc(live));
    }
    if (v[0] == kSentinel) return;
    const unsigned long long h = row_hash<Q>(v);
    const unsigned long long word = (h & ~kWordIndexMask) | kClaimed | idx;
    int s = static_cast<int>(h >> (64 - kLogSlots));
    for (;;) {
      const unsigned long long prev = atomicCAS(hword + s, 0ull, word);
      if (prev == 0) {
        if (atomicAdd(n_distinct, 1) >= kLimit) *overflow = 1;
        atomicAdd(hcount + s, 1);
        return;
      }
      if (((prev ^ word) & ~kWordIndexMask) == 0 &&
          row_equals<Q>(rows + static_cast<long long>(prev & kWordIndexMask) *
                                   Q,
                        v)) {
        atomicAdd(hcount + s, 1);
        return;
      }
      s = (s + 1) & (kSlots - 1);
    }
  };
  insert(0);
  __syncthreads();
  const bool random_like = *n_distinct * 8 > *n_live * 7;
  __syncthreads();  // all have read it before any insert moves it
  if (random_like) return -1;
  for (int r = 1; r < kRegs; ++r) {
    if (*static_cast<volatile int*>(overflow)) break;
    insert(r);
  }
  __syncthreads();
  return *overflow ? -1 : *n_distinct;
}

// Sorts the elements at sorted positions [lo, hi) (a run of equal limb 0,
// hi - lo <= kSerialTie) by limbs 1..Q-1, then by element, by insertion:
// one thread, rows read through L1.
template <int Q, typename RowOf>
__device__ __forceinline__ void sort_tie(int* spay, int lo, int hi,
                                         const long long* __restrict__ rows,
                                         RowOf row_of) {
  for (int a = lo + 1; a < hi; ++a) {
    const int ea = spay[swizzle(a)];
    long long v[Q];
    const long long* ra = rows + row_of(ea) * Q;
#pragma unroll
    for (int l = 1; l < Q; ++l) v[l] = __ldg(ra + l);
    int b = a - 1;
    for (; b >= lo; --b) {
      const int eb = spay[swizzle(b)];
      if (!tail_after<Q>(rows + row_of(eb) * Q, eb, v, ea)) break;
      spay[swizzle(b + 1)] = eb;
    }
    spay[swizzle(b + 1)] = ea;
  }
}

// Whether every row at sorted positions [lo, hi) equals the first.
template <int Q, typename RowOf>
__device__ __forceinline__ bool one_row(const int* spay, int lo, int hi,
                                        const long long* __restrict__ rows,
                                        RowOf row_of) {
  long long v[Q];
  load_row<Q>(rows, kSegment, static_cast<int>(row_of(spay[swizzle(lo)])),
              v);
  for (int i = lo + 1; i < hi; ++i) {
    const long long row = row_of(spay[swizzle(i)]);
    if (!row_equals<Q>(rows + row * Q, v)) return false;
  }
  return true;
}

// K9dw's unordered form over segment blockIdx.x, after the hash
// (`distinct` its result): a segment the hash kept writes each distinct
// row (its first occurrence, read again through L1 / L2) with its count,
// in slot order; one it gave up on is passed through, each live row of
// weight 1, in row order (block_sort.cuh's RowOrder); no sort and no tie
// pass.  passed[segment] is 1 for a segment passed through, else 0.
template <int Q>
__device__ __forceinline__ void write_unordered(
    int distinct, const long long* __restrict__ rows, int live_rows,
    const unsigned long long* hword, const int* hcount,
    long long* __restrict__ out_rows, long long* __restrict__ out_weights,
    int32_t* __restrict__ counts, int32_t* __restrict__ passed) {
  __shared__ RowOrder order;
  const int t = threadIdx.x;
  const bool pass = distinct < 0;
  // thread t takes rows t + 512 r, or slots t + 512 r: the row to write,
  // kSegment for none
  const auto row_of = [&](int r) -> int {
    const int i = t + r * kThreads;
    if (!pass) {
      const unsigned long long w = hword[i];
      return w == 0 ? kSegment : static_cast<int>(w & kWordIndexMask);
    }
    return i < live_rows && __ldg(rows + static_cast<long long>(i) * Q) !=
                                kSentinel
               ? i
               : kSegment;
  };
#pragma unroll 4
  for (int r = 0; r < kRegs; ++r) {
    row_order_count(&order, r, row_of(r) != kSegment);
  }
  const int n_out = row_order_scan(&order, kRegs);
#pragma unroll 4
  for (int r = 0; r < kRegs; ++r) {
    const int row = row_of(r);
    const int pos = row_order_place(&order, r, row != kSegment);
    if (row == kSegment) continue;
    const long long* const src = rows + static_cast<long long>(row) * Q;
    long long* const dst = out_rows + static_cast<long long>(pos) * Q;
#pragma unroll
    for (int l = 0; l < Q; ++l) dst[l] = __ldg(src + l);
    out_weights[pos] = pass ? 1 : hcount[t + r * kThreads];
  }
  if (t == 0) {
    counts[blockIdx.x] = n_out;
    passed[blockIdx.x] = pass;
  }
}

// K9dw's ordered form over segment blockIdx.x, after the hash
// (`distinct` its result; smem the kernel's 128 KB): steps 2 to 4.
template <int Q>
__device__ __forceinline__ void write_sorted(
    int distinct, const long long* __restrict__ rows, int live_rows,
    long long* smem, long long* __restrict__ out_rows,
    long long* __restrict__ out_weights, int32_t* __restrict__ counts) {
  __shared__ int sums[kWarps];
  __shared__ int big_tie;
  const int t = threadIdx.x;
  const int* const hcount = reinterpret_cast<int*>(smem + kSlots);
  const auto* const hword = reinterpret_cast<unsigned long long*>(smem);
  long long* const skey = smem;  // the sort's buffers reuse the hash
  int* const spay = reinterpret_cast<int*>(smem + kSegment);
  int* const elem = spay + kSegment;  // hash path: row | count << 13
  const bool hashed = distinct >= 0;
  const auto row_of = [&](int e) -> long long {
    return hashed ? elem[e] & kIndexMask : e;
  };
  long long key[kRegs];
  int pay[kRegs];
  int log_p = kLogSegment;
  if (hashed) {
    // the occupied slots, 16 a thread, compacted into elem by a scan
    constexpr int kPer = kSlots / kThreads;
    int occupied = 0;
#pragma unroll
    for (int m = 0; m < kPer; ++m) occupied += hword[t * kPer + m] != 0;
    int total;
    int pos = block_exclusive_sum(occupied, sums, &total);
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const unsigned long long w = hword[t * kPer + m];
      if (w != 0) {
        elem[pos++] = static_cast<int>(w & kWordIndexMask) |
                      (hcount[t * kPer + m] << kLogSegment);
      }
    }
    __syncthreads();  // elem complete; the hash is read no more
    log_p = 9;
    while ((1 << log_p) < distinct) ++log_p;
    const int holders = (1 << log_p) / kRegs;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int e = t + r * holders;
      key[r] = t < holders && e < distinct ? __ldg(rows + row_of(e) * Q)
                                           : kSentinel;
      pay[r] = e;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int row = t + r * kThreads;
      key[r] = row < live_rows ? __ldg(rows + static_cast<long long>(row) * Q)
                               : kSentinel;
      pay[r] = row;
    }
  }
  block_sort<kdf::Sort::kCarried>(key, pay, log_p, skey, spay);
  const int p = 1 << log_p;
  const bool holds = t < p / kRegs;
  if (holds) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      skey[swizzle(t * kRegs + r)] = key[r];
      spay[swizzle(t * kRegs + r)] = pay[r];
    }
  }
  if (t == 0) big_tie = 0;
  __syncthreads();
  // the limb-0 ties: each run of equal live limb 0 by the thread that
  // holds its first element, a thread's runs one after the other (the
  // lanes of a warp side by side, not one register at a time)
  if (holds) {
    unsigned firsts = 0;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int i = t * kRegs + r;
      const long long before =
          r > 0 ? key[r - 1] : (i > 0 ? skey[swizzle(i - 1)] : kSentinel);
      const long long after =
          r + 1 < kRegs ? key[r + 1]
                        : (i + 1 < p ? skey[swizzle(i + 1)] : kSentinel);
      if (key[r] != kSentinel && before != key[r] && after == key[r]) {
        firsts |= 1u << r;
      }
    }
    while (firsts != 0) {
      const int i = t * kRegs + __ffs(firsts) - 1;
      firsts &= firsts - 1;
      const long long k = skey[swizzle(i)];
      int end = i + 2;
      while (end < p && skey[swizzle(end)] == k) ++end;
      if (end - i <= kSerialTie) {
        sort_tie<Q>(spay, i, end, rows, row_of);
      } else if (hashed || !one_row<Q>(spay, i, end, rows, row_of)) {
        big_tie = 1;
      }
    }
  }
  __syncthreads();
  if (big_tie) {
    // all elements again, by limb Q - 1 down to limb 0, each pass stable
    // on the position of the pass before; a live row's limbs are all
    // below the sentinel, so dead elements stay last
    const int holders = p / kRegs;
#pragma unroll 1
    for (int j = Q - 1; j >= 0; --j) {
      if (holds) {
#pragma unroll
        for (int r = 0; r < kRegs; ++r) {
          const int i = t + r * holders;
          const int e = spay[swizzle(i)] & kIndexMask;
          key[r] = skey[swizzle(i)] == kSentinel
                       ? kSentinel
                       : __ldg(rows + row_of(e) * Q + j);
          pay[r] = (i << kLogSegment) | e;
        }
      }
      __syncthreads();  // every load done before the sort stores
      block_sort<kdf::Sort::kLexicographic>(key, pay, log_p, skey, spay);
      if (holds) {
#pragma unroll
        for (int r = 0; r < kRegs; ++r) {
          skey[swizzle(t * kRegs + r)] = key[r];
          spay[swizzle(t * kRegs + r)] = pay[r] & kIndexMask;
        }
      }
      __syncthreads();
    }
  }
  if (hashed) {
    // every live element a distinct row, its count from the hash
    for (int x = t; x < distinct * Q; x += kThreads) {
      const int q = x / Q;
      const int row = elem[spay[swizzle(q)]] & kIndexMask;
      out_rows[x] = __ldg(rows + static_cast<long long>(row) * Q + (x - q * Q));
    }
    for (int q = t; q < distinct; q += kThreads) {
      out_weights[q] = elem[spay[swizzle(q)]] >> kLogSegment;
    }
    if (t == 0) counts[blockIdx.x] = distinct;
    return;
  }
  // all rows sorted: a run starts at a live row that differs from the
  // row before; runs | live rows << 16 by one block scan (both <= 8,192)
  int* const start = elem;
  unsigned starts = 0;
  int packed = 0;
#pragma unroll 1
  for (int r = 0; r < kRegs; ++r) {
    const int i = t * kRegs + r;
    const long long k = skey[swizzle(i)];
    if (k == kSentinel) continue;
    packed += 1 << 16;
    bool fresh = i == 0 || skey[swizzle(i - 1)] != k;
    if (!fresh) {
      long long v[Q];
      load_row<Q>(rows, kSegment, spay[swizzle(i)], v);
      fresh = !row_equals<Q>(
          rows + static_cast<long long>(spay[swizzle(i - 1)]) * Q, v);
    }
    if (fresh) {
      starts |= 1u << r;
      packed += 1;
    }
  }
  int total;
  const int exclusive = block_exclusive_sum(packed, sums, &total);
  const int n_runs = total & 0xFFFF;
  const int n_live_rows = total >> 16;
  int rank = exclusive & 0xFFFF;
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    if (starts >> r & 1u) start[rank++] = t * kRegs + r;
  }
  __syncthreads();
  for (int x = t; x < n_runs * Q; x += kThreads) {
    const int q = x / Q;
    const int row = spay[swizzle(start[q])];
    out_rows[x] = __ldg(rows + static_cast<long long>(row) * Q + (x - q * Q));
  }
  for (int q = t; q < n_runs; q += kThreads) {
    out_weights[q] = (q + 1 < n_runs ? start[q + 1] : n_live_rows) - start[q];
  }
  if (t == 0) counts[blockIdx.x] = n_runs;
}

// K9dw over segment blockIdx.x of rows[0, n) (rows past n are sentinel):
// the hash, then write_sorted or write_unordered.  The unordered form
// reads only the hash's 96 KB of shared memory and holds no sort in
// registers: two blocks an SM, where the ordered form fits one.
template <int Q, bool kOrdered>
__global__ void __launch_bounds__(kThreads, kOrdered ? 1 : 2)
    seg_dedup_wide_kernel(const long long* __restrict__ keys, long long n,
                          long long* __restrict__ keys_out,
                          long long* __restrict__ weights_out,
                          int32_t* __restrict__ counts,
                          int32_t* __restrict__ passed) {
  extern __shared__ long long smem[];
  __shared__ int n_distinct;
  __shared__ int n_live;
  __shared__ int overflow;
  const long long base = static_cast<long long>(blockIdx.x) * kSegment;
  const long long* const rows = keys + base * Q;
  const int live_rows =
      static_cast<int>(n - base < kSegment ? n - base : kSegment);
  auto* const hword = reinterpret_cast<unsigned long long*>(smem);
  int* const hcount = reinterpret_cast<int*>(smem + kSlots);
  // -1: sort all rows (ordered) or pass them through (unordered)
  const int distinct = hash_rows<Q>(rows, live_rows, hword, hcount,
                                    &n_distinct, &n_live, &overflow);
  if constexpr (kOrdered) {
    write_sorted<Q>(distinct, rows, live_rows, smem, keys_out + base * Q,
                    weights_out + base, counts);
  } else {
    write_unordered<Q>(distinct, rows, live_rows, hword, hcount,
                       keys_out + base * Q, weights_out + base, counts,
                       passed);
  }
}

std::atomic<uint64_t> opted_in[2][8];

template <int Q, bool kOrdered>
int launch(const void* keys, long long n, void* keys_out, void* weights_out,
           void* counts, void* passed, void* stream) {
  // the unordered form reads the hash alone
  constexpr size_t bytes = kOrdered ? kSmemBytes : kHashBytes;
  const cudaError_t err = kdf::opt_in_smem(
      seg_dedup_wide_kernel<Q, kOrdered>, bytes, opted_in[kOrdered][Q]);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_dedup_wide_kernel<Q, kOrdered>
      <<<static_cast<unsigned>((n + kSegment - 1) / kSegment), kThreads,
         bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const long long*>(keys), n,
          static_cast<long long*>(keys_out),
          static_cast<long long*>(weights_out),
          static_cast<int32_t*>(counts), static_cast<int32_t*>(passed));
  return static_cast<int>(cudaGetLastError());
}

template <int Q>
int launch(const void* keys, long long n, int ordered, void* keys_out,
           void* weights_out, void* counts, void* passed, void* stream) {
  return ordered ? launch<Q, true>(keys, n, keys_out, weights_out, counts,
                                   passed, stream)
                 : launch<Q, false>(keys, n, keys_out, weights_out, counts,
                                    passed, stream);
}

}  // namespace

// K9dw over the (n, q) rows keys: for each of the ceil(n / 8,192)
// segments (rows past n count as sentinel rows), ordered (ordered != 0),
// its distinct live rows ascending with their int64 multiplicities at
// the front of the segment's slot of keys_out (8,192 x q) / weights_out
// (8,192), and their number to counts[segment] (int32).  Unordered,
// counts[segment] live rows whose weights sum, row by row, to the row's
// multiplicity, in no set order and not always merged, and
// passed[segment] (int32) 1 where the segment was passed through (every
// live row, of weight 1), else 0; the ordered form leaves passed (which
// may be null) alone.  cudaErrorInvalidValue for q outside 2..7.
extern "C" int kdf_seg_dedup_wide(const void* keys, long long n, int q,
                                  int ordered, void* keys_out,
                                  void* weights_out, void* counts,
                                  void* passed, void* stream) {
  switch (q) {
    case 2:
      return launch<2>(keys, n, ordered, keys_out, weights_out, counts,
                        passed, stream);
    case 3:
      return launch<3>(keys, n, ordered, keys_out, weights_out, counts,
                        passed, stream);
    case 4:
      return launch<4>(keys, n, ordered, keys_out, weights_out, counts,
                        passed, stream);
    case 5:
      return launch<5>(keys, n, ordered, keys_out, weights_out, counts,
                        passed, stream);
    case 6:
      return launch<6>(keys, n, ordered, keys_out, weights_out, counts,
                        passed, stream);
    case 7:
      return launch<7>(keys, n, ordered, keys_out, weights_out, counts,
                        passed, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
