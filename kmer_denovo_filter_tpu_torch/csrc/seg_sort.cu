// Kernels K9 and K9d: a sort local to each 8,192-row segment of a flat
// int64 window-key stream, and a dedup local to each segment.  Both sort
// by the register bitonic network of block_sort.cuh, which kernel K9dw
// (seg_dedup_wide.cu) shares.
//
// K9 (kdf_seg_sort) replaces the Pallas TPU kernel
// scripts/x_fused.py:_sort_kernel (:133, via seg_sort_pallas :144): an
// in-VMEM bitonic sort of each 8,192-row segment by key with one payload
// riding along.  Here the key is the port's int64 k-mer key (INT64_MAX =
// invalid window, sorting last under the signed compare) and the payload
// an optional int32.  The TPU kernel emits its segment in a lane-major
// order (row * 128 + lane mapped to lane * 64 + row); this one writes it
// in plain ascending order.  One block of 512 threads sorts a segment,
// 16 keys (and payloads) a thread in registers, with 8 barriers where a
// shared-memory port of the TPU network took 91 (0.44 ms a 32,768 x
// 152 bp batch on an H100, 15x its bound; PERF.md).  The payload rides
// beside its key, compared on the key alone by a strict rule that never
// drops or duplicates it; the order within equal keys is unspecified, as
// on the TPU.  Rows leave through shared memory in coalesced stores.
//
// K9d (kdf_seg_dedup) replaces the XLA front half of the dedup-first
// tally, kmer_denovo_filter_tpu/ops/pallas_join.py:_dedup_compact (:600,
// with _dedup_compact_sorted :625): each segment's distinct live keys,
// ascending, with their multiplicities (int64 weights) at the front of
// the segment's slot, and the segment's distinct count.  Rows past the
// count are left unwritten.  Sentinel rows form no run: an all-sentinel
// segment yields a count of 0.  Kernel K3 reads the slots as they stand
// (probe_tally.cu), so the step K1 -> K9d -> K3 needs no compaction, no
// host sync and no global sort.  The TPU's 13-step log-shift compaction
// and its u_chunk capacity (with an overflow flag and a retry ladder)
// are workarounds for a slow TPU scatter; nothing here can overflow.
//
// K9d's design.  One block of 512 threads takes a segment, 16 keys a
// thread in registers, and sorts by block_sort (on the shared-memory
// network of K9's first port K9d took ~0.30 ms on a 40x batch, 25x its
// bound, PERF.md).
//
// Real reads repeat a k-mer in ~40 reads: a 40x batch's segment holds
// ~1,090 distinct keys of its 8,192 (PERF.md).  So a block first counts
// its segment into a shared-memory hash (4,096 slots, linear probing,
// 64-bit atomicCAS, 32-bit counts); when that yields at most 3,072
// distinct keys it sorts only those, compacted and padded with the
// sentinel to p = max(512, 2^ceil(log2(distinct))) rows, on the first
// p / 16 threads, and reads each key's weight back from the hash.  A
// segment past 3,072 distinct keys abandons the hash, and so does one
// whose first 512 rows (~4 consecutive reads) are more than 7/8 distinct
// among their live keys (random data; sorted reads repeat about half);
// such a segment sorts all 8,192 rows, its weights the run lengths of the
// sorted order (a run start is a live key differing from the row before;
// their ranks by a block-wide warp-shuffle scan).  Both are exact and
// deterministic: the hash's slot order depends on the race of its
// inserts, the sorted output does not.  On an H100 (PERF.md) the hash
// design took 0.077 ms on a 40x batch and 0.149 on random reads, the
// register sort of all rows without the hash 0.122 and 0.135: the hash
// stays, for the 40x data of a parent BAM.  96 KB of shared memory and
// 64 registers a thread (two blocks an SM).
//
// Bound: by bytes.  K9d reads 8 B a row and writes 16 B per distinct key
// and 4 B per segment: ~0.012 ms for the 532,235 segment rows of a
// 40x batch of 32,768 x 152 bp at 3.35 TB/s.
//
// K9d's unordered form (seg_dedup_kernel<false>), for a consumer that
// reads no order among a segment's keys and adds weights that commute
// (the parent filter's K3): the same hash and give-up, then no sort.  A
// segment the hash kept writes its distinct keys with their counts; one
// it gave up on is passed through: every live key, of weight 1, their
// number its count (a name-sorted batch's segments hold no repeats, so
// every one is passed through).  A kept segment leaves in the hash's
// slot order, a passed one in row order (block_sort.cuh's RowOrder: a
// ballot a warp and round, one block scan, coalesced stores); a
// per-segment flag says which segments were passed through.  K3 on a
// 2^27-key table probes row-ordered keys about 1.3x slower than sorted
// ones (the blocks, a segment each, no longer sweep the table in step;
// PERF.md), less than the sort costs here.  The hash's 48 KB of shared
// memory and a 1 KB row-order table, at most 32 registers: four blocks
// an SM, a batch's 488 segments in one wave (the ordered form: 96 KB and
// 64 registers, two blocks).

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

// ── K9 ──────────────────────────────────────────────────────────────

// Shared memory of K9: the sort's key buffer (64 KB) and, with a
// payload, its payload buffer (32 KB).
constexpr size_t sort_smem_bytes(bool payload) {
  return kSegment * (sizeof(long long) + (payload ? sizeof(int) : 0));
}

// K9 over segment blockIdx.x: thread t takes rows t + 512 r (coalesced)
// as its elements 16 t + r (a sorting network sorts any arrangement),
// sorts them by block_sort (the payload carried) and writes them back
// through shared memory in coalesced stores.  With a payload one block
// an SM (~100 registers), without one two.
template <bool kPayload>
__global__ void __launch_bounds__(kThreads, kPayload ? 1 : 2)
    seg_sort_kernel(const long long* __restrict__ keys,
                    const int32_t* __restrict__ payload,
                    long long* __restrict__ keys_out,
                    int32_t* __restrict__ payload_out) {
  extern __shared__ long long smem[];
  int* const pbuf = reinterpret_cast<int*>(smem + kSegment);
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kSegment;
  long long key[kRegs];
  int pay[kRegs];
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    key[r] = __ldg(keys + base + t + r * kThreads);
    if constexpr (kPayload) pay[r] = __ldg(payload + base + t + r * kThreads);
  }
  block_sort<kPayload ? kdf::Sort::kCarried : kdf::Sort::kKeys>(
      key, pay, kLogSegment, smem, pbuf);
  // each thread overwrites only the elements it reloaded last
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    smem[swizzle(t * kRegs + r)] = key[r];
    if constexpr (kPayload) pbuf[swizzle(t * kRegs + r)] = pay[r];
  }
  __syncthreads();
  for (int i = t; i < kSegment; i += kThreads) {
    keys_out[base + i] = smem[swizzle(i)];
    if constexpr (kPayload) payload_out[base + i] = pbuf[swizzle(i)];
  }
}

// ── K9d ─────────────────────────────────────────────────────────────

constexpr int kHashSlots = 4096;
constexpr int kHashLimit = 3072;  // distinct keys past which a block sorts all
constexpr size_t kHashBytes = kHashSlots * (sizeof(long long) + sizeof(int));
// the hash, then the sort buffer of its <= 4,096 compacted keys; a block
// that sorts all 8,192 rows uses the same bytes from offset 0 for its
// sort buffer (64 KB) and its run starts (32 KB)
constexpr size_t kDedupSmemBytes =
    kSegment * (sizeof(long long) + sizeof(int));
static_assert(kDedupSmemBytes >= kHashBytes + kHashSlots * sizeof(long long),
              "the hash and the compacted keys must fit");

// Writes the runs of the block's sorted 8,192 keys (key[] of every
// thread, natural layout): each run's key and length at ranks 0, 1, ..
// of the segment's slot, and their number to *count.  The keys go to
// `sorted` (8,192 x 8 B of shared memory, swizzled) and the run starts to
// `start` (8,192 int32 of shared memory), so the rows leave in coalesced
// stores.  `sorted` may alias the sort's buffer: each thread overwrites
// only the elements it reloaded last.
__device__ __forceinline__ void write_runs(const long long (&key)[kRegs],
                                           long long* sorted, int* start,
                                           int* sums, long long* warp_last,
                                           long long* __restrict__ keys_out,
                                           long long* __restrict__ weights_out,
                                           int32_t* __restrict__ count) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
#pragma unroll
  for (int r = 0; r < kRegs; ++r) sorted[swizzle(t * kRegs + r)] = key[r];
  long long before = __shfl_up_sync(0xFFFFFFFFu, key[kRegs - 1], 1);
  if (lane == 31) warp_last[warp] = key[kRegs - 1];
  __syncthreads();
  if (lane == 0) before = warp > 0 ? warp_last[warp - 1] : kSentinel;
  // runs | live rows << 16: both at most 8,192
  unsigned starts = 0;
  int packed = 0;
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const long long prev = r > 0 ? key[r - 1] : before;
    if (key[r] == kSentinel) continue;
    packed += 1 << 16;
    if (key[r] != prev) {
      starts |= 1u << r;
      packed += 1;
    }
  }
  int total;
  const int exclusive = block_exclusive_sum(packed, sums, &total);
  const int n_runs = total & 0xFFFF;
  const int n_live = total >> 16;
  int rank = exclusive & 0xFFFF;
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    if (starts >> r & 1u) start[rank++] = t * kRegs + r;
  }
  __syncthreads();
  for (int q = t; q < n_runs; q += kThreads) {
    const int pos = start[q];
    keys_out[q] = sorted[swizzle(pos)];
    weights_out[q] = (q + 1 < n_runs ? start[q + 1] : n_live) - pos;
  }
  if (t == 0) *count = n_runs;
}

// Hash slot of a live key: the top 12 bits of a Fibonacci product.
__device__ __forceinline__ int hash_slot(long long k) {
  return static_cast<int>((static_cast<unsigned long long>(k) *
                           0x9E3779B97F4A7C15ull) >> (64 - 12));
}

// The count of a sorted distinct key: its slot in the hash (it is there).
__device__ __forceinline__ int hash_count(const unsigned long long* hkey,
                                          const int* hcount, long long k) {
  int s = hash_slot(k);
  while (hkey[s] != static_cast<unsigned long long>(k)) {
    s = (s + 1) & (kHashSlots - 1);
  }
  return hcount[s];
}

// Counts the segment's rows [base, base + 8,192) of keys[0, n) into the
// hash; returns the number of distinct keys, or -1 once more than
// kHashLimit have been claimed, or when more than 7/8 of the live keys
// among the first kThreads rows (~4 consecutive reads) are distinct
// (random keys: a sort of all rows is the way, and the rest of the hash
// would be wasted; the reads of a sorted 40x BAM repeat ~1/2 of them).  Threads stop inserting at their next key after
// the flag is raised, so at most kHashLimit + kThreads of the
// kHashSlots slots are ever claimed and every probe sequence ends.
__device__ __forceinline__ int hash_count_segment(
    const long long* __restrict__ keys, long long n, long long base,
    unsigned long long* hkey, int* hcount, int* n_distinct, int* n_live,
    int* overflow) {
  const int t = threadIdx.x;
  for (int s = t; s < kHashSlots; s += kThreads) {
    hkey[s] = kSentinel;  // empty: the sentinel is never inserted
    hcount[s] = 0;
  }
  if (t == 0) {
    *n_distinct = 0;
    *n_live = 0;
    *overflow = 0;
  }
  __syncthreads();
  // one row of the segment: a live key claims a slot or finds its own
  const auto insert = [&](long long r) {
    const long long i = base + t + r * kThreads;
    const long long k = i < n ? __ldg(keys + i) : kSentinel;
    if (r == 0) {  // the first round counts its live rows, a warp at once
      const unsigned live = __ballot_sync(0xFFFFFFFFu, k != kSentinel);
      if ((t & 31) == 0) atomicAdd(n_live, __popc(live));
    }
    if (k == kSentinel) return;
    int s = hash_slot(k);
    for (;;) {
      const unsigned long long prev = atomicCAS(
          hkey + s, static_cast<unsigned long long>(kSentinel),
          static_cast<unsigned long long>(k));
      if (prev == static_cast<unsigned long long>(kSentinel)) {
        if (atomicAdd(n_distinct, 1) >= kHashLimit) *overflow = 1;
        atomicAdd(hcount + s, 1);
        return;
      }
      if (prev == static_cast<unsigned long long>(k)) {
        atomicAdd(hcount + s, 1);
        return;
      }
      s = (s + 1) & (kHashSlots - 1);
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

// K9d's unordered form over segment blockIdx.x, after the hash
// (`distinct` its result): a segment the hash kept writes its distinct
// keys with their counts, in slot order; one it gave up on is passed
// through, each live key of weight 1, in row order (block_sort.cuh's
// RowOrder); no sort.  A passed segment's keys are read twice (the
// second time from L1 / L2).  passed[segment] is 1 for a segment passed
// through, else 0.
__device__ __forceinline__ void write_unordered(
    int distinct, const long long* __restrict__ keys, long long n,
    long long base, const unsigned long long* hkey, const int* hcount,
    long long* __restrict__ keys_out, long long* __restrict__ weights_out,
    int32_t* __restrict__ counts, int32_t* __restrict__ passed) {
  __shared__ RowOrder order;
  const int t = threadIdx.x;
  const bool pass = distinct < 0;
  // thread t takes rows t + 512 r (kRegs rounds) or slots t + 512 r
  constexpr int kRounds = kHashSlots / kThreads;
  const int rounds = pass ? kRegs : kRounds;
  const auto key_of = [&](int r) -> long long {
    if (!pass) return static_cast<long long>(hkey[t + r * kThreads]);
    const long long i = base + t + r * kThreads;
    return i < n ? __ldg(keys + i) : kSentinel;
  };
#pragma unroll 4
  for (int r = 0; r < rounds; ++r) {
    row_order_count(&order, r, key_of(r) != kSentinel);
  }
  const int n_out = row_order_scan(&order, rounds);
#pragma unroll 4
  for (int r = 0; r < rounds; ++r) {
    const long long k = key_of(r);
    const int pos = row_order_place(&order, r, k != kSentinel);
    if (k != kSentinel) {
      keys_out[base + pos] = k;
      weights_out[base + pos] = pass ? 1 : hcount[t + r * kThreads];
    }
  }
  if (t == 0) {
    counts[blockIdx.x] = n_out;
    passed[blockIdx.x] = pass;
  }
}

// K9d's ordered form over segment blockIdx.x, after the hash
// (`distinct` its result; smem the kernel's 96 KB): one block_sort, of
// the compacted distinct keys (weights from the hash) or, after a
// give-up, of all rows (weights the run lengths).
__device__ __forceinline__ void write_sorted(
    int distinct, const long long* __restrict__ keys, long long n,
    long long base, long long* smem, long long* __restrict__ keys_out,
    long long* __restrict__ weights_out, int32_t* __restrict__ counts) {
  __shared__ int sums[kWarps];
  __shared__ long long warp_last[kWarps];
  const int t = threadIdx.x;
  const auto* const hkey = reinterpret_cast<unsigned long long*>(smem);
  const auto* const hcount = reinterpret_cast<int*>(smem + kHashSlots);
  long long key[kRegs];
  int log_p = kLogSegment;
  long long* buf = smem;
  if (distinct < 0) {
    // a sorting network sorts any arrangement: thread t takes rows
    // t + 512 r (coalesced) as its elements 16 t + r
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const long long i = base + t + r * kThreads;
      key[r] = i < n ? __ldg(keys + i) : kSentinel;
    }
  } else {
    // the occupied slots, 8 a thread, compacted into buf by a scan
    constexpr int kPer = kHashSlots / kThreads;
    buf = smem + kHashSlots + kHashSlots / 2;
    int occupied = 0;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      occupied += hkey[t * kPer + m] !=
                  static_cast<unsigned long long>(kSentinel);
    }
    int total;
    int pos = block_exclusive_sum(occupied, sums, &total);
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const unsigned long long k = hkey[t * kPer + m];
      if (k != static_cast<unsigned long long>(kSentinel)) {
        buf[pos++] = static_cast<long long>(k);
      }
    }
    __syncthreads();
    log_p = 9;
    while ((1 << log_p) < distinct) ++log_p;
    const int holders = (1 << log_p) / kRegs;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int i = t + r * holders;
      key[r] = t < holders && i < distinct ? buf[i] : kSentinel;
    }
    __syncthreads();  // every load done before the sort stores into buf
  }
  int none[kRegs];  // no payload: never read
  block_sort<kdf::Sort::kKeys>(key, none, log_p, buf, nullptr);
  if (distinct < 0) {
    write_runs(key, smem, reinterpret_cast<int*>(smem + kSegment), sums,
               warp_last, keys_out + base, weights_out + base,
               counts + blockIdx.x);
    return;
  }
  // the sorted distinct keys through buf, then coalesced stores, every
  // thread reading weights back from the hash
  if (t < (1 << log_p) / kRegs) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) buf[swizzle(t * kRegs + r)] = key[r];
  }
  __syncthreads();
  for (int i = t; i < distinct; i += kThreads) {
    const long long k = buf[swizzle(i)];
    keys_out[base + i] = k;
    weights_out[base + i] = hash_count(hkey, hcount, k);
  }
  if (t == 0) counts[blockIdx.x] = distinct;
}

// K9d over segment blockIdx.x of keys[0, n) (rows past n are sentinel):
// the hash first, then write_sorted or write_unordered.  The unordered
// form reads only the hash's 48 KB of shared memory and holds no sort in
// registers: four blocks an SM, where the ordered form fits two (a
// batch's 488 segments in one wave of 528 blocks).
template <bool kOrdered>
__global__ void __launch_bounds__(kThreads, kOrdered ? 2 : 4)
    seg_dedup_kernel(const long long* __restrict__ keys, long long n,
                     long long* __restrict__ keys_out,
                     long long* __restrict__ weights_out,
                     int32_t* __restrict__ counts,
                     int32_t* __restrict__ passed) {
  extern __shared__ long long smem[];
  __shared__ int n_distinct;
  __shared__ int n_live;
  __shared__ int overflow;
  const long long base = static_cast<long long>(blockIdx.x) * kSegment;
  auto* const hkey = reinterpret_cast<unsigned long long*>(smem);
  auto* const hcount = reinterpret_cast<int*>(smem + kHashSlots);
  // -1: sort all rows (ordered) or pass them through (unordered)
  const int distinct = hash_count_segment(keys, n, base, hkey, hcount,
                                          &n_distinct, &n_live, &overflow);
  if constexpr (kOrdered) {
    write_sorted(distinct, keys, n, base, smem, keys_out, weights_out,
                 counts);
  } else {
    write_unordered(distinct, keys, n, base, hkey, hcount, keys_out,
                    weights_out, counts, passed);
  }
}

std::atomic<uint64_t> sort_opted_in{0};
std::atomic<uint64_t> sort_payload_opted_in{0};
std::atomic<uint64_t> dedup_opted_in[2];

template <bool kOrdered>
int launch_dedup(const void* keys, long long n, void* keys_out,
                 void* weights_out, void* counts, void* passed,
                 void* stream) {
  // the unordered form reads the hash alone
  constexpr size_t bytes = kOrdered ? kDedupSmemBytes : kHashBytes;
  const cudaError_t err = kdf::opt_in_smem(seg_dedup_kernel<kOrdered>, bytes,
                                           dedup_opted_in[kOrdered]);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_dedup_kernel<kOrdered>
      <<<static_cast<unsigned>((n + kSegment - 1) / kSegment), kThreads,
         bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const long long*>(keys), n,
          static_cast<long long*>(keys_out),
          static_cast<long long*>(weights_out),
          static_cast<int32_t*>(counts), static_cast<int32_t*>(passed));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Sorts each of n_segments 8,192-row segments of keys ascending into
// keys_out; payload (int32, may be null) follows into payload_out.
extern "C" int kdf_seg_sort(const void* keys, const void* payload,
                            void* keys_out, void* payload_out,
                            long long n_segments, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const long long*>(keys);
  auto* ko = static_cast<long long*>(keys_out);
  const auto blocks = static_cast<unsigned>(n_segments);
  cudaError_t err;
  if (payload != nullptr) {
    constexpr size_t bytes = sort_smem_bytes(true);
    err = kdf::opt_in_smem(seg_sort_kernel<true>, bytes,
                           sort_payload_opted_in);
    if (err != cudaSuccess) return static_cast<int>(err);
    seg_sort_kernel<true><<<blocks, kThreads, bytes, s>>>(
        k, static_cast<const int32_t*>(payload), ko,
        static_cast<int32_t*>(payload_out));
  } else {
    constexpr size_t bytes = sort_smem_bytes(false);
    err = kdf::opt_in_smem(seg_sort_kernel<false>, bytes, sort_opted_in);
    if (err != cudaSuccess) return static_cast<int>(err);
    seg_sort_kernel<false><<<blocks, kThreads, bytes, s>>>(k, nullptr, ko,
                                                           nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// K9d over keys[0, n): for each of the ceil(n / 8,192) segments (rows
// past n count as sentinel keys), ordered (ordered != 0), its distinct
// live keys ascending with their int64 multiplicities at the front of
// the segment's slot of keys_out / weights_out, and their number to
// counts[segment] (int32).  Unordered, counts[segment] live keys whose
// weights sum, key by key, to the key's multiplicity, in no set order
// and not always merged, and passed[segment] (int32) 1 where the segment
// was passed through (every live key, of weight 1), else 0; the ordered
// form leaves passed (which may be null) alone.
extern "C" int kdf_seg_dedup(const void* keys, long long n, int ordered,
                             void* keys_out, void* weights_out, void* counts,
                             void* passed, void* stream) {
  return ordered ? launch_dedup<true>(keys, n, keys_out, weights_out, counts,
                                      passed, stream)
                 : launch_dedup<false>(keys, n, keys_out, weights_out, counts,
                                       passed, stream);
}
