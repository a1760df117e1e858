// Kernels K9 and K9d: a sort local to each 8,192-row segment of a flat
// int64 window-key stream, and a dedup local to each segment.
//
// K9 (kdf_seg_sort) replaces the Pallas TPU kernel
// scripts/x_fused.py:_sort_kernel (:133, via seg_sort_pallas :144): an
// in-VMEM bitonic sort of each 8,192-row segment by key with one payload
// riding along.  Here the key is the port's int64 k-mer key (INT64_MAX =
// invalid window, sorting last under the signed compare) and the payload
// an optional int32.  The TPU kernel emits its segment in a lane-major
// order (row * 128 + lane mapped to lane * 64 + row); this one writes it
// in plain ascending order.  One block of 1,024 threads sorts a segment
// in 96 KB of dynamic shared memory by the TPU kernel's network: 13 merge
// sizes, 91 compare-exchange stages, each behind a __syncthreads(), each
// thread taking 4 of a stage's 4,096 pairs (2 shared loads and up to 2
// stores of 12 B a pair).  Compares are strict, so a payload is never
// duplicated or dropped; the order within equal keys is unspecified, as
// on the TPU.  ~0.44 ms on a 32,768 x 152 bp batch on an H100 SXM, 15x
// its bound (PERF.md).
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
// K9d's design.  K9's network spends its time in 91 block barriers and
// the shared-memory traffic of every stage (K9d took ~0.30 ms on a 40x
// batch, 25x its bound, PERF.md).  Here one block of 512 threads takes a
// segment, each thread holding 16 keys in registers, and sorts them by
// the same bitonic network laid out for this card (block_sort):
// element i = 16 t + r is register r of thread t, so the strides 1..8
// are compare-exchanges between a thread's own registers, the strides
// 16..256 warp shuffles (lane xor 1..16), and only the strides 512..4096
// cross warps.  Those go through shared memory once per merge of 1,024
// rows or more: stored in the natural layout, loaded in a transposed one
// (i = t + 512 r) in which they too are register strides, stored back and
// reloaded: 8 barriers for the whole sort.  Addresses are XOR-swizzled
// (i ^ (i >> 4 & 15)) so both layouts' 8-byte accesses are free of bank
// conflicts.  Rows leave through shared memory in coalesced stores.
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

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kSegment = 8192;
constexpr int kThreads = 1024;
constexpr size_t kSmemBytes =
    static_cast<size_t>(kSegment) * (sizeof(long long) + sizeof(int32_t));

// Bitonic sort of key[0, kSegment) ascending, pay[] following when
// kPayload.  Ends with a __syncthreads().
template <bool kPayload>
__device__ __forceinline__ void bitonic_sort(long long* key, int32_t* pay) {
  for (int size = 2; size <= kSegment; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < kSegment / 2; t += kThreads) {
        // the pair (lo, lo + stride): bit `stride` of lo is clear
        const int lo = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const long long a = key[lo];
        const long long b = key[hi];
        if (ascending ? a > b : a < b) {
          key[lo] = b;
          key[hi] = a;
          if (kPayload) {
            const int32_t p = pay[lo];
            pay[lo] = pay[hi];
            pay[hi] = p;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Loads segment blockIdx.x of keys (and payload) into shared memory.
template <bool kPayload>
__device__ __forceinline__ void load_segment(const long long* __restrict__ keys,
                                             const int32_t* __restrict__ payload,
                                             long long* key, int32_t* pay) {
  const long long base = static_cast<long long>(blockIdx.x) * kSegment;
  for (int i = threadIdx.x; i < kSegment; i += kThreads) {
    key[i] = keys[base + i];
    if (kPayload) pay[i] = payload[base + i];
  }
  __syncthreads();
}

template <bool kPayload>
__global__ void __launch_bounds__(kThreads, 2)
    seg_sort_kernel(const long long* __restrict__ keys,
                    const int32_t* __restrict__ payload,
                    long long* __restrict__ keys_out,
                    int32_t* __restrict__ payload_out) {
  extern __shared__ long long smem[];
  long long* key = smem;
  int32_t* pay = reinterpret_cast<int32_t*>(smem + kSegment);
  load_segment<kPayload>(keys, payload, key, pay);
  bitonic_sort<kPayload>(key, pay);
  const long long base = static_cast<long long>(blockIdx.x) * kSegment;
  for (int i = threadIdx.x; i < kSegment; i += kThreads) {
    keys_out[base + i] = key[i];
    if (kPayload) payload_out[base + i] = pay[i];
  }
}

// ── K9d ─────────────────────────────────────────────────────────────

constexpr int kDedupThreads = 512;
constexpr int kRegs = kSegment / kDedupThreads;  // 16 keys a thread
constexpr int kLogSegment = 13;
constexpr int kDedupWarps = kDedupThreads / 32;
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

// Inclusive sum of v over the warp.
__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const int other = __shfl_up_sync(0xFFFFFFFFu, v, off);
    if (lane >= off) v += other;
  }
  return v;
}

// Exclusive sum of v over the block of kDedupThreads, and the block's
// total in *total.  Uses sums[kDedupWarps]; all threads must call it.
__device__ __forceinline__ int block_exclusive_sum(int v, int* sums,
                                                   int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int inclusive = warp_inclusive_sum(v);
  if (lane == 31) sums[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    const int s = warp_inclusive_sum(lane < kDedupWarps ? sums[lane] : 0);
    if (lane < kDedupWarps) sums[lane] = s;
  }
  __syncthreads();
  *total = sums[kDedupWarps - 1];
  return inclusive - v + (warp > 0 ? sums[warp - 1] : 0);
}

// Shared-memory slot of element i: the XOR swizzle that keeps both the
// natural (i = 16 t + r) and the transposed (i = t + 512 r) layout's
// 8-byte accesses free of bank conflicts.
__device__ __forceinline__ int swizzle(int i) { return i ^ ((i >> 4) & 15); }

// The pair (a, b), a at the lower position: ascending leaves the smaller
// in a.  One 64-bit compare, a predicate XOR and the selects of a swap.
__device__ __forceinline__ void compare_exchange(long long& a, long long& b,
                                                 bool ascending) {
  const bool swap = (b < a) == ascending;
  const long long lo = swap ? b : a;
  b = swap ? a : b;
  a = lo;
}

// Sorts p = 2^log_p keys (9 <= log_p <= 13) ascending by the bitonic
// network: key[r] of thread t < p / kRegs is element 16 t + r.  Merge
// size 2^j, stride 2^b, ascending where bit j of the lower element is
// clear.  Strides 1..8 (b <= 3) pair a thread's registers, 16..256 the
// same register of lanes t ^ 2^(b - 4); strides 512..4096 pair registers
// of the transposed layout, element t + 512 r in key[r] of every thread
// (p / 512 of them), through `buf` (p x 8 B of shared memory).  Threads
// past p / kRegs hold nothing in the natural layout and only meet the
// barriers; the natural holders are whole warps (p >= 512).  All threads
// must call it; it ends with the keys in key[] in the natural layout and
// no barrier after the last reload.  (One instance: an instance for each
// size spilled and ran slower.)
__device__ __forceinline__ void block_sort(long long (&key)[kRegs], int log_p,
                                           long long* buf) {
  const int t = threadIdx.x;
  const bool holds = t < (1 << log_p) / kRegs;
  const int n_tr = (1 << log_p) >> 9;  // transposed registers a thread
#pragma unroll 1
  for (int j = 1; j <= log_p; ++j) {
    if (j > 9) {
      if (holds) {
#pragma unroll
        for (int r = 0; r < kRegs; ++r) buf[swizzle(t * kRegs + r)] = key[r];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        if (r < n_tr) key[r] = buf[swizzle(t + (r << 9))];
      }
#pragma unroll
      for (int b = kLogSegment - 1; b >= 9; --b) {
        if (b >= j) continue;
        const int rb = 1 << (b - 9);
#pragma unroll
        for (int r = 0; r < kRegs; ++r) {
          if ((r & rb) == 0 && r < n_tr) {
            compare_exchange(key[r], key[r | rb], ((r >> (j - 9)) & 1) == 0);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        if (r < n_tr) buf[swizzle(t + (r << 9))] = key[r];
      }
      __syncthreads();
      if (holds) {
#pragma unroll
        for (int r = 0; r < kRegs; ++r) key[r] = buf[swizzle(t * kRegs + r)];
      }
    }
    if (!holds) continue;
#pragma unroll
    for (int b = 8; b >= 4; --b) {
      if (b >= j) continue;
      const int lanes = 1 << (b - 4);
      const bool keep_min = (((t >> (j - 4)) & 1) == 0) == ((t & lanes) == 0);
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        const long long o = __shfl_xor_sync(0xFFFFFFFFu, key[r], lanes);
        if ((o < key[r]) == keep_min) key[r] = o;
      }
    }
#pragma unroll
    for (int b = 3; b >= 0; --b) {
      if (b >= j) continue;
      const int rb = 1 << b;
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        if ((r & rb) == 0) {
          compare_exchange(key[r], key[r | rb],
                           (((t * kRegs + r) >> j) & 1) == 0);
        }
      }
    }
  }
}

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
  for (int q = t; q < n_runs; q += kDedupThreads) {
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
// among the first kDedupThreads rows (~4 consecutive reads) are distinct
// (random keys: a sort of all rows is the way, and the rest of the hash
// would be wasted; the reads of a sorted 40x BAM repeat ~1/2 of them).  Threads stop inserting at their next key after
// the flag is raised, so at most kHashLimit + kDedupThreads of the
// kHashSlots slots are ever claimed and every probe sequence ends.
__device__ __forceinline__ int hash_count_segment(
    const long long* __restrict__ keys, long long n, long long base,
    unsigned long long* hkey, int* hcount, int* n_distinct, int* n_live,
    int* overflow) {
  const int t = threadIdx.x;
  for (int s = t; s < kHashSlots; s += kDedupThreads) {
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
    const long long i = base + t + r * kDedupThreads;
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

// K9d over segment blockIdx.x of keys[0, n) (rows past n are sentinel):
// the hash first, then one block_sort, of the compacted distinct keys
// (weights from the hash) or of all rows (weights the run lengths).
__global__ void __launch_bounds__(kDedupThreads, 2)
    seg_dedup_kernel(const long long* __restrict__ keys, long long n,
                     long long* __restrict__ keys_out,
                     long long* __restrict__ weights_out,
                     int32_t* __restrict__ counts) {
  extern __shared__ long long smem[];
  __shared__ int sums[kDedupWarps];
  __shared__ long long warp_last[kDedupWarps];
  __shared__ int n_distinct;
  __shared__ int n_live;
  __shared__ int overflow;
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kSegment;
  auto* const hkey = reinterpret_cast<unsigned long long*>(smem);
  auto* const hcount = reinterpret_cast<int*>(smem + kHashSlots);
  // -1: sort all rows
  const int distinct = hash_count_segment(keys, n, base, hkey, hcount,
                                          &n_distinct, &n_live, &overflow);
  long long key[kRegs];
  int log_p = kLogSegment;
  long long* buf = smem;
  if (distinct < 0) {
    // a sorting network sorts any arrangement: thread t takes rows
    // t + 512 r (coalesced) as its elements 16 t + r
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const long long i = base + t + r * kDedupThreads;
      key[r] = i < n ? __ldg(keys + i) : kSentinel;
    }
  } else {
    // the occupied slots, 8 a thread, compacted into buf by a scan
    constexpr int kPer = kHashSlots / kDedupThreads;
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
  block_sort(key, log_p, buf);
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
  for (int i = t; i < distinct; i += kDedupThreads) {
    const long long k = buf[swizzle(i)];
    keys_out[base + i] = k;
    weights_out[base + i] = hash_count(hkey, hcount, k);
  }
  if (t == 0) counts[blockIdx.x] = distinct;
}

// Opts *kernel* in to *bytes* of dynamic shared memory on the current
// device, once: *done* holds a bit for each device (0..63) already set, so
// later launches skip the runtime call.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes,
                        std::atomic<uint64_t>& done) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

std::atomic<uint64_t> sort_opted_in{0};
std::atomic<uint64_t> sort_payload_opted_in{0};
std::atomic<uint64_t> dedup_opted_in{0};

}  // namespace

// Sorts each of n_segments 8,192-row segments of keys ascending into
// keys_out; payload (int32, may be null) follows into payload_out.
extern "C" int kdf_seg_sort(const void* keys, const void* payload,
                            void* keys_out, void* payload_out,
                            long long n_segments, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const long long*>(keys);
  auto* ko = static_cast<long long*>(keys_out);
  cudaError_t err;
  if (payload != nullptr) {
    err = opt_in_smem(seg_sort_kernel<true>, kSmemBytes, sort_payload_opted_in);
    if (err != cudaSuccess) return static_cast<int>(err);
    seg_sort_kernel<true><<<static_cast<unsigned>(n_segments), kThreads,
                            kSmemBytes, s>>>(
        k, static_cast<const int32_t*>(payload), ko,
        static_cast<int32_t*>(payload_out));
  } else {
    err = opt_in_smem(seg_sort_kernel<false>, kSmemBytes, sort_opted_in);
    if (err != cudaSuccess) return static_cast<int>(err);
    seg_sort_kernel<false><<<static_cast<unsigned>(n_segments), kThreads,
                             kSmemBytes, s>>>(k, nullptr, ko, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// K9d over keys[0, n): for each of the ceil(n / 8,192) segments (rows
// past n count as sentinel keys) its distinct live keys ascending with
// their int64 multiplicities at the front of the segment's slot of
// keys_out / weights_out, and their number to counts[segment] (int32).
extern "C" int kdf_seg_dedup(const void* keys, long long n, void* keys_out,
                             void* weights_out, void* counts, void* stream) {
  const cudaError_t err =
      opt_in_smem(seg_dedup_kernel, kDedupSmemBytes, dedup_opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_dedup_kernel<<<static_cast<unsigned>((n + kSegment - 1) / kSegment),
                     kDedupThreads, kDedupSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n,
      static_cast<long long*>(keys_out), static_cast<long long*>(weights_out),
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
