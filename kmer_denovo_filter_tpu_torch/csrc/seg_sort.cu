// Kernels K9 and K9d: a sort local to each 8,192-row segment of a flat
// int64 window-key stream, and the same sort followed by a run-length
// compaction of each segment.
//
// K9 (kdf_seg_sort) replaces the Pallas TPU kernel
// scripts/x_fused.py:_sort_kernel (:133, via seg_sort_pallas :144): an
// in-VMEM bitonic sort of each 8,192-row segment by key with one payload
// riding along.  Here the key is the port's int64 k-mer key (INT64_MAX =
// invalid window, sorting last under the signed compare) and the payload
// an optional int32.  The TPU kernel emits its segment in a lane-major
// order (row * 128 + lane mapped to lane * 64 + row); this one writes it
// in plain ascending order.
//
// K9d (kdf_seg_dedup) replaces the XLA front half of the dedup-first
// tally, kmer_denovo_filter_tpu/ops/pallas_join.py:_dedup_compact (:600,
// with _dedup_compact_sorted :625): K9's sort, then run starts, their
// ranks by a block-wide scan, and each segment's distinct live keys with
// their run lengths (int64 weights) written to the front of the segment's
// slot, plus the segment's distinct count.  Rows past the count are left
// unwritten.  Sentinel rows form no run: an all-sentinel segment yields a
// count of 0.  The TPU's 13-step log-shift compaction and its u_chunk
// capacity (with an overflow flag and a retry ladder) are workarounds for
// a slow TPU scatter; here each run start writes its own row, so the
// result is exact at any duplication.
//
// One block of 1,024 threads sorts one segment held in dynamic shared
// memory: 8,192 x 8 B of keys plus 8,192 x 4 B of payload (K9) or of run
// starts (K9d), 96 KB, which needs the opt-in above 48 KB
// (cudaFuncAttributeMaxDynamicSharedMemorySize, set once per kernel and
// device).  The sort is the bitonic network of the TPU kernel: 13 merge
// sizes, 91 compare-exchange stages, each thread taking 4 of a stage's
// 4,096 pairs.  Compares are strict, so equal keys never swap; every
// swap exchanges a pair, so a payload is never duplicated or dropped.
// The order within equal keys is unspecified, as on the TPU.  K9d's
// scan is a warp-shuffle scan of per-thread counts and then of the 32
// warp totals: deterministic.
//
// Bound: by bytes.  K9 reads and writes 12 B a row (8 B without a
// payload), 24 B a row in all: ~0.029 ms for the 3,997,696 windows of a
// 32,768 x 152 bp batch at 3.35 TB/s.  K9d reads 8 B a row and writes
// 16 B per distinct key and 4 B per segment.  The network's compares
// (45.5 per row) are far below the card's integer rate.  On an H100 SXM
// (700 W) K9 takes ~0.44 ms and K9d ~0.30 ms on such a batch, 15x and
// 25x their bounds; the likely limit is the 91 __syncthreads and the
// shared-memory traffic of every stage (2 loads and up to 2 stores of
// 12 B per pair), not measured apart.  Warp-shuffle stages for the short
// strides, or a radix sort in shared memory, would cut that.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kSegment = 8192;
constexpr int kThreads = 1024;
constexpr int kPerThread = kSegment / kThreads;  // 8 rows a thread
constexpr int kWarps = kThreads / 32;
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

// Inclusive sum of v over the warp.
__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const int other = __shfl_up_sync(0xFFFFFFFFu, v, off);
    if (lane >= off) v += other;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads, 2)
    seg_dedup_kernel(const long long* __restrict__ keys,
                     long long* __restrict__ keys_out,
                     long long* __restrict__ weights_out,
                     int32_t* __restrict__ counts) {
  extern __shared__ long long smem[];
  __shared__ int warp_sums[kWarps];
  long long* key = smem;
  int32_t* start = reinterpret_cast<int32_t*>(smem + kSegment);
  load_segment<false>(keys, nullptr, key, nullptr);
  bitonic_sort<false>(key, nullptr);

  // Each thread owns rows [first, first + 8): its run starts (a live key
  // differing from the row before) and its live rows.  Both counts are
  // at most 8,192, so one int carries them as runs | live << 16.
  const int first = threadIdx.x * kPerThread;
  unsigned starts = 0;
  int packed = 0;
  for (int j = 0; j < kPerThread; ++j) {
    const int i = first + j;
    const long long k = key[i];
    if (k == kSentinel) continue;
    packed += 1 << 16;
    if (i == 0 || key[i - 1] != k) {
      starts |= 1u << j;
      packed += 1;
    }
  }
  const int inclusive = warp_inclusive_sum(packed);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 31) warp_sums[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    warp_sums[threadIdx.x] = warp_inclusive_sum(warp_sums[threadIdx.x]);
  }
  __syncthreads();
  const int exclusive =
      inclusive - packed + (warp > 0 ? warp_sums[warp - 1] : 0);
  const int n_runs = warp_sums[kWarps - 1] & 0xFFFF;
  const int n_live = warp_sums[kWarps - 1] >> 16;

  // start[r] = the row where run r begins
  int rank = exclusive & 0xFFFF;
  for (int j = 0; j < kPerThread; ++j) {
    if (starts >> j & 1u) start[rank++] = first + j;
  }
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * kSegment;
  for (int r = threadIdx.x; r < n_runs; r += kThreads) {
    const int s = start[r];
    const int e = r + 1 < n_runs ? start[r + 1] : n_live;
    keys_out[base + r] = key[s];
    weights_out[base + r] = e - s;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = n_runs;
}

// Opts *kernel* in to kSmemBytes of dynamic shared memory on the current
// device, once: *done* holds a bit for each device (0..63) already set, so
// later launches skip the runtime call.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, std::atomic<uint64_t>& done) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
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
    err = opt_in_smem(seg_sort_kernel<true>, sort_payload_opted_in);
    if (err != cudaSuccess) return static_cast<int>(err);
    seg_sort_kernel<true><<<static_cast<unsigned>(n_segments), kThreads,
                            kSmemBytes, s>>>(
        k, static_cast<const int32_t*>(payload), ko,
        static_cast<int32_t*>(payload_out));
  } else {
    err = opt_in_smem(seg_sort_kernel<false>, sort_opted_in);
    if (err != cudaSuccess) return static_cast<int>(err);
    seg_sort_kernel<false><<<static_cast<unsigned>(n_segments), kThreads,
                             kSmemBytes, s>>>(k, nullptr, ko, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// Sorts each segment and writes its distinct live keys ascending with
// their int64 run lengths at the front of the segment's slot of
// keys_out / weights_out, and their number to counts[segment] (int32).
extern "C" int kdf_seg_dedup(const void* keys, void* keys_out,
                             void* weights_out, void* counts,
                             long long n_segments, void* stream) {
  const cudaError_t err = opt_in_smem(seg_dedup_kernel, dedup_opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_dedup_kernel<<<static_cast<unsigned>(n_segments), kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<long long*>(keys_out),
      static_cast<long long*>(weights_out), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
