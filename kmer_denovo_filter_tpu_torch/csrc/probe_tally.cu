// Kernel K2: filtered tally of window keys against a small sorted table.
//
// Replaces the Pallas TPU kernel
// kmer_denovo_filter_tpu/ops/pallas_probe.py:_sweep_tally_kernel (:99) and
// the XLA sweep it blueprints, pallas_join.small_weighted_tally (:1016).
// Both compute per-table-key counts of equal windows, with sentinel rows
// counting 0.  The TPU compares every window with every table key,
// O(N * M); here each live key does a lower-bound binary search,
// O(N log M), so the TPU's dedup front half (pallas_join._dedup_compact)
// has no compare volume to cut and is left out.
//
// In:  keys (N,) int64 (INT64_MAX = invalid window, skipped); table (M,)
//      int64 sorted ascending (unique apart from trailing INT64_MAX rows);
//      acc (M,) int64, incremented in place with atomicAdd on the
//      unsigned 64-bit view (two's complement: +1 is the same add).
//
// Design: a table of M * 8 <= 48 KB is staged in shared memory once per
// block and the blocks walk the keys grid-stride, so the staging cost is
// paid ~2 times per SM; larger tables are searched in global memory,
// where tables up to the 50 MB L2 stay cache-resident.
//
// Bound: the key stream is 8 bytes per window from device memory (32 MB
// per 32,768 x 152 bp batch, ~10 us at 3.35 TB/s); the search is
// ~log2(M) dependent shared or L2 loads per key, and it, not the stream,
// sets the time (~0.09 ms at M = 4,096 and ~0.2 ms at M = 262,144 on an
// H100 SXM at 700 W).  The likely further bound on real data is atomic
// contention: coverage repeats the same k-mer in ~40 reads of a batch,
// and those adds serialise on one address.

#include <cuda_runtime.h>

namespace {

constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kSmemTableBytes = 48 * 1024;
constexpr int kStagedThreads = 1024;
constexpr int kStagedBlocksPerSm = 2;
constexpr int kGlobalThreads = 256;
constexpr int kGlobalBlocksPerSm = 8;

template <bool kStaged>
__global__ void probe_tally_kernel(const long long* __restrict__ keys,
                                   long long n,
                                   const long long* __restrict__ table, int m,
                                   unsigned long long* __restrict__ acc) {
  extern __shared__ long long staged[];
  const long long* t = table;
  if (kStaged) {
    for (int j = threadIdx.x; j < m; j += blockDim.x) staged[j] = table[j];
    __syncthreads();
    t = staged;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long q = keys[i];
    if (q == kSentinel) continue;
    int lo = 0;
    int hi = m;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (t[mid] < q) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < m && t[lo] == q) atomicAdd(acc + lo, 1ull);
  }
}

}  // namespace

extern "C" int kdf_probe_tally(const void* keys, long long n,
                               const void* table, int m, void* acc,
                               void* stream) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* k = static_cast<const long long*>(keys);
  const auto* t = static_cast<const long long*>(table);
  auto* a = static_cast<unsigned long long*>(acc);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long table_bytes = static_cast<long long>(m) * 8;
  if (table_bytes <= kSmemTableBytes) {
    const long long need = (n + kStagedThreads - 1) / kStagedThreads;
    const long long cap = static_cast<long long>(sms) * kStagedBlocksPerSm;
    const unsigned blocks = static_cast<unsigned>(need < cap ? need : cap);
    probe_tally_kernel<true><<<blocks, kStagedThreads,
                               static_cast<size_t>(table_bytes), s>>>(
        k, n, t, m, a);
  } else {
    const long long need = (n + kGlobalThreads - 1) / kGlobalThreads;
    const long long cap = static_cast<long long>(sms) * kGlobalBlocksPerSm;
    const unsigned blocks = static_cast<unsigned>(need < cap ? need : cap);
    probe_tally_kernel<false><<<blocks, kGlobalThreads, 0, s>>>(k, n, t, m,
                                                               a);
  }
  return static_cast<int>(cudaGetLastError());
}
