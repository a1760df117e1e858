// The sorted-table probe shared by kernels K2, K3 and K4: an equality
// join of a stream of int64 query keys against a fixed sorted int64 key
// set, by lower-bound binary search.
//
// All three replace TPU tile joins (kmer_denovo_filter_tpu/ops/
// pallas_join.py and pallas_probe.py) that hash-partition the table into
// (P, 1024) lane tiles, route-sort the queries and compare them against
// DMA'd windows of partitions, with overflow flags when a chunk's span
// misses the window.  On Hopper none of that is needed: each query does
// ~log2(M) dependent loads into a table that sits in shared memory (M * 8
// <= 48 KB, staged once per block) or in device memory, where tables up
// to the 50 MB L2 stay cache-resident.  No capacity can overflow.
//
// Keys are right-aligned 2-bit k-mer values (< 2^62); INT64_MAX marks an
// invalid window and is never found.  Tables are ascending and unique
// apart from trailing INT64_MAX rows.

#pragma once

#include <cuda_runtime.h>

namespace kdf {

constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kSmemTableBytes = 48 * 1024;
constexpr int kStagedThreads = 1024;
constexpr int kStagedBlocksPerSm = 2;
constexpr int kGlobalThreads = 256;
constexpr int kGlobalBlocksPerSm = 8;

// First row of t[0, m) not less than q (m when every row is less).
__device__ __forceinline__ int lower_bound(const long long* t, int m,
                                           long long q) {
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
  return lo;
}

// Row of live key q in t[0, m), or -1.
__device__ __forceinline__ int find_row(const long long* t, int m,
                                        long long q) {
  if (q == kSentinel) return -1;
  const int lo = lower_bound(t, m, q);
  return lo < m && t[lo] == q ? lo : -1;
}

// Copies the table into the block's dynamic shared memory when kStaged;
// returns the pointer the block searches.
template <bool kStaged>
__device__ __forceinline__ const long long* stage_table(
    const long long* __restrict__ table, int m, long long* staged) {
  if (!kStaged) return table;
  for (int j = threadIdx.x; j < m; j += blockDim.x) staged[j] = table[j];
  __syncthreads();
  return staged;
}

// Launch shape of a grid-stride probe over n queries: staged blocks of
// 1,024 threads (2 per SM, so the staging is paid ~2 times per SM) or
// global-memory blocks of 256 (8 per SM).
struct ProbeLaunch {
  bool staged;
  unsigned blocks;
  int threads;
  size_t smem;
};

inline cudaError_t probe_launch(long long n, int m, ProbeLaunch* out) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long table_bytes = static_cast<long long>(m) * 8;
  out->staged = table_bytes <= kSmemTableBytes;
  out->threads = out->staged ? kStagedThreads : kGlobalThreads;
  out->smem = out->staged ? static_cast<size_t>(table_bytes) : 0;
  const long long need = (n + out->threads - 1) / out->threads;
  const long long cap = static_cast<long long>(sms) *
                        (out->staged ? kStagedBlocksPerSm : kGlobalBlocksPerSm);
  out->blocks = static_cast<unsigned>(need < cap ? need : cap);
  return cudaSuccess;
}

}  // namespace kdf
