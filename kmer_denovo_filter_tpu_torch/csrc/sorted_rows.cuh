// The sorted-table probe of kernels K7 and K8: an equality join of a
// stream of wide query keys against a fixed sorted set of wide keys, by
// lexicographic lower-bound binary search.  The wide counterpart of
// sorted_table.cuh (K2-K4), whose constants it shares.
//
// A wide key (k = 33..207) is a row of Q = ceil(k / 31) int64 limbs
// (ops/keys.py), compared limb by limb.  Tables and query streams are
// row-major (M, Q) / (N, Q), so one search step reads one contiguous
// 8Q-byte row.  Q is a template parameter (2..7): the query's limbs stay
// in registers and the compare loop unrolls.
//
// Both kernels replace TPU tile joins (kmer_denovo_filter_tpu/ops/
// pallas_join.py, kernels 7 and 8) that route-hash the W = 3..13 key
// words into (P, 1024) lane tiles, sort the queries by partition and
// compare them against DMA'd windows whose height is cut by a VMEM
// budget, with span-overflow flags and a replay ladder.  Here each query
// does ~log2(M) dependent row loads into a table that sits in shared
// memory (8·Q·M <= 48 KB, staged once per block) or in device memory.
// Nothing can overflow.
//
// A row whose limb 0 is INT64_MAX is the sentinel (an invalid window);
// it is never found.  Tables are ascending and unique apart from
// trailing sentinel rows.  Offsets row·Q are 64-bit: M·Q nears 2^31 at
// Q = 7, M = 2^28.

#pragma once

#include <cuda_runtime.h>

#include "sorted_table.cuh"

namespace kdf {

// Row r < query q, lexicographically.
template <int Q>
__device__ __forceinline__ bool row_less(const long long* r,
                                         const long long (&q)[Q]) {
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (r[j] != q[j]) return r[j] < q[j];
  }
  return false;
}

template <int Q>
__device__ __forceinline__ bool row_equal(const long long* r,
                                          const long long (&q)[Q]) {
  bool eq = true;
#pragma unroll
  for (int j = 0; j < Q; ++j) eq &= r[j] == q[j];
  return eq;
}

// First row of t[0, m) not less than q (m when every row is less).
template <int Q>
__device__ __forceinline__ int lower_bound_rows(const long long* t, int m,
                                                const long long (&q)[Q]) {
  int lo = 0;
  int hi = m;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (row_less<Q>(t + static_cast<long long>(mid) * Q, q)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Row of live key q in t[0, m), or -1.
template <int Q>
__device__ __forceinline__ int find_row_wide(const long long* t, int m,
                                             const long long (&q)[Q]) {
  if (q[0] == kSentinel) return -1;
  const int lo = lower_bound_rows<Q>(t, m, q);
  return lo < m && row_equal<Q>(t + static_cast<long long>(lo) * Q, q)
             ? lo
             : -1;
}

// Query row i of keys, into registers.
template <int Q>
__device__ __forceinline__ void load_row(const long long* __restrict__ keys,
                                         long long i, long long (&q)[Q]) {
  const long long* r = keys + i * Q;
#pragma unroll
  for (int j = 0; j < Q; ++j) q[j] = r[j];
}

// Copies the m-row table into the block's dynamic shared memory when
// kStaged; returns the pointer the block searches.
template <int Q, bool kStaged>
__device__ __forceinline__ const long long* stage_rows(
    const long long* __restrict__ table, int m, long long* staged) {
  if (!kStaged) return table;
  const long long n = static_cast<long long>(m) * Q;
  for (long long j = threadIdx.x; j < n; j += blockDim.x) staged[j] = table[j];
  __syncthreads();
  return staged;
}

// Launch shape of a grid-stride probe over n queries into an m-row table
// of Q limbs: as probe_launch (sorted_table.cuh), with 8·Q bytes a row.
inline cudaError_t probe_launch_rows(long long n, int m, int q,
                                     ProbeLaunch* out) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long table_bytes = static_cast<long long>(m) * q * 8;
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
