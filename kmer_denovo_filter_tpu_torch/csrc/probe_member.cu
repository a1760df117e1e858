// Kernel K4: membership of window keys in a sorted table.
//
// Replaces the Pallas TPU member joins of
// kmer_denovo_filter_tpu/ops/pallas_join.py: _join_kernel (:223, one
// batch, via join_member_step :478 and join_member_step_dedup :1193) and
// _member_kernel_sb (:1277, a super-batch of NB batches in one join, via
// join_member_superbatch_dedup :1386).  The TPU route-sorts the windows
// by hash partition, joins them against DMA'd partition windows, and
// unsorts the found bits with a second sort; here each window searches
// the sorted table in place (sorted_table.cuh) and writes its own bit, so
// nothing is sorted or unsorted.  A super-batch is one launch over the
// stacked batches (engine.scan_reads_for_hits_many).
//
// In:  keys (N,) int64 (INT64_MAX = invalid window, never found); table
//      (M,) int64 sorted ascending (unique apart from trailing INT64_MAX
//      rows).
// Out: found (N,) bool as one byte per key, and/or rows (N,) int64, the
//      key's table row or -1 (KmerIndex.counts_of gathers counts there);
//      either may be null.  Written coalesced; no atomics, the kernel
//      only reads the table.
//
// Bound: by bytes, 9 bytes a window (8 read, 1 written) plus 8 bytes for
// each table row hit — 37-50 MB, ~11-15 us, for 32,768 x 152 bp at
// 3.35 TB/s; as for K2 the ~log2(M) dependent loads of each search set
// the time, not the stream.

#include <cstdint>

#include <cuda_runtime.h>

#include "sorted_table.cuh"

namespace {

// Writes found[i] (when found is set) and rows[i], the table row or -1
// (when rows is set).
template <bool kStaged>
__global__ void probe_member_kernel(const long long* __restrict__ keys,
                                    long long n,
                                    const long long* __restrict__ table,
                                    int m, uint8_t* __restrict__ found,
                                    long long* __restrict__ rows) {
  extern __shared__ long long staged[];
  const long long* t = kdf::stage_table<kStaged>(table, m, staged);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int row = kdf::find_row(t, m, keys[i]);
    if (found != nullptr) found[i] = row >= 0 ? 1 : 0;
    if (rows != nullptr) rows[i] = row;
  }
}

}  // namespace

extern "C" int kdf_probe_member(const void* keys, long long n,
                                const void* table, int m, void* found,
                                void* rows, void* stream) {
  kdf::ProbeLaunch launch;
  const cudaError_t err = kdf::probe_launch(n, m, &launch);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* k = static_cast<const long long*>(keys);
  const auto* t = static_cast<const long long*>(table);
  auto* f = static_cast<uint8_t*>(found);
  auto* r = static_cast<long long*>(rows);
  const auto s = static_cast<cudaStream_t>(stream);
  if (launch.staged) {
    probe_member_kernel<true>
        <<<launch.blocks, launch.threads, launch.smem, s>>>(k, n, t, m, f, r);
  } else {
    probe_member_kernel<false><<<launch.blocks, launch.threads, 0, s>>>(
        k, n, t, m, f, r);
  }
  return static_cast<int>(cudaGetLastError());
}
