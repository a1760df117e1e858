// Kernels K2 and K3: filtered tallies of window keys against a sorted
// table.
//
// K2 (kdf_probe_tally) replaces the Pallas TPU kernel
// kmer_denovo_filter_tpu/ops/pallas_probe.py:_sweep_tally_kernel (:99),
// the XLA sweep it blueprints, pallas_join.small_weighted_tally (:1016),
// and the unweighted tile join pallas_join.py:_tally_kernel (:273): each
// counts, per table key, the windows equal to it.  The TPU compares every
// window with every table key (O(N * M)) or route-sorts the windows into
// hash partitions; here each live key does a lower-bound binary search,
// O(N log M) (sorted_table.cuh).
//
// K3 (kdf_probe_tally_weighted) replaces the weighted tile join
// pallas_join.py:_tally_kernel_w (:679), the back half of the dedup-first
// tally (join_tally_step_dedup :808, join_tally_superbatch_dedup :915):
// its input is a batch's distinct keys with their multiplicities, and a
// found key adds its weight instead of 1.
//
// In:  keys (N,) int64 (INT64_MAX = invalid window, skipped); weights
//      (N,) int64 (K3 only); table (M,) int64 sorted ascending (unique
//      apart from trailing INT64_MAX rows); acc (M,) int64, incremented
//      in place with atomicAdd on the unsigned 64-bit view (two's
//      complement: the same add).
//
// Bound: by bytes, the key stream (8 bytes a window for K2, 16 bytes a
// distinct key for K3) plus 24 bytes for each table row hit (the key read,
// the count read and written) is ~10-40 us per 32,768 x 152 bp batch at
// 3.35 TB/s; the search is ~log2(M) dependent shared or L2 loads per key, and it,
// not the stream, sets the time (~0.09 ms at M = 4,096 and ~0.2 ms at
// M = 262,144 for K2 on an H100 SXM at 700 W).  K2's further bound on
// real data is atomic contention: coverage repeats a k-mer in ~40 reads
// of a batch, and those adds serialise on one address.  K3 does one
// search and at most one atomic per distinct key, so it trades that
// contention for the sort of the batch in front of it.

#include <cuda_runtime.h>

#include "sorted_table.cuh"

namespace {

template <bool kStaged, bool kWeighted>
__global__ void probe_tally_kernel(const long long* __restrict__ keys,
                                   const long long* __restrict__ weights,
                                   long long n,
                                   const long long* __restrict__ table, int m,
                                   unsigned long long* __restrict__ acc) {
  extern __shared__ long long staged[];
  const long long* t = kdf::stage_table<kStaged>(table, m, staged);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int row = kdf::find_row(t, m, keys[i]);
    if (row < 0) continue;
    const unsigned long long add =
        kWeighted ? static_cast<unsigned long long>(weights[i]) : 1ull;
    atomicAdd(acc + row, add);
  }
}

template <bool kWeighted>
int launch_tally(const void* keys, const void* weights, long long n,
                 const void* table, int m, void* acc, void* stream) {
  kdf::ProbeLaunch launch;
  const cudaError_t err = kdf::probe_launch(n, m, &launch);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* k = static_cast<const long long*>(keys);
  const auto* w = static_cast<const long long*>(weights);
  const auto* t = static_cast<const long long*>(table);
  auto* a = static_cast<unsigned long long*>(acc);
  const auto s = static_cast<cudaStream_t>(stream);
  if (launch.staged) {
    probe_tally_kernel<true, kWeighted>
        <<<launch.blocks, launch.threads, launch.smem, s>>>(k, w, n, t, m, a);
  } else {
    probe_tally_kernel<false, kWeighted>
        <<<launch.blocks, launch.threads, 0, s>>>(k, w, n, t, m, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int kdf_probe_tally(const void* keys, long long n,
                               const void* table, int m, void* acc,
                               void* stream) {
  return launch_tally<false>(keys, nullptr, n, table, m, acc, stream);
}

extern "C" int kdf_probe_tally_weighted(const void* keys, const void* weights,
                                        long long n, const void* table, int m,
                                        void* acc, void* stream) {
  return launch_tally<true>(keys, weights, n, table, m, acc, stream);
}
