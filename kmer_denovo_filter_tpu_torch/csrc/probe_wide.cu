// Kernels K7 and K8: filtered tally and membership of wide window keys
// (k = 33..207, rows of Q = 2..7 int64 limbs) against a sorted table.
//
// K7 (kdf_probe_tally_wide) replaces the Pallas TPU kernel
// kmer_denovo_filter_tpu/ops/pallas_join.py:_tally_kernel_wide (:1905),
// reached through join_tally_flat_wide (:2180, unweighted: the VCF-mode
// parent scan) and join_tally_flat_wide_dedup (:1564, weighted: the
// discovery parent filter over a batch's distinct keys and their
// multiplicities).  As there, one body serves both forms: a found key
// adds 1, or its weight.
//
// K8 (kdf_probe_member_wide) replaces pallas_join.py:_member_kernel_wide
// (:1997) via join_member_step_wide (:2216): the reference subtraction
// (Module 0), the anchoring scan (Module 3) and KmerIndex.counts_of.
//
// The TPU kernels join route-hashed, partition-sorted W-plane queries
// against VMEM windows of W-plane tiles and unsort the found bits with a
// second sort; here each key searches the sorted table in place
// (sorted_rows.cuh) and writes its own result, so nothing is routed,
// sorted or unsorted.
//
// In:  keys (N, Q) int64 (a row with limb 0 = INT64_MAX is an invalid
//      window: skipped, never found); weights (N,) int64 or null (K7);
//      table (M, Q) int64, rows ascending, unique apart from trailing
//      sentinel rows.
// Out: K7: acc (M,) int64, incremented in place with atomicAdd on the
//      unsigned 64-bit view.  K8: found (N,) one byte per key and/or rows
//      (N,) int64, the key's table row or -1; either may be null; no
//      atomics, the table is only read.
//
// Bound: by bytes, 8Q bytes a key (plus 8 a weight, or 1 of output for
// K8) and, per table row hit, 8Q read plus 16 of accumulator for K7: at
// Q = 3 a 4.0M-window batch moves ~100 MB, ~30 us at 3.35 TB/s.  As for
// K2-K4, the ~log2(M) dependent row loads of each search set the time;
// a row is Q times wider than K2's key, so a step costs up to Q loads of
// one cache line.  The key loads are partly coalesced (a warp's rows
// stride 8Q bytes).

#include <cstdint>

#include <cuda_runtime.h>

#include "sorted_rows.cuh"

namespace {

template <int Q, bool kStaged, bool kWeighted>
__global__ void probe_tally_wide_kernel(const long long* __restrict__ keys,
                                        const long long* __restrict__ weights,
                                        long long n,
                                        const long long* __restrict__ table,
                                        int m,
                                        unsigned long long* __restrict__ acc) {
  extern __shared__ long long staged[];
  const long long* t = kdf::stage_rows<Q, kStaged>(table, m, staged);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    long long q[Q];
    kdf::load_row<Q>(keys, i, q);
    const int row = kdf::find_row_wide<Q>(t, m, q);
    if (row < 0) continue;
    const unsigned long long add =
        kWeighted ? static_cast<unsigned long long>(weights[i]) : 1ull;
    atomicAdd(acc + row, add);
  }
}

template <int Q, bool kStaged>
__global__ void probe_member_wide_kernel(const long long* __restrict__ keys,
                                         long long n,
                                         const long long* __restrict__ table,
                                         int m, uint8_t* __restrict__ found,
                                         long long* __restrict__ rows) {
  extern __shared__ long long staged[];
  const long long* t = kdf::stage_rows<Q, kStaged>(table, m, staged);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    long long q[Q];
    kdf::load_row<Q>(keys, i, q);
    const int row = kdf::find_row_wide<Q>(t, m, q);
    if (found != nullptr) found[i] = row >= 0 ? 1 : 0;
    if (rows != nullptr) rows[i] = row;
  }
}

template <int Q, bool kWeighted>
int launch_tally(const long long* keys, const long long* weights, long long n,
                 const long long* table, int m, unsigned long long* acc,
                 cudaStream_t s) {
  kdf::ProbeLaunch launch;
  const cudaError_t err = kdf::probe_launch_rows(n, m, Q, &launch);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (launch.staged) {
    probe_tally_wide_kernel<Q, true, kWeighted>
        <<<launch.blocks, launch.threads, launch.smem, s>>>(keys, weights, n,
                                                            table, m, acc);
  } else {
    probe_tally_wide_kernel<Q, false, kWeighted>
        <<<launch.blocks, launch.threads, 0, s>>>(keys, weights, n, table, m,
                                                  acc);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int Q>
int launch_tally_q(const void* keys, const void* weights, long long n,
                   const void* table, int m, void* acc, cudaStream_t s) {
  const auto* k = static_cast<const long long*>(keys);
  const auto* w = static_cast<const long long*>(weights);
  const auto* t = static_cast<const long long*>(table);
  auto* a = static_cast<unsigned long long*>(acc);
  return w != nullptr ? launch_tally<Q, true>(k, w, n, t, m, a, s)
                      : launch_tally<Q, false>(k, w, n, t, m, a, s);
}

template <int Q>
int launch_member_q(const void* keys, long long n, const void* table, int m,
                    void* found, void* rows, cudaStream_t s) {
  kdf::ProbeLaunch launch;
  const cudaError_t err = kdf::probe_launch_rows(n, m, Q, &launch);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* k = static_cast<const long long*>(keys);
  const auto* t = static_cast<const long long*>(table);
  auto* f = static_cast<uint8_t*>(found);
  auto* r = static_cast<long long*>(rows);
  if (launch.staged) {
    probe_member_wide_kernel<Q, true>
        <<<launch.blocks, launch.threads, launch.smem, s>>>(k, n, t, m, f, r);
  } else {
    probe_member_wide_kernel<Q, false>
        <<<launch.blocks, launch.threads, 0, s>>>(k, n, t, m, f, r);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// weights null: unweighted.  Returns a CUDA error code, or
// cudaErrorInvalidValue for q outside 2..7.
extern "C" int kdf_probe_tally_wide(const void* keys, const void* weights,
                                    long long n, const void* table, int m,
                                    int q, void* acc, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 2: return launch_tally_q<2>(keys, weights, n, table, m, acc, s);
    case 3: return launch_tally_q<3>(keys, weights, n, table, m, acc, s);
    case 4: return launch_tally_q<4>(keys, weights, n, table, m, acc, s);
    case 5: return launch_tally_q<5>(keys, weights, n, table, m, acc, s);
    case 6: return launch_tally_q<6>(keys, weights, n, table, m, acc, s);
    case 7: return launch_tally_q<7>(keys, weights, n, table, m, acc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int kdf_probe_member_wide(const void* keys, long long n,
                                     const void* table, int m, int q,
                                     void* found, void* rows, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 2: return launch_member_q<2>(keys, n, table, m, found, rows, s);
    case 3: return launch_member_q<3>(keys, n, table, m, found, rows, s);
    case 4: return launch_member_q<4>(keys, n, table, m, found, rows, s);
    case 5: return launch_member_q<5>(keys, n, table, m, found, rows, s);
    case 6: return launch_member_q<6>(keys, n, table, m, found, rows, s);
    case 7: return launch_member_q<7>(keys, n, table, m, found, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
