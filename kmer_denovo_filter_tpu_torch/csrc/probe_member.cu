// Kernel K4: membership of window keys in a sorted table.
//
// Replaces the Pallas TPU member joins of
// kmer_denovo_filter_tpu/ops/pallas_join.py: _join_kernel (:223, one
// batch, via join_member_step :478 and join_member_step_dedup :1193) and
// _member_kernel_sb (:1277, a super-batch of NB batches in one join, via
// join_member_superbatch_dedup :1386).  The TPU route-sorts the windows
// by hash partition, joins them against DMA'd partition windows, and
// unsorts the found bits with a second sort; here each window searches
// the sorted table in place and writes its own bit, so nothing is sorted
// or unsorted.  A super-batch is one launch over the stacked batches
// (engine.scan_reads_for_hits_many).
//
// In:  keys (N,) int64 (INT64_MAX = invalid window, never found); table
//      (M,) int64 sorted ascending (unique apart from trailing INT64_MAX
//      rows), its `live` rows before them and its prefix directory (bits,
//      shift; sorted_table.cuh, built by kdf_build_directory).
// Out: found (N,) bool as one byte per key, and/or rows (N,) int64, the
//      key's table row or -1 (KmerIndex.counts_of gathers counts there);
//      either may be null.  No atomics, the kernel only reads the table.
//
// Bound: by bytes, 9 bytes a window (8 read, 1 written) plus 8 bytes for
// each table row hit, ~11-18 us for 32,768 x 152 bp at 3.35 TB/s.  What
// held the whole-table search at 7-28x that bound was its ~log2(M)
// dependent loads a key; through the directory a key takes one directory
// round trip and bitlen(bucket rows) table round trips (2-4), and a
// thread runs four keys' searches interleaved (sorted_table.cuh).  Each
// thread reads its four consecutive keys with two 16-byte loads and
// writes their found bytes as one 4-byte store (rows: two 16-byte
// stores).  Staged (live <= 10,367 on an H100): the block stages the
// live rows and a uint16 copy of the directory in up to 115,712 bytes of
// opted-in dynamic shared memory, two blocks an SM.
//
// No Pallas kernel has the directory: the reference's XLA fallback
// lookup_bucketed (kmer_denovo_filter_tpu/ops/device.py:587) has the
// same prefix offsets on the TPU.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "sorted_table.cuh"

namespace {

using kdf::kKeys;

// Writes the found bytes (when found is set) and rows (when rows is set)
// of keys [kKeys g, kKeys g + kKeys) of n: one 4-byte store and two
// 16-byte stores for a whole group when `vec`.
__device__ __forceinline__ void store_group(long long n, long long g,
                                            bool vec, const int (&row)[kKeys],
                                            uint8_t* __restrict__ found,
                                            long long* __restrict__ rows) {
  const long long i = g * kKeys;
  if (vec && i + kKeys <= n) {
    if (found != nullptr) {
      *reinterpret_cast<uchar4*>(found + i) =
          make_uchar4(row[0] >= 0, row[1] >= 0, row[2] >= 0, row[3] >= 0);
    }
    if (rows != nullptr) {
      auto* r = reinterpret_cast<longlong2*>(rows + i);
      r[0] = make_longlong2(row[0], row[1]);
      r[1] = make_longlong2(row[2], row[3]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    if (i + j < n) {
      if (found != nullptr) found[i + j] = row[j] >= 0 ? 1 : 0;
      if (rows != nullptr) rows[i + j] = row[j];
    }
  }
}

template <bool kGlobal, typename Dir>
__device__ __forceinline__ void member_groups(
    const long long* __restrict__ keys, long long n, bool vec,
    const long long* t, const Dir* dir, int bits, int shift,
    uint8_t* __restrict__ found, long long* __restrict__ rows) {
  const long long groups = (n + kKeys - 1) / kKeys;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    long long q[kKeys];
    int row[kKeys];
    kdf::load_keys(keys, n, g, vec, q);
    kdf::find_rows_dir<kGlobal>(t, dir, shift, bits, q, row);
    store_group(n, g, vec, row, found, rows);
  }
}

// Staged form: the live rows and a uint16 directory in shared memory.
__global__ void __launch_bounds__(kdf::kDirStagedThreads, 2)
    probe_member_staged(const long long* __restrict__ keys, long long n,
                        bool vec, const long long* __restrict__ table,
                        int live, const int* __restrict__ dir, int bits,
                        int shift, uint8_t* __restrict__ found,
                        long long* __restrict__ rows) {
  extern __shared__ long long staged[];
  auto* d = reinterpret_cast<unsigned short*>(staged + live);
  kdf::stage_directory(table, live, dir, bits, staged, d);
  member_groups<false>(keys, n, vec, staged, d, bits, shift, found, rows);
}

// Global form: the table and the directory through the read-only path.
// kThreads is 256 (the plan) or 512 (a launch override of 512 threads).
template <int kThreads>
__global__ void __launch_bounds__(kThreads, kdf::global_min_blocks(kThreads))
    probe_member_global(const long long* __restrict__ keys, long long n,
                        bool vec, const long long* __restrict__ table,
                        const int* __restrict__ dir, int bits, int shift,
                        uint8_t* __restrict__ found,
                        long long* __restrict__ rows) {
  member_groups<true>(keys, n, vec, table, dir, bits, shift, found, rows);
}

std::atomic<uint64_t> staged_opted_in{0};

}  // namespace

// K4 over n keys through the table's directory, in the launch plan of
// kdf::dir_probe_launch; form, threads and blocks_per_sm are a
// kdf::LaunchOverride (all 0: the plan).
extern "C" int kdf_probe_member(const void* keys, long long n,
                                const void* table, int live, const void* dir,
                                int bits, int shift, void* found, void* rows,
                                int form, int threads, int blocks_per_sm,
                                void* stream) {
  kdf::DirLaunch launch;
  cudaError_t err = kdf::dir_probe_launch(
      n, live, bits, false, {form, threads, blocks_per_sm}, &launch);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* k = static_cast<const long long*>(keys);
  const auto* t = static_cast<const long long*>(table);
  const auto* d = static_cast<const int*>(dir);
  auto* f = static_cast<uint8_t*>(found);
  auto* r = static_cast<long long*>(rows);
  const auto s = static_cast<cudaStream_t>(stream);
  // 16-byte key loads and whole-group stores need aligned streams
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(found) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  if (launch.staged) {
    err = kdf::opt_in_smem(probe_member_staged, launch.budget,
                           staged_opted_in);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_member_staged<<<launch.blocks, launch.threads, launch.smem, s>>>(
        k, n, vec, t, live, d, bits, shift, f, r);
  } else if (launch.threads <= kdf::kDirGlobalThreads) {
    probe_member_global<kdf::kDirGlobalThreads>
        <<<launch.blocks, launch.threads, 0, s>>>(k, n, vec, t, d, bits,
                                                  shift, f, r);
  } else {
    probe_member_global<2 * kdf::kDirGlobalThreads>
        <<<launch.blocks, launch.threads, 0, s>>>(k, n, vec, t, d, bits,
                                                  shift, f, r);
  }
  return static_cast<int>(cudaGetLastError());
}
