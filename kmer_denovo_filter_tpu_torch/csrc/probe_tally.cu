// Kernels K2 and K3: filtered tallies of window keys against a sorted
// table.
//
// K2 (kdf_probe_tally) replaces the Pallas TPU kernel
// kmer_denovo_filter_tpu/ops/pallas_probe.py:_sweep_tally_kernel (:99),
// the XLA sweep it blueprints, pallas_join.small_weighted_tally (:1016),
// and the unweighted tile join pallas_join.py:_tally_kernel (:273): each
// counts, per table key, the windows equal to it.  The TPU compares every
// window with every table key (O(N * M)) or route-sorts the windows into
// hash partitions; here each live key searches its bucket of the table's
// prefix directory (sorted_table.cuh), four keys a thread interleaved.
//
// K3 (kdf_probe_tally_weighted) replaces the weighted tile join
// pallas_join.py:_tally_kernel_w (:679), the back half of the dedup-first
// tally (join_tally_step_dedup :808, join_tally_superbatch_dedup :915):
// its input is a batch's distinct keys with their multiplicities, and a
// found key adds its weight instead of 1.  It searches through the same
// directory as K2, four keys a thread, in one form, global (the table
// and directory through the read-only path).  It takes its keys in two
// layouts: flat, (N,) keys and weights (the whole-batch dedup); or the
// slots of K9d (seg_sort.cu), (S, 8,192) keys and weights of which the
// first counts[s] of row s are live: a block takes a row at a time and
// its threads only the row's live groups of four, and rows past the count
// are never read, so K1 -> K9d -> K3 needs no compaction between them.
// Groups never straddle a row (8,192 is a multiple of four).  The
// whole-table search it replaces took ~log2(M) dependent loads a key
// (3.9x its bound at M = 2^24, PERF.md).  The slots carry no order across
// rows, so neighbouring threads probe distant rows: on 40x reads at 2^24
// the slots take ~1.2x the flat form's time for ~1.1x its keys, and
// about half of either is global atomics (PERF.md).
//
// In:  keys (N,) or (S, 8192) int64 (INT64_MAX = invalid window,
//      skipped); weights of the keys' shape, int64 (K3 only); counts (S,)
//      int32 (K3's slots only); table (M,) int64 sorted ascending (unique
//      apart from trailing INT64_MAX rows) with its `live` rows and prefix
//      directory; acc (M,) int64, incremented in place with atomicAdd on
//      the unsigned 64-bit view (two's complement: the same add).
//
// Bound: by bytes, the key stream (8 bytes a window for K2, a distinct
// key for K3, plus K3's 8-byte weight of each key found) plus 24 bytes for
// each table row hit (the key read, the count read and written) is ~2-40
// us per 32,768 x 152 bp batch at 3.35 TB/s.  K2's whole-table search took ~log2(M) dependent loads a key
// and ran 9-22x that bound; through the directory it takes 2-4.  Its
// further cost on real data is atomic contention: coverage repeats a
// k-mer in ~40 reads of a batch, and those adds serialise on one address.
// Staged (live <= 6,207 on an H100: up to 115,712 bytes of opted-in
// dynamic shared memory, two blocks an SM), K2 therefore counts into
// block-private shared-memory counts beside the staged rows and directory
// copy, and a block flushes each nonzero count with one global atomic: at
// most one global add per block and row instead of one per hit.  The global form
// keeps one global atomic per hit.  K3 does one search and at most one
// atomic per distinct key of a segment (~1,090 of a 40x segment's 8,192
// windows), so it trades that contention for the dedup in front of it;
// a key repeated across segments adds once per segment.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "sorted_table.cuh"

namespace {

using kdf::kKeys;

template <bool kGlobal, typename Dir>
__device__ __forceinline__ void tally_groups(
    const long long* __restrict__ keys, long long n, bool vec,
    const long long* t, const Dir* dir, int bits, int shift,
    unsigned long long* counts) {
  const long long groups = (n + kKeys - 1) / kKeys;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    long long q[kKeys];
    int row[kKeys];
    kdf::load_keys(keys, n, g, vec, q);
    kdf::find_rows_dir<kGlobal>(t, dir, shift, bits, q, row);
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (row[j] >= 0) atomicAdd(counts + row[j], 1ull);
    }
  }
}

// K2, staged form: rows, block-private counts and a uint16 directory in
// shared memory; one global add per nonzero count at the end.
__global__ void __launch_bounds__(kdf::kDirStagedThreads, 2)
    probe_tally_staged(const long long* __restrict__ keys, long long n,
                       bool vec, const long long* __restrict__ table, int live,
                       const int* __restrict__ dir, int bits, int shift,
                       unsigned long long* __restrict__ acc) {
  extern __shared__ long long staged[];
  auto* counts = reinterpret_cast<unsigned long long*>(staged + live);
  auto* d = reinterpret_cast<unsigned short*>(counts + live);
  for (int r = threadIdx.x; r < live; r += blockDim.x) counts[r] = 0;
  kdf::stage_directory(table, live, dir, bits, staged, d);
  tally_groups<false>(keys, n, vec, staged, d, bits, shift, counts);
  __syncthreads();
  for (int r = threadIdx.x; r < live; r += blockDim.x) {
    const unsigned long long c = counts[r];
    if (c != 0) atomicAdd(acc + r, c);
  }
}

// K2, global form: one global atomic per hit.  kThreads is 256 (the
// plan) or 512 (a launch override of 512 threads).
template <int kThreads>
__global__ void __launch_bounds__(kThreads, kdf::global_min_blocks(kThreads))
    probe_tally_global(const long long* __restrict__ keys, long long n,
                       bool vec, const long long* __restrict__ table,
                       const int* __restrict__ dir, int bits, int shift,
                       unsigned long long* __restrict__ acc) {
  tally_groups<true>(keys, n, vec, table, dir, bits, shift, acc);
}

// K3's group g: keys [4 g, 4 g + 4) of those below `end` (sentinel
// after: never read), each searched through the directory, a found key's
// weight added.
__device__ __forceinline__ void tally_weighted_group(
    const long long* __restrict__ keys, const long long* __restrict__ weights,
    long long end, long long g, bool vec, const long long* __restrict__ table,
    const int* __restrict__ dir, int bits, int shift,
    unsigned long long* __restrict__ acc) {
  long long q[kKeys];
  int found[kKeys];
  kdf::load_keys(keys, end, g, vec, q);
  kdf::find_rows_dir<true>(table, dir, shift, bits, q, found);
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    if (found[j] >= 0) {
      atomicAdd(acc + found[j], static_cast<unsigned long long>(
                                    __ldg(weights + g * kKeys + j)));
    }
  }
}

// K3, flat: n keys, grid-stride over groups of four.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, kdf::global_min_blocks(kThreads))
    probe_tally_weighted_flat(const long long* __restrict__ keys,
                              const long long* __restrict__ weights,
                              long long n, bool vec,
                              const long long* __restrict__ table,
                              const int* __restrict__ dir, int bits, int shift,
                              unsigned long long* __restrict__ acc) {
  const long long groups = (n + kKeys - 1) / kKeys;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    tally_weighted_group(keys, weights, n, g, vec, table, dir, bits, shift,
                         acc);
  }
}

// K3 on K9d's slots: `rows` rows of 8,192, the first counts[s] of row s
// live.  A block takes a row at a time (grid-stride over rows) and its
// threads the row's live groups only, so no thread visits a dead slot.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, kdf::global_min_blocks(kThreads))
    probe_tally_weighted_slots(const long long* __restrict__ keys,
                               const long long* __restrict__ weights,
                               const int* __restrict__ counts, long long rows,
                               bool vec, const long long* __restrict__ table,
                               const int* __restrict__ dir, int bits,
                               int shift,
                               unsigned long long* __restrict__ acc) {
  constexpr int kRowBits = 13;  // 8,192 slots a row: whole groups of four
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long first = row << kRowBits;
    // a count outside [0, 8,192] reads no slot of another row
    const int live = min(max(__ldg(counts + row), 0), 1 << kRowBits);
    const long long end = first + live;
    for (long long g = first / kKeys + threadIdx.x; g * kKeys < end;
         g += blockDim.x) {
      tally_weighted_group(keys, weights, end, g, vec, table, dir, bits,
                           shift, acc);
    }
  }
}

std::atomic<uint64_t> staged_opted_in{0};

}  // namespace

// K2 over n keys through the table's directory, in the launch plan of
// kdf::dir_probe_launch; form, threads and blocks_per_sm are a
// kdf::LaunchOverride (all 0: the plan).
extern "C" int kdf_probe_tally(const void* keys, long long n,
                               const void* table, int live, const void* dir,
                               int bits, int shift, void* acc, int form,
                               int threads, int blocks_per_sm, void* stream) {
  kdf::DirLaunch launch;
  cudaError_t err = kdf::dir_probe_launch(
      n, live, bits, true, {form, threads, blocks_per_sm}, &launch);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* k = static_cast<const long long*>(keys);
  const auto* t = static_cast<const long long*>(table);
  const auto* d = static_cast<const int*>(dir);
  auto* a = static_cast<unsigned long long*>(acc);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  if (launch.staged) {
    err = kdf::opt_in_smem(probe_tally_staged, launch.budget,
                           staged_opted_in);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_tally_staged<<<launch.blocks, launch.threads, launch.smem, s>>>(
        k, n, vec, t, live, d, bits, shift, a);
  } else if (launch.threads <= kdf::kDirGlobalThreads) {
    probe_tally_global<kdf::kDirGlobalThreads>
        <<<launch.blocks, launch.threads, 0, s>>>(k, n, vec, t, d, bits,
                                                  shift, a);
  } else {
    probe_tally_global<2 * kdf::kDirGlobalThreads>
        <<<launch.blocks, launch.threads, 0, s>>>(k, n, vec, t, d, bits,
                                                  shift, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3 over n keys (flat: keys and weights (n,); slots, counts not null:
// (n / 8,192, 8,192) with counts (n / 8,192,) int32) through the
// table's directory.  K3 has the global form only: form may be auto or
// global, threads and blocks_per_sm as for K2 (0: 256 threads, at most
// four blocks an SM).
extern "C" int kdf_probe_tally_weighted(const void* keys, const void* weights,
                                        const void* counts, long long n,
                                        const void* table, const void* dir,
                                        int bits, int shift, void* acc,
                                        int form, int threads,
                                        int blocks_per_sm, void* stream) {
  const kdf::LaunchOverride o{form, threads, blocks_per_sm};
  if (!kdf::valid_override(o) || form == kdf::kFormStaged) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int block = threads != 0 ? threads : kdf::kDirGlobalThreads;
  const int per_sm =
      blocks_per_sm != 0 ? blocks_per_sm : kdf::kDirGlobalBlocksPerSm;
  const bool t512 = block > kdf::kDirGlobalThreads;
  const auto* k = static_cast<const long long*>(keys);
  const auto* w = static_cast<const long long*>(weights);
  const auto* c = static_cast<const int*>(counts);
  const auto* t = static_cast<const long long*>(table);
  const auto* d = static_cast<const int*>(dir);
  auto* a = static_cast<unsigned long long*>(acc);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  unsigned blocks = 0;
  if (c != nullptr) {
    // a block a row, at most per_sm blocks an SM
    const long long rows = n / 8192;
    const cudaError_t err =
        kdf::global_probe_blocks(rows * block, block, per_sm, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (t512) {
      probe_tally_weighted_slots<2 * kdf::kDirGlobalThreads>
          <<<blocks, block, 0, s>>>(k, w, c, rows, vec, t, d, bits, shift, a);
    } else {
      probe_tally_weighted_slots<kdf::kDirGlobalThreads>
          <<<blocks, block, 0, s>>>(k, w, c, rows, vec, t, d, bits, shift, a);
    }
  } else {
    const cudaError_t err = kdf::global_probe_blocks(
        (n + kKeys - 1) / kKeys, block, per_sm, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (t512) {
      probe_tally_weighted_flat<2 * kdf::kDirGlobalThreads>
          <<<blocks, block, 0, s>>>(k, w, n, vec, t, d, bits, shift, a);
    } else {
      probe_tally_weighted_flat<kdf::kDirGlobalThreads>
          <<<blocks, block, 0, s>>>(k, w, n, vec, t, d, bits, shift, a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
