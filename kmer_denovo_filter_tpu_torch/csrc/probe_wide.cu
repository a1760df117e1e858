// Kernels K7 and K8: filtered tally and membership of wide window keys
// (k = 33..207, rows of Q = 2..7 int64 limbs) against a sorted table,
// through the table's prefix directory over limb 0 (sorted_rows.cuh).
//
// K7 (kdf_probe_tally_wide) replaces the Pallas TPU kernel
// kmer_denovo_filter_tpu/ops/pallas_join.py:_tally_kernel_wide (:1905),
// reached through join_tally_flat_wide (:2180, unweighted: the VCF-mode
// parent scan) and join_tally_flat_wide_dedup (:1564, weighted: the
// discovery parent filter over a batch's distinct keys and their
// multiplicities).  As there, one body serves both forms: a found key
// adds 1, or its weight.  The weighted form also reads kernel K9dw's
// per-segment slots in place (seg_dedup_wide.cu), a block a segment.
//
// K8 (kdf_probe_member_wide) replaces pallas_join.py:_member_kernel_wide
// (:1997) via join_member_step_wide (:2216): the reference subtraction
// (Module 0), the anchoring scan (Module 3) and KmerIndex.counts_of.
//
// The TPU kernels join route-hashed, partition-sorted W-plane queries
// against VMEM windows of W-plane tiles and unsort the found bits with a
// second sort; here each key searches its bucket of the sorted table and
// writes its own result, so nothing is routed, sorted or unsorted.
//
// In:  keys (N, Q) int64 (a row with limb 0 = INT64_MAX is an invalid
//      window: skipped, never found); weights (N,) int64 or null (K7);
//      or K9dw's slots, keys (S, 8192, Q) and weights (S, 8192) with
//      counts (S,) int32, only the first counts[s] of row s read;
//      table (M, Q) int64, rows ascending, unique apart from trailing
//      sentinel rows, and its prefix directory over limb 0 (dir, bits,
//      shift; built by kdf_build_directory over its live rows).
// Out: K7: acc (M,) int64, incremented in place with atomicAdd on the
//      unsigned 64-bit view.  K8: found (N,) one byte per key and/or rows
//      (N,) int64, the key's table row or -1; either may be null; no
//      atomics, the table is only read.
//
// Bound: by bytes, 8Q bytes a key (plus 8 a weight, or 1 of output for
// K8) and, per table row hit, 8Q read plus 16 of accumulator for K7: at
// Q = 3 a 4.0M-window batch moves ~100 MB, ~30 us at 3.35 TB/s.  What
// held the whole-table search at up to 15x that bound was its ~log2(M)
// dependent row loads a key; through the directory a key takes one
// directory round trip and bitlen(bucket rows) probes of limb 0, plus
// one read of the other limbs on a tie.
//
// One form: the table and the directory are read through the read-only
// path (a 4,096-row table at Q = 3, 98 KB, stays in L1 and L2) and K7
// adds with one global atomic per hit.  A staged form that copied the
// live rows and the directory into each block's shared memory ran
// 1.07-2x slower at every table it held on an H100 (each block copied
// the whole table for ~2,000 probes) and was deleted (PERF.md).

#include <cstdint>

#include <cuda_runtime.h>

#include "sorted_rows.cuh"

namespace {

// Writes the found bytes (when found is set) and rows (when rows is set)
// of keys [K g, K g + K) of n: one K-byte store and K / 2 16-byte
// stores for a whole group when `vec`.
template <int K>
__device__ __forceinline__ void store_group(long long n, long long g,
                                            bool vec, const int (&row)[K],
                                            uint8_t* __restrict__ found,
                                            long long* __restrict__ rows) {
  const long long i = g * K;
  if (vec && i + K <= n) {
    if (found != nullptr) {
      if constexpr (K == 4) {
        *reinterpret_cast<uchar4*>(found + i) =
            make_uchar4(row[0] >= 0, row[1] >= 0, row[2] >= 0, row[3] >= 0);
      } else {
        *reinterpret_cast<uchar2*>(found + i) =
            make_uchar2(row[0] >= 0, row[1] >= 0);
      }
    }
    if (rows != nullptr) {
      auto* r = reinterpret_cast<longlong2*>(rows + i);
#pragma unroll
      for (int h = 0; h < K / 2; ++h) {
        r[h] = make_longlong2(row[2 * h], row[2 * h + 1]);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (i + j < n) {
      if (found != nullptr) found[i + j] = row[j] >= 0 ? 1 : 0;
      if (rows != nullptr) rows[i + j] = row[j];
    }
  }
}

// The search of every group of this thread (grid-stride) in the rows t
// through dir, each group's rows handed to visit.
template <int Q, typename Visit>
__device__ __forceinline__ void search_groups(
    const long long* __restrict__ keys, long long n, bool vec,
    const long long* __restrict__ t, const int* __restrict__ dir, int bits,
    int shift, Visit visit) {
  constexpr int K = kdf::row_keys<Q>();
  const long long groups = (n + K - 1) / K;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    long long q[K][Q];
    int row[K];
    kdf::load_rows<Q, K>(keys, n, g, vec, q);
    kdf::find_rows_dir_wide<Q, K>(t, dir, shift, bits, q, row);
    visit(g, row);
  }
}

// K7: adds 1 (or the key's weight) to counts[row] for every key found.
template <int Q, bool kWeighted>
struct Tally {
  const long long* weights;
  unsigned long long* counts;
  __device__ __forceinline__ void operator()(
      long long g, const int (&row)[kdf::row_keys<Q>()]) const {
    constexpr int K = kdf::row_keys<Q>();
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (row[j] >= 0) {
        atomicAdd(counts + row[j],
                  kWeighted ? static_cast<unsigned long long>(
                                  __ldg(weights + g * K + j))
                            : 1ull);
      }
    }
  }
};

// K8: found bytes and/or rows.
template <int Q>
struct Member {
  long long n;
  bool vec;
  uint8_t* found;
  long long* rows;
  __device__ __forceinline__ void operator()(
      long long g, const int (&row)[kdf::row_keys<Q>()]) const {
    store_group<kdf::row_keys<Q>()>(n, g, vec, row, found, rows);
  }
};

// K7: one global atomic per hit.
template <int Q, bool kWeighted>
__global__ void __launch_bounds__(kdf::kDirGlobalThreads,
                                  kdf::kDirGlobalBlocksPerSm)
    probe_tally_wide_kernel(const long long* __restrict__ keys,
                            const long long* __restrict__ weights,
                            long long n, bool vec,
                            const long long* __restrict__ table,
                            const int* __restrict__ dir, int bits, int shift,
                            unsigned long long* __restrict__ acc) {
  search_groups<Q>(keys, n, vec, table, dir, bits, shift,
                   Tally<Q, kWeighted>{weights, acc});
}

// K7 weighted on kernel K9dw's slots (seg_dedup_wide.cu): `rows` rows of
// 8,192 slots of Q limbs, the first counts[s] of row s live.  A block
// takes a row at a time (grid-stride over rows) and its threads the row's
// live groups only, so no thread visits a dead slot (K3's slots form,
// probe_tally.cu); the search is the flat form's.
template <int Q>
__global__ void __launch_bounds__(kdf::kDirGlobalThreads,
                                  kdf::kDirGlobalBlocksPerSm)
    probe_tally_wide_slots_kernel(const long long* __restrict__ keys,
                                  const long long* __restrict__ weights,
                                  const int* __restrict__ counts,
                                  long long rows, bool vec,
                                  const long long* __restrict__ table,
                                  const int* __restrict__ dir, int bits,
                                  int shift,
                                  unsigned long long* __restrict__ acc) {
  constexpr int K = kdf::row_keys<Q>();
  constexpr int kRowBits = 13;  // 8,192 slots a row: whole groups of K
  const Tally<Q, true> tally{weights, acc};
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long first = row << kRowBits;
    // a count outside [0, 8,192] reads no slot of another row
    const int live = min(max(__ldg(counts + row), 0), 1 << kRowBits);
    const long long end = first + live;
    for (long long g = first / K + threadIdx.x; g * K < end;
         g += blockDim.x) {
      long long q[K][Q];
      int found[K];
      kdf::load_rows<Q, K>(keys, end, g, vec, q);
      kdf::find_rows_dir_wide<Q, K>(table, dir, shift, bits, q, found);
      tally(g, found);
    }
  }
}

// K8: no atomics, the table is only read.
template <int Q>
__global__ void __launch_bounds__(kdf::kDirGlobalThreads,
                                  kdf::kDirGlobalBlocksPerSm)
    probe_member_wide_kernel(const long long* __restrict__ keys, long long n,
                             bool vec, const long long* __restrict__ table,
                             const int* __restrict__ dir, int bits, int shift,
                             uint8_t* __restrict__ found,
                             long long* __restrict__ rows) {
  search_groups<Q>(keys, n, vec, table, dir, bits, shift,
                   Member<Q>{n, vec, found, rows});
}

struct Args {
  const long long* keys;
  const long long* weights;
  const int* counts;
  long long n;
  const long long* table;
  const int* dir;
  int bits;
  int shift;
  cudaStream_t stream;
};

template <int Q, bool kWeighted>
int launch_tally(const Args& a, unsigned long long* acc) {
  unsigned blocks = 0;
  const cudaError_t err = kdf::wide_probe_blocks<Q>(a.n, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = reinterpret_cast<uintptr_t>(a.keys) % 16 == 0;
  probe_tally_wide_kernel<Q, kWeighted>
      <<<blocks, kdf::kDirGlobalThreads, 0, a.stream>>>(
          a.keys, a.weights, a.n, vec, a.table, a.dir, a.bits, a.shift, acc);
  return static_cast<int>(cudaGetLastError());
}

template <int Q>
int launch_member(const Args& a, uint8_t* found, long long* rows) {
  unsigned blocks = 0;
  const cudaError_t err = kdf::wide_probe_blocks<Q>(a.n, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte key loads and whole-group stores need aligned streams
  const bool vec = reinterpret_cast<uintptr_t>(a.keys) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(found) %
                           kdf::row_keys<Q>() == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  probe_member_wide_kernel<Q><<<blocks, kdf::kDirGlobalThreads, 0, a.stream>>>(
      a.keys, a.n, vec, a.table, a.dir, a.bits, a.shift, found, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int Q>
int launch_tally_slots(const Args& a, unsigned long long* acc) {
  // a block a row, at most the global form's blocks
  const long long rows = a.n / 8192;
  unsigned blocks = 0;
  const cudaError_t err =
      kdf::global_probe_blocks(rows * kdf::kDirGlobalThreads, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = reinterpret_cast<uintptr_t>(a.keys) % 16 == 0;
  probe_tally_wide_slots_kernel<Q>
      <<<blocks, kdf::kDirGlobalThreads, 0, a.stream>>>(
          a.keys, a.weights, a.counts, rows, vec, a.table, a.dir, a.bits,
          a.shift, acc);
  return static_cast<int>(cudaGetLastError());
}

template <int Q>
int tally_q(const Args& a, void* acc) {
  auto* c = static_cast<unsigned long long*>(acc);
  if (a.counts != nullptr) return launch_tally_slots<Q>(a, c);
  return a.weights != nullptr ? launch_tally<Q, true>(a, c)
                              : launch_tally<Q, false>(a, c);
}

template <int Q>
int member_q(const Args& a, void* found, void* rows) {
  return launch_member<Q>(a, static_cast<uint8_t*>(found),
                          static_cast<long long*>(rows));
}

Args make_args(const void* keys, const void* weights, const void* counts,
               long long n, const void* table, const void* dir, int bits,
               int shift, void* stream) {
  return Args{static_cast<const long long*>(keys),
              static_cast<const long long*>(weights),
              static_cast<const int*>(counts),
              n,
              static_cast<const long long*>(table),
              static_cast<const int*>(dir),
              bits,
              shift,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// weights null: unweighted.  counts not null (weights then too): keys
// (n / 8,192, 8,192, q) and weights (n / 8,192, 8,192) are K9dw's slots,
// the first counts[s] of row s live.  Returns a CUDA error code, or
// cudaErrorInvalidValue for q outside 2..7.
extern "C" int kdf_probe_tally_wide(const void* keys, const void* weights,
                                    const void* counts, long long n,
                                    const void* table, const void* dir,
                                    int bits, int shift, int q, void* acc,
                                    void* stream) {
  if (counts != nullptr && weights == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = make_args(keys, weights, counts, n, table, dir, bits, shift,
                           stream);
  switch (q) {
    case 2: return tally_q<2>(a, acc);
    case 3: return tally_q<3>(a, acc);
    case 4: return tally_q<4>(a, acc);
    case 5: return tally_q<5>(a, acc);
    case 6: return tally_q<6>(a, acc);
    case 7: return tally_q<7>(a, acc);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int kdf_probe_member_wide(const void* keys, long long n,
                                     const void* table, const void* dir,
                                     int bits, int shift, int q, void* found,
                                     void* rows, void* stream) {
  const Args a =
      make_args(keys, nullptr, nullptr, n, table, dir, bits, shift, stream);
  switch (q) {
    case 2: return member_q<2>(a, found, rows);
    case 3: return member_q<3>(a, found, rows);
    case 4: return member_q<4>(a, found, rows);
    case 5: return member_q<5>(a, found, rows);
    case 6: return member_q<6>(a, found, rows);
    case 7: return member_q<7>(a, found, rows);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
