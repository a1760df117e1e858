// The sorted-table probes shared by kernels K2, K3 and K4: an equality
// join of a stream of int64 query keys against a fixed sorted int64 key
// set.
//
// All three replace TPU tile joins (kmer_denovo_filter_tpu/ops/
// pallas_join.py and pallas_probe.py) that hash-partition the table into
// (P, 1024) lane tiles, route-sort the queries and compare them against
// DMA'd windows of partitions, with overflow flags when a chunk's span
// misses the window.  On Hopper none of that is needed; no capacity can
// overflow.  What sets a probe's time is its chain of dependent loads:
// a lower-bound search of the whole table takes ceil(log2(M + 1)) of
// them a key (13 at M = 4,096, 25 at 2^24), each a shared-memory, L2 or
// HBM round trip, and the key stream behind them is a tenth of the time
// (K2 ran 9-22x its bound on that search, PERF.md).
//
// K2, K3 and K4 therefore search through a prefix directory (below): one
// directory load, then a bounded search of one bucket of ~1-4 rows, two
// to four round trips a key whatever M.  K7 and K8 search wide rows
// through the same directory built over their limb 0 (sorted_rows.cuh),
// with the global form's launch shape (global_probe_blocks), as K3 does.
//
// Keys are right-aligned 2-bit k-mer values in [0, 2^62); INT64_MAX marks
// an invalid window and is never found.  Tables are ascending and unique
// apart from trailing INT64_MAX rows; `live` counts the rows before them.

#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace kdf {

constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;

// ── The prefix directory (K2, K3, K4; K7, K8 by limb 0) ────────────────
//
// The table's live rows fall into 2^bits buckets by their top bits:
// bucket p holds the rows whose key >> shift == p, where shift =
// max(0, bitlen(last live key) - bits), so every live key's prefix is
// below 2^bits whatever k.  dir[p] is the first live row whose
// key >> shift >= p, and dir[2^bits] = live: bucket p is rows
// [dir[p], dir[p + 1]).  A live query with p = q >> shift < 2^bits can
// sit only in bucket p, and a lower-bound search of that bucket is exact
// whatever its size (only its length varies: real tables cluster, e.g.
// poly-A near 0); one with p >= 2^bits lies above every key.
//
// Two forms.  Global (built once per table by kdf_build_directory,
// csrc/directory.cu, through ops/directory.py), int32 entries read with
// the table through the read-only path: bits = ceil(log2(live)), ~1 row a
// bucket, while the directory takes at most 16 MB (2^22 entries, a third
// of the L2), past it ceil(log2(live)) - 2, ~2-4 rows (one 32-byte
// sector) a bucket and ~1 B a row (measured, PERF.md: the finer
// directory ran 1.5x faster at 2^18-2^20 rows and no slower at 2^24).
// Staged: each block of K2/K4 copies the live rows and the global
// directory, as uint16 (bits = ceil(log2(live)) for any table small
// enough to stage: ~1 row a bucket, 2-4 B a row), into dynamic shared
// memory (copying beat building it in each block by 2-10 %, PERF.md);
// K2 adds 8 B of counts a row.  A table is staged when those bytes fit
// the shared memory that lets two blocks share an SM: (228 KB - 2 x 1 KB
// reserved) / 2 = 115,712 bytes on an H100, i.e. live <= 10,367 for K4
// and <= 6,207 for K2 (at bits 14 and 13); the kernels opt in to that
// much dynamic shared memory.  K3, K7 and K8 take the global form only
// (probe_tally.cu, probe_wide.cu).
//
// A thread takes kKeys consecutive keys (16-byte loads) and runs their
// searches interleaved, so their dependent loads overlap.  The two bounds
// of a bucket are two independent 4-byte (2-byte staged) loads of one
// sector, issued back to back: one round trip.  (One 8-byte load would
// need p even, or a directory of pairs at twice the bytes.)

constexpr int kKeys = 4;
constexpr int kDirStagedThreads = 512;
constexpr int kDirGlobalThreads = 256;
constexpr int kDirGlobalBlocksPerSm = 4;

// __launch_bounds__ blocks an SM of a global-form kernel of *threads* a
// block (256, the plan, or 512 under a launch override): the register
// budget of kDirGlobalBlocksPerSm blocks of kDirGlobalThreads, 64 a thread.
constexpr int global_min_blocks(int threads) {
  return kDirGlobalThreads * kDirGlobalBlocksPerSm / threads;
}

// *p through the read-only path (kGlobal) or a plain (shared) load.
template <bool kGlobal, typename T>
__device__ __forceinline__ T load_ro(const T* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// Writes dir[p] for every p in [0, 2^bits] from the sorted live rows
// of t, whose keys (limb 0 of a wide table's rows) lie row_stride int64
// apart: row i fills the prefixes after its predecessor's up to its own,
// and the items past the last row fill the tail with `live`.  Items
// i in [0, live + 2^bits + 1) go to the callers' threads by (first,
// step); the ones past the tail do nothing.
__device__ __forceinline__ void fill_directory(const long long* t,
                                               long long row_stride, int live,
                                               int shift, int bits, int* dir,
                                               long long first,
                                               long long step) {
  const long long n_dir = (1LL << bits) + 1;
  const long long tail_start =
      live > 0 ? (t[(live - 1) * row_stride] >> shift) + 1 : 0;
  const long long items = live + n_dir - tail_start;
  for (long long i = first; i < items; i += step) {
    if (i < live) {
      const long long own = t[i * row_stride] >> shift;
      for (long long p = i > 0 ? (t[(i - 1) * row_stride] >> shift) + 1 : 0;
           p <= own; ++p) {
        dir[p] = static_cast<int>(i);
      }
    } else {
      dir[tail_start + (i - live)] = live;
    }
  }
}

// Keys [kKeys g, kKeys g + kKeys) of keys[0, n), INT64_MAX past n: two
// 16-byte loads when `vec` (the stream is 16-byte aligned) and the group
// is whole, scalar loads otherwise.
__device__ __forceinline__ void load_keys(const long long* __restrict__ keys,
                                          long long n, long long g, bool vec,
                                          long long (&q)[kKeys]) {
  const long long i = g * kKeys;
  if (vec && i + kKeys <= n) {
    const auto* v = reinterpret_cast<const longlong2*>(keys + i);
    const longlong2 a = __ldg(v);
    const longlong2 b = __ldg(v + 1);
    q[0] = a.x;
    q[1] = a.y;
    q[2] = b.x;
    q[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      q[j] = i + j < n ? __ldg(keys + i + j) : kSentinel;
    }
  }
}

// The rows of q[0, kKeys) in the live rows t (-1 where absent or a
// sentinel), each by a lower-bound search of its bucket only, the
// kKeys searches interleaved.  Per key: base is the last row known below
// q (one before the bucket at first), len the rows after it still
// unknown; a probe at base + ceil(len / 2) halves them, and the last
// probe that met a row >= q is the answer row, found when it equals q.
// bitlen(bucket rows) probes after the directory's one round trip.
template <bool kGlobal, typename Dir>
__device__ __forceinline__ void find_rows_dir(const long long* t,
                                              const Dir* dir, int shift,
                                              int bits,
                                              const long long (&q)[kKeys],
                                              int (&row)[kKeys]) {
  int base[kKeys];
  int len[kKeys];
  bool eq[kKeys];
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const unsigned long long p =
        static_cast<unsigned long long>(q[j]) >> shift;
    const bool in = q[j] != kSentinel && (p >> bits) == 0;
    const int lo = in ? static_cast<int>(load_ro<kGlobal>(dir + p)) : 0;
    const int hi = in ? static_cast<int>(load_ro<kGlobal>(dir + p + 1)) : 0;
    base[j] = lo - 1;
    len[j] = hi - lo;
    eq[j] = false;
  }
  bool more = true;
  while (more) {
    long long v[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      v[j] = len[j] > 0 ? load_ro<kGlobal>(t + base[j] + ((len[j] + 1) >> 1))
                        : 0;
    }
    more = false;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (len[j] > 0) {
        const int half = (len[j] + 1) >> 1;
        if (v[j] < q[j]) {
          base[j] += half;
          len[j] -= half;
        } else {
          eq[j] = v[j] == q[j];
          len[j] = half - 1;
        }
        more |= len[j] > 0;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kKeys; ++j) row[j] = eq[j] ? base[j] + 1 : -1;
}

// Stages the live rows in t and a uint16 copy of the global directory
// `dir` (2^bits + 1 entries) in d.  Ends with a __syncthreads().
__device__ __forceinline__ void stage_directory(
    const long long* __restrict__ table, int live,
    const int* __restrict__ dir, int bits, long long* t, unsigned short* d) {
  for (int r = threadIdx.x; r < live; r += blockDim.x) t[r] = __ldg(table + r);
  for (int p = threadIdx.x; p <= (1 << bits); p += blockDim.x) {
    d[p] = static_cast<unsigned short>(__ldg(dir + p));
  }
  __syncthreads();
}

// Launch shape of a directory probe over n keys (kKeys a thread, grid-
// stride over groups): staged blocks of kDirStagedThreads (two an SM)
// when the live rows (8 B each, 16 B with `counts`) and the uint16
// directory of 2^bits + 1 entries fit the shared memory two blocks can
// share an SM with, else global blocks of kDirGlobalThreads (four an SM).
//
// A LaunchOverride (the experiments' `variants` and `steps` sweeps; the
// engine never passes one) may force the form, set the threads a block
// (128, 256 or 512) and cap the blocks an SM; each field left 0 keeps the
// plan above.  Forcing the staged form on a table that does not fit, or
// any other value, gives cudaErrorInvalidValue.
enum LaunchForm { kFormAuto = 0, kFormStaged = 1, kFormGlobal = 2 };

struct LaunchOverride {
  int form;           // LaunchForm
  int threads;        // 0, or 128, 256 or 512
  int blocks_per_sm;  // 0, or a cap of 1..32
};

struct DirLaunch {
  bool staged;
  unsigned blocks;
  int threads;
  size_t smem;    // staged: the block's dynamic shared memory
  size_t budget;  // staged: the shared memory two blocks an SM allow
};

inline bool valid_override(const LaunchOverride& o) {
  return o.form >= kFormAuto && o.form <= kFormGlobal &&
         (o.threads == 0 || o.threads == 128 || o.threads == 256 ||
          o.threads == 512) &&
         o.blocks_per_sm >= 0 && o.blocks_per_sm <= 32;
}

inline cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

inline cudaError_t dir_probe_launch(long long n, int live, int bits,
                                    bool counts, const LaunchOverride& o,
                                    DirLaunch* out) {
  if (!valid_override(o)) return cudaErrorInvalidValue;
  int device = 0;
  int sms = 0;
  int smem_sm = 0;
  int optin = 0;
  int reserved = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  }
  if (err != cudaSuccess) return err;
  const long long smem = static_cast<long long>(live) * (counts ? 16 : 8) +
                         2 * ((1LL << bits) + 1);
  const long long per_block = smem_sm / 2 - reserved;
  out->budget = static_cast<size_t>(per_block < optin ? per_block : optin);
  const bool fits = smem <= static_cast<long long>(out->budget);
  out->staged = o.form == kFormAuto ? fits : o.form == kFormStaged;
  if (out->staged && !fits) return cudaErrorInvalidValue;
  out->threads = o.threads != 0 ? o.threads
                 : out->staged  ? kDirStagedThreads
                                : kDirGlobalThreads;
  out->smem = out->staged ? static_cast<size_t>(smem) : 0;
  const long long groups = (n + kKeys - 1) / kKeys;
  const long long need = (groups + out->threads - 1) / out->threads;
  const long long per_sm = o.blocks_per_sm != 0 ? o.blocks_per_sm
                           : out->staged        ? 2
                                                : kDirGlobalBlocksPerSm;
  const long long cap = static_cast<long long>(sms) * per_sm;
  out->blocks = static_cast<unsigned>(need < cap ? need : cap);
  return cudaSuccess;
}

// Blocks of *threads* (default kDirGlobalThreads) for a grid-stride over
// *groups* (of kKeys narrow keys, or of a wide probe's rows): at most
// *per_sm* (default kDirGlobalBlocksPerSm) an SM, the global form of K2
// and K4, K3's only form.
inline cudaError_t global_probe_blocks(long long groups, int threads,
                                       int per_sm, unsigned* blocks) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long need = (groups + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<unsigned>(need < cap ? need : cap);
  return cudaSuccess;
}

inline cudaError_t global_probe_blocks(long long groups, unsigned* blocks) {
  return global_probe_blocks(groups, kDirGlobalThreads, kDirGlobalBlocksPerSm,
                             blocks);
}

// Opts *kernel* in to *bytes* of dynamic shared memory on the current
// device, once: *done* holds a bit for each device (0..63) already set.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes,
                        std::atomic<uint64_t>& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace kdf
