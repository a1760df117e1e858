// The sorted-row probe of kernels K7 and K8: an equality join of a
// stream of wide query keys against a fixed sorted set of wide keys,
// through the table's prefix directory over limb 0.  The wide counterpart
// of the directory search of sorted_table.cuh (K2, K4), whose directory,
// builder and launch shape it shares.
//
// A wide key (k = 33..207) is a row of Q = ceil(k / 31) int64 limbs
// (ops/keys.py), compared limb by limb; limb 0 holds bases 0..30,
// right-aligned below 2^62.  Tables and query streams are row-major
// (M, Q) / (N, Q).  Q is a template parameter (2..7): a query's limbs
// stay in registers and the compares unroll.
//
// Both kernels replace TPU tile joins (kmer_denovo_filter_tpu/ops/
// pallas_join.py, kernels 7 and 8) that route-hash the W = 3..13 key
// words into (P, 1024) lane tiles, sort the queries by partition and
// compare them against DMA'd windows whose height is cut by a VMEM
// budget, with span-overflow flags and a replay ladder.  Nothing here
// can overflow.
//
// The search.  Rows are sorted lexicographically, so limb 0 is non-
// decreasing down the table and `limb0 >> shift` buckets the rows as a
// narrow key is bucketed: the directory (built by kdf_build_directory
// with the row stride Q) gives a query's bucket in one round trip, and
// a bounded lower-bound search of that bucket compares limb 0 first and
// reads the other limbs of a probed row only when its limb 0 ties the
// query's.  Rows that share their first 31 bases share a bucket (a wide
// poly-A run or tandem repeat); the bounded search stays exact whatever
// a bucket holds, it only takes bitlen(bucket rows) probes.  The
// whole-table search this replaces took ceil(log2(M + 1)) dependent row
// loads (13 at M = 4,096, 25 at 2^24).
//
// Limb 0 is read in place, at a stride of 8Q bytes down the (M, Q)
// table, so a tie's other limbs lie in the same or the next sector.  A
// contiguous (live,) copy of limb 0 beside the directory (a bucket of
// 2-4 rows in one sector, the other limbs another random read on a tie)
// ran 0.9-1.2x as fast on an H100 and was dropped (PERF.md).
//
// The table and the directory are read through the read-only path; no
// form stages them in shared memory (probe_wide.cu).
//
// A thread takes row_keys<Q>() consecutive query rows (four at Q <= 3,
// two past it, so their limbs fit in registers without spills), loads
// them with 16-byte loads (a thread's rows are 8Q x keys contiguous
// bytes, a multiple of 16) and runs their searches interleaved, so
// their dependent loads overlap.
//
// A row whose limb 0 is INT64_MAX is the sentinel (an invalid window);
// it is never found.  Tables are ascending and unique apart from
// trailing sentinel rows; `live` counts the rows before them.  Offsets
// row·Q are 64-bit: M·Q nears 2^31 at Q = 7, M = 2^28.

#pragma once

#include <cuda_runtime.h>

#include "sorted_table.cuh"

namespace kdf {

// Query rows a thread takes.
template <int Q>
__host__ __device__ constexpr int row_keys() {
  return Q <= 3 ? 4 : 2;
}

// Rows [K g, K g + K) of keys[0, n) (Q limbs each), sentinel rows past
// n: K Q / 2 16-byte loads when `vec` (the stream is 16-byte aligned)
// and the group is whole, scalar loads otherwise.
template <int Q, int K>
__device__ __forceinline__ void load_rows(const long long* __restrict__ keys,
                                          long long n, long long g, bool vec,
                                          long long (&q)[K][Q]) {
  const long long i = g * K;
  if (vec && i + K <= n) {
    const auto* v = reinterpret_cast<const longlong2*>(keys + i * Q);
#pragma unroll
    for (int h = 0; h < K * Q / 2; ++h) {
      const longlong2 x = __ldg(v + h);
      q[(2 * h) / Q][(2 * h) % Q] = x.x;
      q[(2 * h + 1) / Q][(2 * h + 1) % Q] = x.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int l = 0; l < Q; ++l) {
        q[j][l] = i + j < n ? __ldg(keys + (i + j) * Q + l) : kSentinel;
      }
    }
  }
}

// -1, 0 or 1 as limbs 1..Q-1 of row r are below, equal to or above
// those of q (their limbs 0 tie).
template <int Q>
__device__ __forceinline__ int compare_tail(const long long* __restrict__ r,
                                            const long long (&q)[Q]) {
  long long v[Q];
#pragma unroll
  for (int l = 1; l < Q; ++l) v[l] = __ldg(r + l);
#pragma unroll
  for (int l = 1; l < Q; ++l) {
    if (v[l] != q[l]) return v[l] < q[l] ? -1 : 1;
  }
  return 0;
}

// The rows of q[0, K) in the live rows t (-1 where absent or a
// sentinel), each by a lower-bound search of its bucket only, the K
// searches interleaved.  A probe reads limb 0 of its row and, when that
// ties the query's, the row's other limbs.  Per key: base is the last
// row known below q (one before the bucket at first), len the rows
// after it still unknown; a probe at base + ceil(len / 2) halves them,
// and the last probe that met a row >= q is the answer row, found when
// it equals q.  bitlen(bucket rows) probes after the directory's one
// round trip.  t and dir are read through the read-only path.
template <int Q, int K>
__device__ __forceinline__ void find_rows_dir_wide(
    const long long* __restrict__ t, const int* __restrict__ dir, int shift,
    int bits, const long long (&q)[K][Q], int (&row)[K]) {
  int base[K];
  int len[K];
  bool eq[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const unsigned long long p =
        static_cast<unsigned long long>(q[j][0]) >> shift;
    const bool in = q[j][0] != kSentinel && (p >> bits) == 0;
    const int lo = in ? __ldg(dir + p) : 0;
    const int hi = in ? __ldg(dir + p + 1) : 0;
    base[j] = lo - 1;
    len[j] = hi - lo;
    eq[j] = false;
  }
  bool more = true;
  while (more) {
    long long v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const long long mid = base[j] + ((len[j] + 1) >> 1);
      v[j] = len[j] > 0 ? __ldg(t + mid * Q) : 0;
    }
    more = false;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (len[j] > 0) {
        const int half = (len[j] + 1) >> 1;
        const long long mid = base[j] + half;
        const int cmp =
            v[j] != q[j][0]
                ? (v[j] < q[j][0] ? -1 : 1)
                : compare_tail<Q>(t + mid * Q, q[j]);
        if (cmp < 0) {
          base[j] += half;
          len[j] -= half;
        } else {
          eq[j] = cmp == 0;
          len[j] = half - 1;
        }
        more |= len[j] > 0;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) row[j] = eq[j] ? base[j] + 1 : -1;
}

// Launch shape of K7 and K8 over n query rows, row_keys<Q>() a thread
// (grid-stride over groups): global_probe_blocks (sorted_table.cuh).
template <int Q>
inline cudaError_t wide_probe_blocks(long long n, unsigned* blocks) {
  return global_probe_blocks((n + row_keys<Q>() - 1) / row_keys<Q>(), blocks);
}

}  // namespace kdf
