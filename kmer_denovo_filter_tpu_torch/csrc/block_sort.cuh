// The register bitonic sort of one 8,192-row segment by a block of 512
// threads, shared by kernels K9 (seg_sort.cu: keys, or keys with an
// int32 payload), K9d (seg_sort.cu: keys) and K9dw (seg_dedup_wide.cu:
// limb 0 of a wide row, with its element index as the payload; then, in
// its rare fallback, a limb with the element's earlier position).
//
// Element i = 16 t + r of the sort is register r of thread t, so the
// network's strides 1..8 are compare-exchanges between a thread's own
// registers, the strides 16..256 warp shuffles (lane xor 1..16), and
// only the strides 512..4096 cross warps.  Those go through shared
// memory once per merge of 1,024 rows or more: stored in the natural
// layout, loaded in a transposed one (i = t + 512 r) in which they too
// are register strides, stored back and reloaded: 8 barriers for the
// whole sort (the TPU network's port took 91, one a stage).  Addresses
// are XOR-swizzled (i ^ (i >> 4 & 15)) so both layouts' 8-byte accesses
// are free of bank conflicts (the payload's 4-byte accesses in the
// natural layout meet a 2-way conflict).
//
// Three kinds of element (Sort).  Keys alone: equal keys are
// interchangeable, and a shuffle stage's lane takes its partner's key
// when it is the one it keeps, equal or not.  A payload carried beside
// its key: a lane takes its partner's pair only when the partner's key
// is strictly the one it keeps (less for the lower lane, greater for the
// upper), so two equal keys each stay where they are and no payload is
// dropped or duplicated; equal keys end in an order the network fixes.
// (key, payload) pairs ordered lexicographically: a total order, the
// same strict rule on pairs, equal keys ordered by payload: a sort made
// stable by carrying the earlier position in the payload's high bits.
// On an H100 the carried payload took 0.227 ms for a 32,768 x 152 bp
// batch and the lexicographic pair 0.278 (PERF.md): K9 carries.
//
// Besides the sort, the row order that the unordered forms of K9d and
// K9dw write their segments in (RowOrder).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "sorted_table.cuh"

namespace kdf {

enum class Sort { kKeys, kCarried, kLexicographic };

constexpr int kLogSegment = 13;
constexpr int kSegment = 1 << kLogSegment;  // rows a segment (LCHUNK_DD)
constexpr int kSortThreads = 512;
constexpr int kSortRegs = kSegment / kSortThreads;  // 16 keys a thread
constexpr int kSortWarps = kSortThreads / 32;

// Inclusive sum of v over the warp.
__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const int other = __shfl_up_sync(0xFFFFFFFFu, v, off);
    if (lane >= off) v += other;
  }
  return v;
}

// Exclusive sum of v over the block of kSortThreads, and the block's
// total in *total.  Uses sums[kSortWarps]; all threads must call it.
__device__ __forceinline__ int block_exclusive_sum(int v, int* sums,
                                                   int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int inclusive = warp_inclusive_sum(v);
  if (lane == 31) sums[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    const int s = warp_inclusive_sum(lane < kSortWarps ? sums[lane] : 0);
    if (lane < kSortWarps) sums[lane] = s;
  }
  __syncthreads();
  *total = sums[kSortWarps - 1];
  return inclusive - v + (warp > 0 ? sums[warp - 1] : 0);
}

// The row order that the unordered forms of K9d and K9dw write a
// segment in: element t + 512 r (thread t's in round r, r < 16: a row of
// the segment, or a slot of the hash) goes to its rank among the live
// elements, round by round, warp by warp, lane by lane.  A ballot counts
// each warp's live elements a round, one block scan turns the 16 x 16
// counts into first places, and a second ballot ranks each lane within
// its warp: a warp's live elements land side by side.  Its state, in
// shared memory:
struct RowOrder {
  int first[kSortRegs * kSortWarps];  // a round and warp's first place
  int sums[kSortWarps];
};

// Counts round r's live elements of the calling warp; all threads call
// it, round by round.
__device__ __forceinline__ void row_order_count(RowOrder* o, int r,
                                                bool live) {
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, live);
  if ((threadIdx.x & 31) == 0) {
    o->first[r * kSortWarps + (threadIdx.x >> 5)] = __popc(ballot);
  }
}

// The counts of rounds [0, rounds) to their first places, in place; the
// live elements' number.  A barrier before and after; all threads call
// it.
__device__ __forceinline__ int row_order_scan(RowOrder* o, int rounds) {
  __syncthreads();
  const int t = threadIdx.x;
  const int cells = rounds * kSortWarps;
  int total;
  const int first =
      block_exclusive_sum(t < cells ? o->first[t] : 0, o->sums, &total);
  if (t < cells) o->first[t] = first;
  __syncthreads();
  return total;
}

// The place of a live element of round r (after row_order_scan); all
// threads call it, round by round.
__device__ __forceinline__ int row_order_place(const RowOrder* o, int r,
                                               bool live) {
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, live);
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  return o->first[r * kSortWarps + (threadIdx.x >> 5)] +
         __popc(ballot & below);
}

// Shared-memory slot of element i: the XOR swizzle that keeps both the
// natural (i = 16 t + r) and the transposed (i = t + 512 r) layout's
// 8-byte accesses free of bank conflicts.
__device__ __forceinline__ int swizzle(int i) { return i ^ ((i >> 4) & 15); }

// Whether (ka, pa) sorts before (kb, pb): by key, then
// (kLexicographic) by payload.
template <Sort kSort>
__device__ __forceinline__ bool sorts_before(long long ka, int pa,
                                             long long kb, int pb) {
  if constexpr (kSort == Sort::kLexicographic) {
    return ka < kb || (ka == kb && pa < pb);
  } else {
    return ka < kb;
  }
}

// The pair (a, b), a at the lower position: ascending leaves the smaller
// in a.  One compare, a predicate XOR and the selects of a swap.
template <Sort kSort>
__device__ __forceinline__ void compare_exchange(long long& a, int& pa,
                                                 long long& b, int& pb,
                                                 bool ascending) {
  const bool swap = sorts_before<kSort>(b, pb, a, pa) == ascending;
  const long long lo = swap ? b : a;
  b = swap ? a : b;
  a = lo;
  if constexpr (kSort != Sort::kKeys) {
    const int plo = swap ? pb : pa;
    pb = swap ? pa : pb;
    pa = plo;
  }
}

// Sorts p = 2^log_p elements (9 <= log_p <= 13) ascending by the bitonic
// network: key[r] (and pay[r]) of thread t < p / kSortRegs is element
// 16 t + r.  Merge size 2^j, stride 2^b, ascending where bit j of the
// lower element is clear.  Strides 1..8 (b <= 3) pair a thread's
// registers, 16..256 the same register of lanes t ^ 2^(b - 4); strides
// 512..4096 pair registers of the transposed layout, element t + 512 r in
// key[r] of every thread (p / 512 of them), through `buf` (p x 8 B of
// shared memory) and `pbuf` (p x 4 B, with a payload).  Threads past
// p / kSortRegs hold nothing in the natural layout and only meet the
// barriers; the natural holders are whole warps (p >= 512).  All threads
// must call it; it ends with the elements in registers in the natural
// layout and no barrier after the last reload.  (One instance for all
// sizes: an instance for each size spilled and ran slower.)  Keys alone
// leave pay and pbuf untouched.
template <Sort kSort>
__device__ __forceinline__ void block_sort(long long (&key)[kSortRegs],
                                           int (&pay)[kSortRegs], int log_p,
                                           long long* buf, int* pbuf) {
  constexpr bool kPayload = kSort != Sort::kKeys;
  const int t = threadIdx.x;
  const bool holds = t < (1 << log_p) / kSortRegs;
  const int n_tr = (1 << log_p) >> 9;  // transposed registers a thread
#pragma unroll 1
  for (int j = 1; j <= log_p; ++j) {
    if (j > 9) {
      if (holds) {
#pragma unroll
        for (int r = 0; r < kSortRegs; ++r) {
          buf[swizzle(t * kSortRegs + r)] = key[r];
          if constexpr (kPayload) pbuf[swizzle(t * kSortRegs + r)] = pay[r];
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kSortRegs; ++r) {
        if (r < n_tr) {
          key[r] = buf[swizzle(t + (r << 9))];
          if constexpr (kPayload) pay[r] = pbuf[swizzle(t + (r << 9))];
        }
      }
#pragma unroll
      for (int b = kLogSegment - 1; b >= 9; --b) {
        if (b >= j) continue;
        const int rb = 1 << (b - 9);
#pragma unroll
        for (int r = 0; r < kSortRegs; ++r) {
          if ((r & rb) == 0 && r < n_tr) {
            compare_exchange<kSort>(key[r], pay[r], key[r | rb],
                                    pay[r | rb], ((r >> (j - 9)) & 1) == 0);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kSortRegs; ++r) {
        if (r < n_tr) {
          buf[swizzle(t + (r << 9))] = key[r];
          if constexpr (kPayload) pbuf[swizzle(t + (r << 9))] = pay[r];
        }
      }
      __syncthreads();
      if (holds) {
#pragma unroll
        for (int r = 0; r < kSortRegs; ++r) {
          key[r] = buf[swizzle(t * kSortRegs + r)];
          if constexpr (kPayload) pay[r] = pbuf[swizzle(t * kSortRegs + r)];
        }
      }
    }
    if (!holds) continue;
#pragma unroll
    for (int b = 8; b >= 4; --b) {
      if (b >= j) continue;
      const int lanes = 1 << (b - 4);
      const bool keep_min = (((t >> (j - 4)) & 1) == 0) == ((t & lanes) == 0);
#pragma unroll
      for (int r = 0; r < kSortRegs; ++r) {
        const long long o = __shfl_xor_sync(0xFFFFFFFFu, key[r], lanes);
        if constexpr (kPayload) {
          const int op = __shfl_xor_sync(0xFFFFFFFFu, pay[r], lanes);
          // strict both ways: an element equal to the partner's stays
          const bool take = keep_min
                                ? sorts_before<kSort>(o, op, key[r], pay[r])
                                : sorts_before<kSort>(key[r], pay[r], o, op);
          key[r] = take ? o : key[r];
          pay[r] = take ? op : pay[r];
        } else {
          if ((o < key[r]) == keep_min) key[r] = o;
        }
      }
    }
#pragma unroll
    for (int b = 3; b >= 0; --b) {
      if (b >= j) continue;
      const int rb = 1 << b;
#pragma unroll
      for (int r = 0; r < kSortRegs; ++r) {
        if ((r & rb) == 0) {
          compare_exchange<kSort>(key[r], pay[r], key[r | rb], pay[r | rb],
                                  (((t * kSortRegs + r) >> j) & 1) == 0);
        }
      }
    }
  }
}

}  // namespace kdf
