// Kernel K10: the route of the sharded engine, a stable scatter of key
// rows into per-owner buckets (ops/route.py).
//
// Replaces the TPU's routing, which XLA runs inside the jitted shard
// program: kmer_denovo_filter_tpu/parallel/sharded.py hash_owner (:51)
// and _bucketize (:61), a one-hot cumsum into fixed-capacity buckets.
// Here the buckets have no capacity: a counting sort by owner, in three
// launches, gives the stable order of the rows by owner, the bucket
// sizes, and the rows gathered in that order.
//
// In:  keys (N, Q) int64 limb rows (Q = 1: flat (N,) keys), contiguous;
//      n_shards S; with_sentinel: a row whose limb 0 is INT64_MAX goes
//      to bucket S (bins = S + 1), else every row is hashed (bins = S).
// Out: order (N,) int64, the row indices sorted stably by owner;
//      sizes (bins,) int64; routed (N, Q) int64, keys[order].
//
// The owner is ops/route.py hash_owner: per limb, its low and high 32
// bits folded in by a 32-bit avalanche; the int64 version masks every
// product to 32 bits, so uint32 arithmetic in registers gives the same
// value.  The owner is (h * S) >> 32, computed in 64 bits.
//
// 1. route_count: a block takes `rounds` x 256 consecutive rows, hashes
//    each in registers and counts owners in a shared histogram (one
//    shared atomic per owner a warp, by __match_any_sync); it writes its
//    counts owner-major, counts[o * blocks + block].
// 2. route_scan: one block scans those counts exclusively in place, so
//    that within each owner the blocks keep their order, and writes the
//    bucket sizes.
// 3. route_scatter: each block walks its rows again, 256 a round, in
//    order.  A row's slot is its block's next free slot for its owner,
//    plus the rows of that owner in lower warps of the round (a uint8
//    count per warp and owner in shared memory), plus those in lower
//    lanes of its warp (__match_any_sync, __popc).  Each round's rows
//    are staged in shared memory by coalesced loads and written back
//    limb by limb, so each run of one owner's rows is written as
//    contiguous words.
//
// Bound: by bytes, each row read once (8Q B), routed and its index
// written once (8Q + 8 B): ~96 MB, ~0.029 ms, for one 32,768 x 152 bp
// batch at k = 31.  The kernels read the rows twice (the histogram and
// the scatter) and write each owner's run as partial sectors where a
// warp's rows scatter over several owners.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 1024;
constexpr int kMaxQ = 7;
constexpr int kScanThreads = 1024;
constexpr unsigned kSeed = 0x811C9DC5u;
constexpr unsigned kMul = 0x045D9F3Bu;

__device__ __forceinline__ unsigned mix32(unsigned h) {
  h = ((h >> 16) ^ h) * kMul;
  h = ((h >> 16) ^ h) * kMul;
  return (h >> 16) ^ h;
}

// The bucket of a row of q limbs: its owner shard, or n_shards for a
// sentinel row when the route has a sentinel bucket.
__device__ __forceinline__ int owner_of(const long long* row, int q,
                                        int n_shards, int with_sentinel) {
  if (with_sentinel && row[0] == LLONG_MAX) return n_shards;
  unsigned h = kSeed;
  for (int j = 0; j < q; ++j) {
    const unsigned long long limb = static_cast<unsigned long long>(row[j]);
    h = mix32(h ^ static_cast<unsigned>(limb));
    h = mix32(h ^ static_cast<unsigned>(limb >> 32));
  }
  return static_cast<int>(
      (static_cast<unsigned long long>(h) * n_shards) >> 32);
}

__global__ void __launch_bounds__(kThreads)
    route_count(const long long* __restrict__ keys, long long n, int q,
                int n_shards, int with_sentinel, int rounds, int blocks,
                long long* __restrict__ counts) {
  __shared__ unsigned hist[kMaxBins];
  const int bins = n_shards + with_sentinel;
  for (int b = threadIdx.x; b < bins; b += kThreads) hist[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * kThreads *
                         rounds;
  for (int r = 0; r < rounds; ++r) {
    const long long row = base + static_cast<long long>(r) * kThreads +
                          threadIdx.x;
    if (base + static_cast<long long>(r) * kThreads >= n) break;
    const int o = row < n ? owner_of(keys + row * q, q, n_shards,
                                     with_sentinel)
                          : bins;
    const unsigned peers = __match_any_sync(0xffffffffu, o);
    if (o < bins && lane == __ffs(peers) - 1) {
      atomicAdd(&hist[o], static_cast<unsigned>(__popc(peers)));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kThreads) {
    counts[static_cast<long long>(b) * blocks + blockIdx.x] = hist[b];
  }
}

__global__ void __launch_bounds__(kScanThreads)
    route_scan(long long* __restrict__ counts, int bins, int blocks,
               long long n, long long* __restrict__ sizes) {
  __shared__ long long part[kScanThreads];
  const long long total = static_cast<long long>(bins) * blocks;
  const long long per = (total + kScanThreads - 1) / kScanThreads;
  const long long lo = min(total, threadIdx.x * per);
  const long long hi = min(total, lo + per);
  long long sum = 0;
  for (long long i = lo; i < hi; ++i) sum += counts[i];
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const long long v = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  long long run = part[threadIdx.x] - sum;
  for (long long i = lo; i < hi; ++i) {
    const long long c = counts[i];
    counts[i] = run;
    run += c;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kScanThreads) {
    if (blocks == 0) {
      sizes[b] = 0;
      continue;
    }
    const long long start = counts[static_cast<long long>(b) * blocks];
    const long long end =
        b + 1 < bins ? counts[static_cast<long long>(b + 1) * blocks] : n;
    sizes[b] = end - start;
  }
}

__global__ void __launch_bounds__(kThreads)
    route_scatter(const long long* __restrict__ keys, long long n, int q,
                  int n_shards, int with_sentinel, int rounds, int blocks,
                  const long long* __restrict__ offsets,
                  long long* __restrict__ order,
                  long long* __restrict__ routed) {
  __shared__ unsigned long long next[kMaxBins];
  __shared__ unsigned char warp_count[kWarps][kMaxBins];
  __shared__ long long rows[kThreads * kMaxQ];
  __shared__ long long dest[kThreads];
  const int bins = n_shards + with_sentinel;
  for (int b = threadIdx.x; b < bins; b += kThreads) {
    next[b] = static_cast<unsigned long long>(
        offsets[static_cast<long long>(b) * blocks + blockIdx.x]);
    for (int w = 0; w < kWarps; ++w) warp_count[w][b] = 0;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long base = static_cast<long long>(blockIdx.x) * kThreads *
                         rounds;
  for (int r = 0; r < rounds; ++r) {
    const long long first = base + static_cast<long long>(r) * kThreads;
    if (first >= n) break;
    const int count = n - first < kThreads ? static_cast<int>(n - first)
                                           : kThreads;
    for (int e = threadIdx.x; e < count * q; e += kThreads) {
      rows[e] = keys[first * q + e];
    }
    __syncthreads();
    const int o = threadIdx.x < count
                      ? owner_of(rows + threadIdx.x * q, q, n_shards,
                                 with_sentinel)
                      : bins;
    const unsigned peers = __match_any_sync(0xffffffffu, o);
    const bool leader = o < bins && lane == __ffs(peers) - 1;
    if (leader) warp_count[warp][o] = static_cast<unsigned char>(
        __popc(peers));
    __syncthreads();
    if (o < bins) {
      long long d = static_cast<long long>(next[o]) + __popc(peers & below);
      for (int w = 0; w < warp; ++w) d += warp_count[w][o];
      dest[threadIdx.x] = d;
      order[d] = first + threadIdx.x;
    }
    __syncthreads();
    if (leader) {
      atomicAdd(&next[o], static_cast<unsigned long long>(__popc(peers)));
      warp_count[warp][o] = 0;
    }
    for (int e = threadIdx.x; e < count * q; e += kThreads) {
      routed[dest[e / q] * q + e % q] = rows[e];
    }
    __syncthreads();
  }
}

}  // namespace

// K10 over n rows of q limbs: the three launches on `stream`.  `counts`
// holds bins * blocks int64 (scratch); blocks = ceil(n / (256 * rounds))
// (ops/route.py plan).  Returns the first CUDA error, 0 on success.
extern "C" int kdf_route(const void* keys, long long n, int q, int n_shards,
                         int with_sentinel, int rounds, int blocks,
                         void* counts, void* order, void* sizes,
                         void* routed, void* stream) {
  const int bins = n_shards + (with_sentinel ? 1 : 0);
  if (bins < 1 || bins > kMaxBins || q < 1 || q > kMaxQ || rounds < 1 ||
      blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const long long*>(keys);
  auto* c = static_cast<long long*>(counts);
  const int sent = with_sentinel ? 1 : 0;
  if (blocks > 0) {
    route_count<<<blocks, kThreads, 0, s>>>(k, n, q, n_shards, sent, rounds,
                                            blocks, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  route_scan<<<1, kScanThreads, 0, s>>>(c, bins, blocks, n,
                                        static_cast<long long*>(sizes));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 0) return static_cast<int>(err);
  route_scatter<<<blocks, kThreads, 0, s>>>(
      k, n, q, n_shards, sent, rounds, blocks, c,
      static_cast<long long*>(order), static_cast<long long*>(routed));
  return static_cast<int>(cudaGetLastError());
}
