// Kernel K1w: canonical window extraction for wide keys (k = 33..207).
//
// The JAX package has no TPU kernel here: it extracts wide windows in XLA
// (kmer_denovo_filter_tpu/ops/device.py:extract_canonical_windows, its
// W >= 3 branch, via pallas_join.extract_flat_keys :2195), packing the
// bases once and slicing the packs per word.  K1w is the wide counterpart
// of K1 (extract_canonical.cu) on the wide path.
//
// In:  codes (B, L) uint8, 2-bit bases with 4 = N/padding; lengths (B,)
//      int32; k odd in 33..207.
// Out: keys (B, S = L - k + 1, Q) int64, Q = ceil(k / 31) limbs (ops/
//      keys.py): limb j holds bases 31j .. 31j + n_j - 1 right-aligned,
//      and the key is the lexicographic min of the forward and the
//      reverse-complement limb rows; a row of INT64_MAX where the window
//      holds a code >= 4 or runs past the read's length.
//
// Bound: bytes.  Each window writes 8Q bytes and the batch's codes are
// read once: at k = 63 on 152 bp reads, 2.9M windows, 76 MB, 23 us at
// 3.35 TB/s.  The first K1w ran one thread per window over both strands
// base by base (2k byte loads and 64-bit shift-ors a window, 3.3x its
// bound at k = 33, 10.7x at k = 151), and its thread i stored Q int64 at
// 8Qi, so a warp's stores strode 8Q bytes.  This design:
//   - packs a tile of kTile start positions of the flat code stream into
//     2-bit words and an N bit mask in shared memory, as K1 does
//     (packed_window.cuh);
//   - pass 1, one thread per position: the N test (an OR over the <= 8
//     mask words the k bits span), the length test, and the orientation:
//     forward limb j against reverse-complement limb j, each a funnel
//     extract of the packed words (the complement limb from the bases
//     [k - 31j - n_j, k - 31j), complemented and reversed by pairs), up
//     to the first limb that differs (almost always limb 0).  It keeps
//     one byte (forward, reverse complement or sentinel) and the frame
//     offset of each of the tile's windows in shared memory;
//   - pass 2, one thread per output int64: the tile's windows fill one
//     contiguous span of n_windows * Q int64, and thread e writes element
//     e of it, re-extracting its limb from the packed words.  Neighbouring
//     threads store neighbouring int64: stores coalesced.
// Each window costs O(Q) instructions, not O(k), and no division: (read,
// column) is carried by adds from the tile's first position.  k is odd,
// so the strands never tie.

#include <cstdint>

#include <cuda_runtime.h>

#include "packed_window.cuh"

namespace {

using namespace kdf_packed;

constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kBasesPerLimb = 31;
constexpr uint8_t kForward = 0, kReverse = 1, kInvalid = 2;

// Limb j (n bases) of the window at frame offset u, on either strand.
__device__ __forceinline__ uint64_t forward_limb(const uint32_t* pk, int u,
                                                 int j, int n) {
  return forward_bases(window64(pk, u + kBasesPerLimb * j), n);
}

__device__ __forceinline__ uint64_t reverse_limb(const uint32_t* pk, int u,
                                                 int k, int j, int n) {
  return reverse_complement(window64(pk, u + k - kBasesPerLimb * j - n), n);
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
    extract_wide_kernel(const uint8_t* __restrict__ codes,
                        const int32_t* __restrict__ lengths,
                        long long* __restrict__ keys, int n_reads,
                        int length, int k) {
  __shared__ Packed sm;
  __shared__ Tile tile;
  __shared__ uint16_t frame_of[kTile];  // frame offset of window w
  __shared__ uint8_t strand_of[kTile];  // kForward, kReverse or kInvalid
  const int s = length - k + 1;
  const int last = k - kBasesPerLimb * (Q - 1);
  const long long total = static_cast<long long>(n_reads) * length;
  if (threadIdx.x == 0) tile = make_tile(codes, total, length, s, k);
  __syncthreads();
  load_tile(codes, total, tile, sm);
  __syncthreads();

  // pass 1: validity and orientation of each window of the tile
  const int head = tile.head;
  const long long first = tile.first;
  for_each_window(tile, length, s, [&](int q, int read, unsigned col) {
    const int u = q + head;
    const int w =
        static_cast<int>(static_cast<long long>(read) * s + col - first);
    uint8_t strand = kForward;
    if (static_cast<int>(col) + k > lengths[read] || any_n(sm.nmask, u, k)) {
      strand = kInvalid;
    } else {
      for (int j = 0; j < Q; ++j) {
        const int n = j < Q - 1 ? kBasesPerLimb : last;
        const uint64_t f = forward_limb(sm.codes, u, j, n);
        const uint64_t r = reverse_limb(sm.codes, u, k, j, n);
        if (f != r) {
          strand = r < f ? kReverse : kForward;
          break;
        }
      }
    }
    frame_of[w] = static_cast<uint16_t>(u);
    strand_of[w] = strand;
  });
  __syncthreads();

  // pass 2: the tile's n_windows * Q output int64, one per thread
  long long* out = keys + tile.first * Q;
  const int n_out = tile.n_windows * Q;
  for (int e = threadIdx.x; e < n_out; e += kThreads) {
    const int w = e / Q;
    const int j = e - w * Q;
    const uint8_t strand = strand_of[w];
    const int u = frame_of[w];
    const int n = j < Q - 1 ? kBasesPerLimb : last;
    // one extract at the strand's bases, then a select: neighbouring
    // windows take either strand, and a branch would run both in a warp
    const bool rc = strand == kReverse;
    const uint64_t win = window64(
        sm.codes, rc ? u + k - kBasesPerLimb * j - n : u + kBasesPerLimb * j);
    const uint64_t v = rc ? reverse_complement(win, n) : forward_bases(win, n);
    out[e] = strand == kInvalid ? kSentinel : static_cast<long long>(v);
  }
}

template <int Q>
int launch(const void* codes, const void* lengths, void* keys, int n_reads,
           int length, int k, cudaStream_t stream) {
  const long long total = static_cast<long long>(n_reads) * length;
  const long long blocks = (total + kTile - 1) / kTile;
  extract_wide_kernel<Q><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(lengths), static_cast<long long*>(keys),
      n_reads, length, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a CUDA error code, or cudaErrorInvalidValue for a k outside
// 32..207 (a tile's shared memory holds kTile + 206 bases).
extern "C" int kdf_extract_canonical_wide(const void* codes,
                                          const void* lengths, void* keys,
                                          int n_reads, int length, int k,
                                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  switch ((k + kBasesPerLimb - 1) / kBasesPerLimb) {
    case 2: return launch<2>(codes, lengths, keys, n_reads, length, k, s);
    case 3: return launch<3>(codes, lengths, keys, n_reads, length, k, s);
    case 4: return launch<4>(codes, lengths, keys, n_reads, length, k, s);
    case 5: return launch<5>(codes, lengths, keys, n_reads, length, k, s);
    case 6: return launch<6>(codes, lengths, keys, n_reads, length, k, s);
    case 7: return launch<7>(codes, lengths, keys, n_reads, length, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
