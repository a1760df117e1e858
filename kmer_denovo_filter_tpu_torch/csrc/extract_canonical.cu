// Kernel K1: canonical k-mer window extraction for the parent scan.
//
// Replaces the Pallas TPU kernel
// kmer_denovo_filter_tpu/ops/pallas_extract.py:_extract_mix_kernel (:54),
// without its Feistel route mix: the mix exists to order keys for the
// TPU's partition routing, and the int64 keys here need none.  Like that
// kernel it packs bases into 2-bit words once and reads every window out
// of the packed words; the TPU builds its packs by doubling shifts along
// the lanes, here a block packs its tile in shared memory.
//
// In:  codes (B, L) uint8, 2-bit bases with 4 = N/padding; lengths (B,)
//      int32; k odd in 1..31.
// Out: keys (B, S = L - k + 1) int64, right-aligned 2-bit big-endian
//      k-mer value min(forward, reverse complement); INT64_MAX where the
//      window holds a code >= 4 or runs past the read's length.
//
// Bound: bytes.  Each window writes 8 bytes and the batch's codes are
// read once: at 4.0M windows of 152 bp reads, 37 MB, 11 us at 3.35 TB/s.
// The first K1 ran one thread per window over its k bases (~6k integer
// instructions a window, two 64-bit shift-ors and a byte load per base),
// which bounded it at ~7x the bytes.  This design does a constant number
// of instructions per window:
//   - a block takes a tile of kTile start positions of the flat code
//     stream and packs its bytes (16-byte vector loads) into 2-bit words
//     and an N bit mask in shared memory (packed_window.cuh);
//   - the forward value is one three-word funnel extract; the reverse
//     complement is the same 32 bases reversed by pairs (__brev of each
//     half, a pair swap) and complemented, the N test a two-word funnel
//     of the mask;
//   - thread t walks positions t, t + kThreads, .. of the tile, carrying
//     (read, column) by adds (for_each_window): one 64-bit division per
//     tile, none per window;
//   - thread i of a tile's window run writes keys[i]: stores coalesced.
// k is odd, so a k-mer never equals its reverse complement and the min
// has no ties.

#include <cstdint>

#include <cuda_runtime.h>

#include "packed_window.cuh"

namespace {

using namespace kdf_packed;

constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;

// kStage cuts the kernel for timing probes (the counterpart of the stage
// kernels of scripts/x_join_variants.py:_make_extract_stage, :1449):
// 0 loads and packs the tile and stores, per window, the XOR of the three
// packed words it reads; 1 the forward extract (stores it); 2 adds the
// reverse complement (stores fwd ^ rc); 3 the canonical minimum; 4 the
// N-in-window mask; 5 the read-length test: the full K1, the only
// instantiation the engine uses.
template <int kStage>
__global__ void __launch_bounds__(kThreads)
    extract_canonical_kernel(const uint8_t* __restrict__ codes,
                             const int32_t* __restrict__ lengths,
                             long long* __restrict__ keys, int n_reads,
                             int length, int k) {
  __shared__ Packed sm;
  __shared__ Tile tile;
  const int s = length - k + 1;
  const long long total = static_cast<long long>(n_reads) * length;
  if (threadIdx.x == 0) tile = make_tile(codes, total, length, s, k);
  __syncthreads();
  load_tile(codes, total, tile, sm);
  __syncthreads();

  const int head = tile.head;
  for_each_window(tile, length, s, [&](int q, int read, unsigned col) {
    const int u = q + head;
    long long out;
    if (kStage == 0) {
      const int m = u >> 4;
      out = static_cast<long long>(sm.codes[m] ^ sm.codes[m + 1] ^
                                   sm.codes[m + 2]);
    } else {
      const uint64_t win = window64(sm.codes, u);
      const uint64_t fwd = forward_bases(win, k);
      uint64_t key = fwd;
      if (kStage >= 2) {
        const uint64_t rc = reverse_complement(win, k);
        key = kStage == 2 ? fwd ^ rc : (fwd < rc ? fwd : rc);
      }
      bool bad = kStage >= 4 && any_n_short(sm.nmask, u, k);
      if (kStage >= 5) bad |= static_cast<int>(col) + k > lengths[read];
      out = bad ? kSentinel : static_cast<long long>(key);
    }
    keys[static_cast<long long>(read) * s + col] = out;
  });
}

template <int kStage>
int launch_extract(const void* codes, const void* lengths, void* keys,
                   int n_reads, int length, int k, void* stream) {
  const long long total = static_cast<long long>(n_reads) * length;
  const long long blocks = (total + kTile - 1) / kTile;
  extract_canonical_kernel<kStage>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(codes),
          static_cast<const int32_t*>(lengths), static_cast<long long*>(keys),
          n_reads, length, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 cut at stage 0..5 (see extract_canonical_kernel); the engine passes
// 5, the full K1.  cudaErrorInvalidValue for a k outside 1..31.
extern "C" int kdf_extract_canonical(const void* codes, const void* lengths,
                                     void* keys, int n_reads, int length,
                                     int k, int stage, void* stream) {
  if (k < 1 || k > 31) return static_cast<int>(cudaErrorInvalidValue);
  switch (stage) {
    case 0: return launch_extract<0>(codes, lengths, keys, n_reads, length, k, stream);
    case 1: return launch_extract<1>(codes, lengths, keys, n_reads, length, k, stream);
    case 2: return launch_extract<2>(codes, lengths, keys, n_reads, length, k, stream);
    case 3: return launch_extract<3>(codes, lengths, keys, n_reads, length, k, stream);
    case 4: return launch_extract<4>(codes, lengths, keys, n_reads, length, k, stream);
    case 5: return launch_extract<5>(codes, lengths, keys, n_reads, length, k, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
