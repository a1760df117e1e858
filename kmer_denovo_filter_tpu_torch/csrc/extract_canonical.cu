// Kernel K1: canonical k-mer window extraction for the parent scan.
//
// Replaces the Pallas TPU kernel
// kmer_denovo_filter_tpu/ops/pallas_extract.py:_extract_mix_kernel (:54),
// without its Feistel route mix: the mix exists to order keys for the
// TPU's partition routing, and the int64 keys here need none.
//
// In:  codes (B, L) uint8, 2-bit bases with 4 = N/padding; lengths (B,)
//      int32; k odd in 3..31.
// Out: keys (B, S = L - k + 1) int64, right-aligned 2-bit big-endian
//      k-mer value min(forward, reverse complement); INT64_MAX where the
//      window holds a code >= 4 or runs past the read's length.
//
// One thread per window loops over its k bases, building the forward
// value by shift-in from the right and the reverse complement by placing
// (3 - base) at bit 2j.  k is odd, so a k-mer never equals its reverse
// complement and the min has no ties.
//
// Bound: by bytes it is write-bound — each window writes 8 bytes and
// reads one new byte of codes (the k - 1 bases it shares with its
// neighbours come from L1, since neighbouring threads read neighbouring
// windows of the same read).  The design keeps the write fully coalesced
// (thread i writes keys[i]) and does no other global traffic.  At 4.0M
// windows the 37 MB move in ~11 us at 3.35 TB/s, but on an H100 SXM
// (700 W) the kernel takes ~0.08 ms: the per-window k-step loop of 64-bit
// shifts (~k * 6 integer instructions per window) bounds it, not the
// writes.  A rolling forward/reverse value per thread over several
// windows would cut that k-fold.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kThreads = 256;

// kStage cuts the kernel for timing probes (the counterpart of the stage
// kernels of scripts/x_join_variants.py:_make_extract_stage, :1449):
// 0 loads the window's codes and stores their XOR, 1 adds the forward
// roll (stores it), 2 the reverse-complement roll (stores fwd ^ rc), 3
// the canonical minimum, 4 the N-in-window mask, 5 the read-length test:
// the full K1, the only instantiation the engine uses.
template <int kStage>
__global__ void extract_canonical_kernel(const uint8_t* __restrict__ codes,
                                         const int32_t* __restrict__ lengths,
                                         long long* __restrict__ keys,
                                         int n_reads, int length, int k) {
  const int s = length - k + 1;
  const long long n = static_cast<long long>(n_reads) * s;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int read = static_cast<int>(i / s);
  const int start = static_cast<int>(i - static_cast<long long>(read) * s);
  const uint8_t* window =
      codes + static_cast<long long>(read) * length + start;
  bool bad = kStage >= 5 && start + k > lengths[read];
  unsigned long long fwd = 0;
  unsigned long long rc = 0;
  for (int j = 0; j < k; ++j) {
    const unsigned code = window[j];
    if (kStage == 0) {
      fwd ^= code;
      continue;
    }
    bad |= code >= 4u;
    const unsigned long long base = code & 3u;
    fwd = (fwd << 2) | base;
    if (kStage >= 2) rc |= (3ull - base) << (2 * j);
  }
  const unsigned long long canonical = fwd < rc ? fwd : rc;
  if (kStage <= 1) {
    keys[i] = static_cast<long long>(fwd);
  } else if (kStage == 2) {
    keys[i] = static_cast<long long>(fwd ^ rc);
  } else if (kStage == 3) {
    keys[i] = static_cast<long long>(canonical);
  } else {
    keys[i] = bad ? kSentinel : static_cast<long long>(canonical);
  }
}

template <int kStage>
int launch_extract(const void* codes, const void* lengths, void* keys,
                   int n_reads, int length, int k, void* stream) {
  const long long n = static_cast<long long>(n_reads) * (length - k + 1);
  const long long blocks = (n + kThreads - 1) / kThreads;
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
// 5, the full K1.
extern "C" int kdf_extract_canonical(const void* codes, const void* lengths,
                                     void* keys, int n_reads, int length,
                                     int k, int stage, void* stream) {
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
