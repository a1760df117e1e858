// Kernel K1w: canonical window extraction for wide keys (k = 33..207).
//
// The JAX package has no TPU kernel here: it extracts wide windows in XLA
// (kmer_denovo_filter_tpu/ops/device.py:extract_canonical_windows, its
// W >= 3 branch, via pallas_join.extract_flat_keys :2195).  K1w is the
// wide counterpart of K1 (extract_canonical.cu) on the wide path.
//
// In:  codes (B, L) uint8, 2-bit bases with 4 = N/padding; lengths (B,)
//      int32; k odd in 33..207.
// Out: keys (B, S = L - k + 1, Q) int64, Q = ceil(k / 31) limbs (ops/
//      keys.py): limb j holds bases 31j .. 31j + n_j - 1 right-aligned,
//      and the key is the lexicographic min of the forward and the
//      reverse-complement limb rows; a row of INT64_MAX where the window
//      holds a code >= 4 or runs past the read's length.
//
// One thread per window.  For each limb j (unrolled, Q a template
// parameter, so the 2Q limbs stay in registers) it shifts in the forward
// bases 31j + t and the complemented bases k - 1 - 31j - t: reverse
// complement base i is 3 - base[k - 1 - i], so both strands use the same
// limb boundaries.  k is odd, so the strands never tie.
//
// Bound: by bytes, each window reads one new byte of codes (its k - 1
// others come from L1, read by neighbouring threads) and writes 8Q bytes;
// 4.0M windows at Q = 3 move ~100 MB, ~30 us at 3.35 TB/s.  The writes
// are only partly coalesced: thread i writes Q consecutive int64, so a
// warp's stores stride 8Q bytes.  The k-step loops (two byte loads, two
// 64-bit shift-ors per base, 2k per window) bound the kernel, as K1's
// k-step loop bounds it at k = 31; at k = 201 the loop is 6.5x K1's.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kThreads = 256;
constexpr int kBasesPerLimb = 31;

template <int Q>
__global__ void extract_wide_kernel(const uint8_t* __restrict__ codes,
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
  bool bad = start + k > lengths[read];
  const int last = k - kBasesPerLimb * (Q - 1);
  unsigned long long fwd[Q];
  unsigned long long rc[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int nb = j < Q - 1 ? kBasesPerLimb : last;
    const uint8_t* f_bases = window + kBasesPerLimb * j;
    const uint8_t* r_bases = window + (k - 1 - kBasesPerLimb * j);
    unsigned long long f = 0;
    unsigned long long r = 0;
    for (int t = 0; t < nb; ++t) {
      const unsigned code = f_bases[t];
      bad |= code >= 4u;
      f = (f << 2) | (code & 3u);
      r = (r << 2) | (3u - (r_bases[-t] & 3u));
    }
    fwd[j] = f;
    rc[j] = r;
  }
  int order = 0;  // -1: forward smaller, 1: reverse complement smaller
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (order == 0 && fwd[j] != rc[j]) order = fwd[j] < rc[j] ? -1 : 1;
  }
  long long* out = keys + i * Q;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    out[j] = bad ? kSentinel
                 : static_cast<long long>(order <= 0 ? fwd[j] : rc[j]);
  }
}

template <int Q>
int launch(const void* codes, const void* lengths, void* keys, int n_reads,
           int length, int k, cudaStream_t stream) {
  const long long n = static_cast<long long>(n_reads) * (length - k + 1);
  const long long blocks = (n + kThreads - 1) / kThreads;
  extract_wide_kernel<Q><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(lengths), static_cast<long long*>(keys),
      n_reads, length, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a CUDA error code, or cudaErrorInvalidValue for a k whose limb
// count is outside 2..7.
extern "C" int kdf_extract_canonical_wide(const void* codes,
                                          const void* lengths, void* keys,
                                          int n_reads, int length, int k,
                                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
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
