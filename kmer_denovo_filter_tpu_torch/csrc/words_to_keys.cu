// Kernel K11: a table's uint32 key words to the port's int64 keys, on
// the card (ops/convert.py).
//
// No TPU kernel computes it: the JAX package keeps its keys as the
// (M, W) uint32 words (kmer_denovo_filter_tpu/ops/encode.py) and sends
// them to the device as they are.  The port carries a key as Q =
// ceil(k / 31) int64 limbs (ops/keys.py); its numpy conversion
// (keys.words_to_keys64, keys.words_to_limbs) ran on the host for every
// table the engine built.  Here the words go up as they are, 4W bytes a
// key, and one thread a row makes its limbs: limb j is the 2 n_j-bit
// field at bit 62 j of the key's bit string, a 64-bit window over words
// i and i + 1 (i = 62 j / 32) funnelled with word i + 2, shifted down
// (the arithmetic of keys.words_to_limbs).  A row of all-ones words (the
// JAX sentinel) becomes a row of INT64_MAX.
//
// In:  words (M, W) uint32, rows of W = ceil(k / 16) words, 4-byte
//      aligned (a view at any word offset); k odd, 1..207.
// Out: keys (M, Q) int64 (Q = 1: flat (M,) keys).
//
// Bound: by bytes, 4W B read and 8Q B written a row: 16 B a key at
// k = 31, ~0.080 ms for 2^24 keys.  A warp's rows are contiguous, so
// its strided word loads and limb stores fill whole sectors between
// them.  W is a template parameter, so a row's words sit in registers.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxQ = 7;

template <int W>
__global__ void __launch_bounds__(kThreads)
    words_to_keys_kernel(const unsigned* __restrict__ words, long long m,
                         int k, int q, long long* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long row = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       row < m; row += stride) {
    unsigned long long w[W + 2];
    bool sentinel = true;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      w[i] = words[row * W + i];
      sentinel = sentinel && w[i] == 0xFFFFFFFFull;
    }
    w[W] = 0;
    w[W + 1] = 0;
    long long* dst = out + row * q;
#pragma unroll
    for (int j = 0; j < kMaxQ; ++j) {
      if (j >= q) break;
      constexpr int kBits = 62;
      const int start = kBits * j;
      const int i = start / 32;
      const int off = start % 32;
      if (i >= W) break;
      const int nb = j < q - 1 ? 31 : k - 31 * (q - 1);
      unsigned long long window = (w[i] << 32) | w[i + 1];
      if (off) window = (window << off) | (w[i + 2] >> (32 - off));
      dst[j] = sentinel ? LLONG_MAX
                        : static_cast<long long>(window >> (64 - 2 * nb));
    }
  }
}

template <int W>
cudaError_t launch(const unsigned* words, long long m, int k, int q,
                   long long* out, cudaStream_t stream) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return err;
  const long long need = (m + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  words_to_keys_kernel<W><<<static_cast<unsigned>(need < cap ? need : cap),
                            kThreads, 0, stream>>>(words, m, k, q, out);
  return cudaGetLastError();
}

}  // namespace

// K11 over m rows of w words at k (q limbs a row) on `stream`; m >= 1.
extern "C" int kdf_words_to_keys(const void* words, long long m, int w,
                                 int k, int q, void* keys, void* stream) {
  const auto* in = static_cast<const unsigned*>(words);
  auto* out = static_cast<long long*>(keys);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || q < 1 || q > kMaxQ || k < 1 || k > 31 * q) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (w) {
    case 1: return static_cast<int>(launch<1>(in, m, k, q, out, s));
    case 2: return static_cast<int>(launch<2>(in, m, k, q, out, s));
    case 3: return static_cast<int>(launch<3>(in, m, k, q, out, s));
    case 4: return static_cast<int>(launch<4>(in, m, k, q, out, s));
    case 5: return static_cast<int>(launch<5>(in, m, k, q, out, s));
    case 6: return static_cast<int>(launch<6>(in, m, k, q, out, s));
    case 7: return static_cast<int>(launch<7>(in, m, k, q, out, s));
    case 8: return static_cast<int>(launch<8>(in, m, k, q, out, s));
    case 9: return static_cast<int>(launch<9>(in, m, k, q, out, s));
    case 10: return static_cast<int>(launch<10>(in, m, k, q, out, s));
    case 11: return static_cast<int>(launch<11>(in, m, k, q, out, s));
    case 12: return static_cast<int>(launch<12>(in, m, k, q, out, s));
    case 13: return static_cast<int>(launch<13>(in, m, k, q, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
