// Kernel kdf_build_directory: the prefix directory of a narrow sorted
// table (sorted_table.cuh), which kernels K2 and K4 search through.
//
// No TPU kernel computes it: the reference builds its bucket offsets on
// the host (kmer_denovo_filter_tpu/ops/device.py:572,
// build_bucket_offsets, by bincount and cumsum over word 0's top bits)
// for its XLA lookup_bucketed.  Here the directory is built on the card,
// once per table (KmerIndex), from the table's live rows: one thread a
// row writes dir[p] for the prefixes p after its predecessor's up to its
// own, and threads past the last row fill the tail with `live`.  Every
// entry is written exactly once; no atomics, no sort.
//
// In:  table (M,) int64 sorted, its `live` rows before the trailing
//      INT64_MAX rows; bits, shift with table[live - 1] >> shift <
//      2^bits.
// Out: dir (2^bits + 1,) int32.
//
// Bound: by bytes, 8 B read a live row and 4 B written an entry (1-2
// entries a row, ~0.25 past 2^22 rows): ~0.045 ms at 2^24 rows.  A thread
// whose row opens a long gap (a sparse stretch of keys) writes the gap
// alone; uniform and real tables have gaps of a few entries.

#include <cuda_runtime.h>

#include "sorted_table.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void build_directory_kernel(const long long* __restrict__ table,
                                       int live, int bits, int shift,
                                       int* __restrict__ dir) {
  kdf::fill_directory(
      table, live, shift, bits, dir,
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
      static_cast<long long>(gridDim.x) * blockDim.x);
}

}  // namespace

extern "C" int kdf_build_directory(const void* table, int live, int bits,
                                   int shift, void* dir, void* stream) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = live + (1LL << bits) + 1;
  const long long need = (items + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  build_directory_kernel<<<static_cast<unsigned>(need < cap ? need : cap),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), live, bits, shift,
      static_cast<int*>(dir));
  return static_cast<int>(cudaGetLastError());
}
