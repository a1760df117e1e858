// Kernel kdf_build_directory: the prefix directory of a sorted table
// (sorted_table.cuh), which kernels K2 and K4 (narrow keys) and K7 and K8
// (wide rows, by limb 0; sorted_rows.cuh) search through.
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
// In:  table (M,) int64 sorted, or (M, Q) int64 limb rows sorted row-
//      lexicographically (row_stride = Q; the key is limb 0, so the
//      directory buckets the rows by their first 31 bases); its `live`
//      rows before the trailing sentinel rows; bits, shift with
//      limb 0 of row live - 1 >> shift < 2^bits.
// Out: dir (2^bits + 1,) int32.
//
// Bound: by bytes, 8 B read a live row and 4 B written an entry (1-2
// entries a row, ~0.25 past 2^22 rows): ~0.045 ms at 2^24 rows (a wide
// table's limb 0 is one 8-byte word of each 8Q-byte row, so its reads
// touch a sector a row).  A thread whose row opens a long gap (a sparse
// stretch of keys) writes the gap alone; uniform and real tables have
// gaps of a few entries.

#include <cuda_runtime.h>

#include "sorted_table.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void build_directory_kernel(const long long* __restrict__ table,
                                       long long row_stride, int live,
                                       int bits, int shift,
                                       int* __restrict__ dir) {
  kdf::fill_directory(
      table, row_stride, live, shift, bits, dir,
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
      static_cast<long long>(gridDim.x) * blockDim.x);
}

}  // namespace

extern "C" int kdf_build_directory(const void* table, int row_stride,
                                   int live, int bits, int shift, void* dir,
                                   void* stream) {
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
      static_cast<const long long*>(table), row_stride, live, bits, shift,
      static_cast<int*>(dir));
  return static_cast<int>(cudaGetLastError());
}

// The launch plan kdf_probe_tally (counts = 1) or kdf_probe_member
// (counts = 0) takes for n keys of a table with `live` rows and a
// directory of `bits` on the current device, under the launch override
// (form, threads, blocks_per_sm; all 0: the plan): out[0..4] = staged,
// blocks, threads, dynamic shared bytes, the staged budget.  Launches
// nothing.
extern "C" int kdf_dir_probe_plan(long long n, int live, int bits,
                                  int counts, int form, int threads,
                                  int blocks_per_sm, long long* out) {
  kdf::DirLaunch launch;
  const cudaError_t err = kdf::dir_probe_launch(
      n, live, bits, counts != 0, {form, threads, blocks_per_sm}, &launch);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = launch.staged ? 1 : 0;
  out[1] = launch.blocks;
  out[2] = launch.threads;
  out[3] = static_cast<long long>(launch.smem);
  out[4] = static_cast<long long>(launch.budget);
  return 0;
}
