// A block's tile of the flat code stream, packed into 2-bit words in
// shared memory: the common front of K1 (extract_canonical.cu) and K1w
// (extract_wide.cu).
//
// The (B, L) codes are one flat stream of B * L bytes; window (read r,
// start c) begins at byte r * L + c, and is a window when c < S = L - k + 1.
// Block b takes the kTile start positions [b * kTile, (b + 1) * kTile) of
// that stream, whatever reads they fall in, so a tile's bytes are bounded
// (kTile + k - 1) however long or short the reads are: one (1, 2^20) row
// gives 512 tiles, a k = 151 batch of 152 bp reads ~27 windows a tile.
//
// Loading: thread t reads 16-byte chunks t, t + kThreads, .. of the
// tile's bytes, with one 16-byte vector load where the chunk lies inside
// the stream and byte loads at its head and tail.  A chunk's frame is the
// stream's address rounded down to 16 bytes, so every vector load is
// aligned whatever the tensor's storage offset.  Each chunk becomes
//   codes[c]: its 16 bases as 2 bits each, first base in bits 31:30 (the
//             big-endian order of ops/keys.py), and
//   nmask:    16 bits, set for a code >= 4 (N or padding), first base in
//             the high bit; two chunks make one 32-bit mask word.
//
// Walk: for_each_window hands each thread the windows among positions t,
// t + kThreads, .. of the tile with their (read, column), carried by adds.
//
// Extraction, O(1) per up-to-31-base limb, no loop over bases:
//   window64(u)  bases u .. u + 31 left-aligned: two 32-bit funnel shifts
//                over three packed words (an offset of 0 is a shift by 0,
//                never by 32 or 64);
//   forward      window64(u) >> (64 - 2n): n bases right-aligned;
//   reverse      the reverse complement of bases u .. u + n - 1:
//   complement   window64(u) reversed (__brev of each half, the halves
//                swapped), the bits of each pair swapped back, then
//                complemented and cut to the low 2n bits (base u lands
//                in the bottom pair);
//   N test       a funnel over two mask words (k <= 31) or an OR over
//                the <= 8 words the k bits span (k <= 207).
// n <= 31 everywhere (a limb holds at most 31 bases), so no shift or mask
// reaches 64 bits.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace kdf_packed {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // window start positions per block
constexpr int kMaxK = 207;
// chunks a tile can need: its head offset (< 16), kTile positions, k - 1
// more bases, rounded up, plus two chunks of slack for the three-word
// funnel; even, so the 16-bit mask halves fill whole 32-bit words
constexpr int kChunks = ((15 + kTile + kMaxK - 1 + 15) / 16 + 2 + 1) & ~1;

struct Packed {
  uint32_t codes[kChunks];
  uint32_t nmask[kChunks / 2];
};

struct Tile {
  long long first;     // flat window index of the tile's first window
  int read0;           // read of the tile's first position
  int col0;            // column of the tile's first position
  int n_pos;           // positions in the tile (kTile, less in the last)
  int n_windows;       // windows among them
  int head;            // frame offset of the first position (0..15)
  long long chunk0;    // stream byte of chunk 0 (first position - head)
  int n_chunks;        // chunks to load
};

// One thread's work: the block's tile, with one 64-bit division for its
// first read and one for its end.
__device__ inline Tile make_tile(const uint8_t* codes, long long total,
                                 int length, int s, int k) {
  Tile t;
  const long long p0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long left = total - p0;
  t.n_pos = static_cast<int>(left < kTile ? left : kTile);
  t.read0 = static_cast<int>(p0 / length);
  t.col0 = static_cast<int>(p0 - static_cast<long long>(t.read0) * length);
  t.first = static_cast<long long>(t.read0) * s + (t.col0 < s ? t.col0 : s);
  const long long p1 = p0 + t.n_pos;
  const long long read1 = p1 / length;
  const int col1 = static_cast<int>(p1 - read1 * length);
  t.n_windows = static_cast<int>(read1 * s + (col1 < s ? col1 : s) - t.first);
  const int misalign =
      static_cast<int>(reinterpret_cast<uintptr_t>(codes) & 15);
  t.head = static_cast<int>((p0 + misalign) & 15);
  t.chunk0 = p0 - t.head;
  const int n = (t.head + t.n_pos + k - 1 + 15) / 16 + 2;
  t.n_chunks = n < kChunks ? n : kChunks;
  return t;
}

// Calls fn(q, read, col) for each window among the tile's positions
// q = threadIdx.x, threadIdx.x + kThreads, .. (those with col < s),
// carrying (read, column) by adds from the tile's first position: no
// division per position.
template <typename Fn>
__device__ __forceinline__ void for_each_window(const Tile& t, int length,
                                                int s, Fn fn) {
  const int n_pos = t.n_pos;
  unsigned col = static_cast<unsigned>(t.col0) + threadIdx.x;
  int read = t.read0 + static_cast<int>(col / length);
  col %= length;
  const int step_read = kThreads / length;
  const unsigned step_col = kThreads % length;
  for (int q = threadIdx.x; q < n_pos; q += kThreads) {
    if (col < static_cast<unsigned>(s)) fn(q, read, col);
    col += step_col;
    read += step_read;
    if (col >= static_cast<unsigned>(length)) {
      col -= length;
      ++read;
    }
  }
}

// 4 codes (one little-endian word, first base in the low byte) → their
// 2-bit bases, first base in bits 7:6.
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  const uint32_t b = x & 0x03030303u;
  return ((b << 6) & 0xC0u) | ((b >> 4) & 0x30u) | ((b >> 14) & 0x0Cu) |
         ((b >> 24) & 0x03u);
}

// 4 codes → 4 N bits (code >= 4), first base in bit 3.
__device__ __forceinline__ uint32_t n4(uint32_t x) {
  const uint32_t m = __vcmpgeu4(x, 0x04040404u);
  return ((m >> 4) & 8u) | ((m >> 13) & 4u) | ((m >> 22) & 2u) | (m >> 31);
}

// Every thread of the block: load and pack the tile's chunks.
__device__ inline void load_tile(const uint8_t* __restrict__ codes,
                                 long long total, const Tile& t, Packed& sm) {
  auto* half = reinterpret_cast<uint16_t*>(sm.nmask);
  for (int c = threadIdx.x; c < t.n_chunks; c += kThreads) {
    const long long g = t.chunk0 + 16LL * c;
    uint32_t bases = 0;
    uint32_t ns = 0;
    if (g >= 0 && g + 16 <= total) {
      const uint4 v = *reinterpret_cast<const uint4*>(codes + g);
      bases = (pack4(v.x) << 24) | (pack4(v.y) << 16) | (pack4(v.z) << 8) |
              pack4(v.w);
      ns = (n4(v.x) << 12) | (n4(v.y) << 8) | (n4(v.z) << 4) | n4(v.w);
    } else {
      for (int b = 0; b < 16; ++b) {
        const long long gb = g + b;
        const uint32_t code = gb >= 0 && gb < total ? codes[gb] : 4u;
        bases |= (code & 3u) << (30 - 2 * b);
        ns |= static_cast<uint32_t>(code >= 4u) << (15 - b);
      }
    }
    sm.codes[c] = bases;
    half[c ^ 1] = static_cast<uint16_t>(ns);  // high half first (LE)
  }
}

// Bases u .. u + 31 of the tile's frame, left-aligned (base u in bits
// 63:62).
__device__ __forceinline__ uint64_t window64(const uint32_t* pk, int u) {
  const int m = u >> 4;
  const int off = 2 * (u & 15);  // 0..30
  const uint32_t w0 = pk[m], w1 = pk[m + 1], w2 = pk[m + 2];
  const uint32_t hi = __funnelshift_l(w1, w0, off);
  const uint32_t lo = __funnelshift_l(w2, w1, off);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// The first n (1..31) bases of a left-aligned window, right-aligned.
__device__ __forceinline__ uint64_t forward_bases(uint64_t win, int n) {
  return win >> (64 - 2 * n);
}

// The two bits of each pair swapped.
__device__ __forceinline__ uint32_t swap_pairs(uint32_t x) {
  return ((x >> 1) & 0x55555555u) | ((x << 1) & 0xAAAAAAAAu);
}

// The reverse complement of the first n (1..31) bases of a left-aligned
// window, right-aligned: base u's complement in the bottom pair.  The
// 64-bit reversal is each half reversed (__brev) and the halves swapped;
// no pair straddles the halves, so the pair swap works on 32 bits.
__device__ __forceinline__ uint64_t reverse_complement(uint64_t win, int n) {
  const uint32_t hi = swap_pairs(__brev(static_cast<uint32_t>(win)));
  const uint32_t lo = swap_pairs(__brev(static_cast<uint32_t>(win >> 32)));
  return ~((static_cast<uint64_t>(hi) << 32) | lo) & ((1ull << (2 * n)) - 1);
}

// Whether bases u .. u + k - 1 (k <= 31) hold a code >= 4.
__device__ __forceinline__ bool any_n_short(const uint32_t* nm, int u,
                                            int k) {
  const int m = u >> 5;
  const uint32_t x = __funnelshift_l(nm[m + 1], nm[m], u & 31);
  return (x >> (32 - k)) != 0;
}

// Whether bases u .. u + k - 1 (any k) hold a code >= 4.
__device__ __forceinline__ bool any_n(const uint32_t* nm, int u, int k) {
  const int end = u + k - 1;
  const int first = u >> 5;
  const int last = end >> 5;
  const uint32_t head = 0xFFFFFFFFu >> (u & 31);           // bases >= u
  const uint32_t tail = 0xFFFFFFFFu << (31 - (end & 31));  // bases <= end
  if (first == last) return (nm[first] & head & tail) != 0;
  uint32_t any = (nm[first] & head) | (nm[last] & tail);
  for (int m = first + 1; m < last; ++m) any |= nm[m];
  return any != 0;
}

}  // namespace kdf_packed
