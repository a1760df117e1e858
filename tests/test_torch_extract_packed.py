"""A CPU model of kernels K1 and K1w's packed-word arithmetic
(``csrc/packed_window.cuh``, ``extract_canonical.cu``,
``extract_wide.cu``), held against the port's plain versions and the JAX
package's XLA extract.  Integer outputs, exact equality.

The CUDA kernels run only on the card; this file transcribes their steps
in numpy, step for step, so the bit arithmetic is proven on the CPU:
the tile of start positions and its (read, column) walk by adds, the
16-byte chunk loads (vector path inside the stream, byte path at its
edges, frames aligned to the stream's address), the 2-bit words and N
bits, the three-word funnel extract (offset 0 included), the reverse
complement by ``__brev`` of each half and a pair swap, both N tests,
the orientation pass and the coalesced limb pass.  Shared memory starts
as random garbage, so a bit the kernels read but never loaded would
show, and every shift is asserted below its word width.  The model is
on no path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu.ops import device as jdev
from kmer_denovo_filter_tpu.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64

K_TILE, K_THREADS = 2048, 256  # csrc/packed_window.cuh
MAX_K = 207
BASES_PER_LIMB = 31
U64 = np.uint64
SENTINEL = np.int64(keys64.SENTINEL)
M32 = U64(0xFFFFFFFF)
_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def n_chunks_cap(tile):
    """``kChunks`` for a tile of *tile* positions."""
    return ((15 + tile + MAX_K - 1 + 15) // 16 + 2 + 1) & ~1


def shl(x, s, width=64):
    s = np.asarray(s, dtype=U64)
    assert (s < width).all(), "shift reaches the word width"
    out = np.asarray(x, dtype=U64) << s
    return out & M32 if width == 32 else out


def shr(x, s, width=64):
    s = np.asarray(s, dtype=U64)
    assert (s < width).all(), "shift reaches the word width"
    return np.asarray(x, dtype=U64) >> s


def funnelshift_l(lo, hi, shift):
    """CUDA ``__funnelshift_l``: the high 32 bits of (hi:lo) << (shift &
    31), on uint32 values held in uint64."""
    both = shl(hi, 32) | np.asarray(lo, dtype=U64)
    return shr(shl(both, np.asarray(shift) & 31), 32)


def brev32(x):
    """CUDA ``__brev`` on uint32 values held in uint64."""
    b = np.ascontiguousarray(x, dtype="<u4").view(np.uint8).reshape(-1, 4)
    return np.ascontiguousarray(_REV8[b][:, ::-1]).view("<u4").reshape(
        np.shape(x)).astype(U64)


def vcmpgeu4(x, y):
    """CUDA ``__vcmpgeu4``: 0xFF in each byte of *x* >= that of *y*."""
    out = np.zeros_like(x, dtype=U64)
    for i in range(4):
        xb = shr(x, 8 * i) & U64(0xFF)
        yb = (y >> (8 * i)) & 0xFF
        out |= shl(np.where(xb >= yb, U64(0xFF), U64(0)), 8 * i)
    return out


def pack4(x):
    b = x & U64(0x03030303)
    return ((shl(b, 6) & U64(0xC0)) | (shr(b, 4) & U64(0x30))
            | (shr(b, 14) & U64(0x0C)) | (shr(b, 24) & U64(0x03)))


def n4(x):
    m = vcmpgeu4(x, 0x04040404)
    return ((shr(m, 4) & U64(8)) | (shr(m, 13) & U64(4))
            | (shr(m, 22) & U64(2)) | shr(m, 31))


def make_tile(block, total, length, s, k, misalign, tile):
    p0 = block * tile
    n_pos = min(tile, total - p0)
    read0, col0 = divmod(p0, length)
    first = read0 * s + min(col0, s)
    read1, col1 = divmod(p0 + n_pos, length)
    head = (p0 + misalign) & 15
    n_chunks = min((head + n_pos + k - 1 + 15) // 16 + 2, n_chunks_cap(tile))
    return dict(read0=read0, col0=col0, n_pos=n_pos, first=first,
                n_windows=read1 * s + min(col1, s) - first, head=head,
                chunk0=p0 - head, n_chunks=n_chunks)


def load_tile(flat, t, tile, rng, misalign):
    """The tile's packed words and N mask words (uint32 in uint64), over
    shared memory that starts as garbage.  *misalign* is the stream's
    address mod 16: every vector load must be aligned."""
    cap = n_chunks_cap(tile)
    codes = rng.integers(0, 1 << 32, cap, dtype=np.uint64)
    half = rng.integers(0, 1 << 16, cap, dtype=np.uint16)
    total = flat.size
    c = np.arange(t["n_chunks"])
    g = t["chunk0"] + 16 * c
    inside = (g >= 0) & (g + 16 <= total)
    assert ((misalign + g[inside]) % 16 == 0).all(), "unaligned vector load"
    bases = np.zeros(c.size, U64)
    ns = np.zeros(c.size, U64)
    # vector path: four little-endian words, first base in the low byte
    idx = g[inside, None] + np.arange(16)
    v = np.ascontiguousarray(flat[idx]).view("<u4").astype(U64)  # (n, 4)
    bases[inside] = (shl(pack4(v[:, 0]), 24) | shl(pack4(v[:, 1]), 16)
                     | shl(pack4(v[:, 2]), 8) | pack4(v[:, 3]))
    ns[inside] = (shl(n4(v[:, 0]), 12) | shl(n4(v[:, 1]), 8)
                  | shl(n4(v[:, 2]), 4) | n4(v[:, 3]))
    # byte path at the stream's edges
    gb = g[~inside, None] + np.arange(16)
    ok = (gb >= 0) & (gb < total)
    code = np.where(ok, flat[np.clip(gb, 0, total - 1)], 4).astype(U64)
    b = np.arange(16)
    bases[~inside] = np.bitwise_or.reduce(
        shl(code & U64(3), 30 - 2 * b, 32), axis=1)
    ns[~inside] = np.bitwise_or.reduce(
        shl((code >= 4).astype(U64), 15 - b, 32), axis=1)
    codes[c] = bases
    half[c ^ 1] = ns.astype(np.uint16)  # high half first (little-endian)
    return codes, half.view("<u4").astype(U64)


def read_words(words, idx, cap):
    assert (idx >= 0).all() and (idx < cap).all(), "read past shared memory"
    return words[idx]


def window64(pk, u):
    m = u >> 4
    off = 2 * (u & 15)
    w0, w1, w2 = (read_words(pk, m + i, pk.size) for i in range(3))
    hi = funnelshift_l(w1, w0, off)
    lo = funnelshift_l(w2, w1, off)
    return shl(hi, 32) | lo


def forward_bases(win, n):
    return shr(win, 64 - 2 * np.asarray(n))


def swap_pairs(x):
    return (shr(x, 1, 32) & U64(0x55555555)) | (shl(x, 1, 32)
                                                 & U64(0xAAAAAAAA))


def reverse_complement(win, n):
    hi = swap_pairs(brev32(win & M32))
    lo = swap_pairs(brev32(shr(win, 32)))
    return ~(shl(hi, 32) | lo) & (shl(U64(1), 2 * np.asarray(n)) - U64(1))


def any_n_short(nm, u, k):
    m = u >> 5
    x = funnelshift_l(read_words(nm, m + 1, nm.size),
                      read_words(nm, m, nm.size), u & 31)
    return shr(x, 32 - k) != 0


def any_n(nm, u, k):
    end = u + k - 1
    first, last = u >> 5, end >> 5
    head = shr(M32, u & 31)
    tail = shl(M32, 31 - (end & 31), 32)
    any_ = np.where(first == last,
                    read_words(nm, first, nm.size) & head & tail,
                    (read_words(nm, first, nm.size) & head)
                    | (read_words(nm, last, nm.size) & tail))
    for step in range(1, (k + 31) // 32 + 1):  # the words strictly between
        m = first + step
        mid = m < last
        any_ |= np.where(mid, read_words(nm, np.where(mid, m, first),
                                         nm.size), U64(0))
    return any_ != 0


def walk(t, length, s, threads):
    """The (q, read, column) of each window position a thread visits,
    stepped by adds as ``for_each_window`` does; yields one array triple
    per turn of the threads' loop."""
    th = np.arange(threads)
    col = t["col0"] + th
    read = t["read0"] + col // length
    col = col % length
    step_read, step_col = threads // length, threads % length
    for q0 in range(0, t["n_pos"], threads):
        q = q0 + th
        act = (q < t["n_pos"]) & (col < s)
        yield q[act], read[act], col[act]
        col = col + step_col
        read = read + step_read
        wrap = col >= length
        col[wrap] -= length
        read[wrap] += 1


def model_k1(codes, lengths, k, misalign=0, tile=K_TILE, threads=K_THREADS,
             seed=0):
    """K1 (stage 5) over (B, L) codes: (B, S) int64 keys."""
    rng = np.random.default_rng(seed)
    b, length = codes.shape
    s = length - k + 1
    flat = np.ascontiguousarray(codes).reshape(-1)
    keys = np.zeros(b * s, np.int64)
    seen = np.zeros(b * s, np.int64)
    for block in range(-(-flat.size // tile)):
        t = make_tile(block, flat.size, length, s, k, misalign, tile)
        pk, nm = load_tile(flat, t, tile, rng, misalign)
        for q, read, col in walk(t, length, s, threads):
            u = q + t["head"]
            win = window64(pk, u)
            fwd = forward_bases(win, k)
            rc = reverse_complement(win, k)
            canon = np.minimum(fwd, rc).astype(np.int64)
            bad = any_n_short(nm, u, k) | (col + k > lengths[read])
            keys[read * s + col] = np.where(bad, SENTINEL, canon)
            seen[read * s + col] += 1
    assert (seen == 1).all(), "a window written other than once"
    return keys.reshape(b, s)


def model_k1w(codes, lengths, k, misalign=0, tile=K_TILE,
              threads=K_THREADS, seed=0):
    """K1w over (B, L) codes: (B, S, Q) int64 limb rows."""
    rng = np.random.default_rng(seed)
    b, length = codes.shape
    s = length - k + 1
    q_limbs = keys64.limbs_per_kmer(k)
    last = k - BASES_PER_LIMB * (q_limbs - 1)
    flat = np.ascontiguousarray(codes).reshape(-1)
    keys = np.zeros(b * s * q_limbs, np.int64)
    seen = np.zeros(b * s * q_limbs, np.int64)
    forward, reverse, invalid = 0, 1, 2

    def limb(pk, u, j, strand):
        n = np.where(j < q_limbs - 1, BASES_PER_LIMB, last)
        if strand == forward:
            return forward_bases(window64(pk, u + BASES_PER_LIMB * j), n)
        return reverse_complement(
            window64(pk, u + k - BASES_PER_LIMB * j - n), n)

    for block in range(-(-flat.size // tile)):
        t = make_tile(block, flat.size, length, s, k, misalign, tile)
        pk, nm = load_tile(flat, t, tile, rng, misalign)
        frame_of = rng.integers(0, 1 << 16, tile)
        strand_of = rng.integers(0, 256, tile)
        filled = np.zeros(tile, bool)
        # pass 1: validity and orientation, one thread per position
        for q, read, col in walk(t, length, s, threads):
            u = q + t["head"]
            w = read * s + col - t["first"]
            assert ((w >= 0) & (w < t["n_windows"])).all()
            strand = np.full(u.size, forward)
            open_ = np.ones(u.size, bool)  # no limb has differed yet
            for j in range(q_limbs):
                f = limb(pk, u, np.full(u.size, j), forward)
                r = limb(pk, u, np.full(u.size, j), reverse)
                differ = open_ & (f != r)
                strand[differ & (r < f)] = reverse
                open_ &= ~differ
            bad = (col + k > lengths[read]) | any_n(nm, u, k)
            strand[bad] = invalid
            frame_of[w] = u
            strand_of[w] = strand
            filled[w] = True
        assert filled[:t["n_windows"]].all()
        # pass 2: one thread per output int64 of the tile's span
        e = np.arange(t["n_windows"] * q_limbs)
        w = e // q_limbs
        j = e - w * q_limbs
        u, strand = frame_of[w], strand_of[w]
        n = np.where(j < q_limbs - 1, BASES_PER_LIMB, last)
        rc = strand == reverse
        win = window64(pk, np.where(rc, u + k - BASES_PER_LIMB * j - n,
                                    u + BASES_PER_LIMB * j))
        v = np.where(rc, reverse_complement(win, n),
                     forward_bases(win, n)).astype(np.int64)
        out = t["first"] * q_limbs + e
        keys[out] = np.where(strand == invalid, SENTINEL, v)
        seen[out] += 1
    assert (seen == 1).all(), "an output int64 written other than once"
    return keys.reshape(b, s, q_limbs)


def model(codes, lengths, k, **kw):
    fn = model_k1 if k <= keys64.NARROW_K else model_k1w
    return fn(codes, lengths, k, **kw)


def plain(codes, lengths, k):
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    if k <= keys64.NARROW_K:
        return tdev.extract_canonical_windows(c, ln, k)[0].numpy()
    return tdev.extract_canonical_windows_wide(c, ln, k)[0].numpy()


def batch(seed, k, length, n=20, high_codes=True):
    """Ragged reads with N bases: row 0 empty, row 1 one base short of k,
    row 2 all N, row 3 full length and clean; codes past a row's length
    left random.  *high_codes* adds codes above 4, which count as N."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, length), dtype=np.uint8)
    codes[rng.random((n, length)) < 0.01] = 4
    if high_codes:
        codes[rng.random((n, length)) < 0.002] = 255
    lengths = rng.integers(max(0, k - 4), length + 1, n).astype(np.int32)
    lengths[:4] = [0, k - 1, length, length]
    codes[2] = 4
    codes[3] %= 4
    return codes, lengths


LENGTHS = (31, 32, 33, 63, 64, 65, 152, 256)


@pytest.mark.parametrize("k", range(3, MAX_K + 1, 2))
def test_model_matches_plain(k):
    """Every odd k, at L = k and each length of LENGTHS that holds a
    window, with a frame misaligned by k % 16 bytes."""
    for length in sorted({k, *(x for x in LENGTHS if x >= k)}):
        codes, lengths = batch(1000 * k + length, k, length)
        got = model(codes, lengths, k, misalign=k % 16, seed=length)
        want = plain(codes, lengths, k)
        assert got.shape == want.shape
        assert np.array_equal(got, want), f"k={k}, L={length}"
        live = want[3] if k <= keys64.NARROW_K else want[3, :, 0]
        assert (live != SENTINEL).all()


@pytest.mark.parametrize("k", [3, 15, 31, 33, 63, 207])
def test_model_matches_jax_extract(k):
    """The model against the JAX package's ``extract_canonical_windows``
    directly (one XLA compile per k)."""
    codes, lengths = batch(k, k, k + 40, n=16, high_codes=False)
    jkeys, _valid = jdev.extract_canonical_windows(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    words = np.asarray(jkeys).reshape(-1, enc.words_per_kmer(k))
    got = model(codes, lengths, k, misalign=3)
    if k <= keys64.NARROW_K:
        want = keys64.words_to_keys64(words, k).numpy()
    else:
        want = keys64.words_to_limbs(words, k).numpy()
    assert np.array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("k,misalign", [(3, 0), (31, 9), (33, 15), (63, 1),
                                        (151, 4), (207, 12)])
def test_small_tiles_cover_every_window_once(k, misalign):
    """Tiles of 64 positions walked by 16 threads: many tiles cut reads,
    and the walk wraps a read every step; the model asserts each output
    is written exactly once."""
    length = k + 13
    codes, lengths = batch(k + misalign, k, length, n=24)
    got = model(codes, lengths, k, misalign=misalign, tile=64, threads=16)
    assert np.array_equal(got, plain(codes, lengths, k))


def test_one_long_row():
    """One row of 20,000 bases, as ``StreamCounter.feed_sequence`` feeds
    contigs: the tiles cut the row, never a read boundary."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, (1, 20_000), dtype=np.uint8)
    codes[0, rng.random(20_000) < 0.001] = 4
    lengths = np.array([20_000], np.int32)
    for k in (31, 63):
        assert np.array_equal(model(codes, lengths, k, misalign=5),
                              plain(codes, lengths, k))


def test_window_sparse_and_stacked_group():
    """k = 151 on 152 bp (two windows a read), and a group of batches of
    widths 152 and 120 stacked and padded with code 4, as the anchoring
    scan stacks them."""
    k = 151
    codes, lengths = batch(5, k, 152, n=40)
    assert np.array_equal(model(codes, lengths, k), plain(codes, lengths, k))
    a, la = batch(6, 63, 152, n=12)
    b, lb = batch(7, 63, 120, n=12)
    stacked = np.full((24, 152), 4, np.uint8)
    stacked[:12], stacked[12:, :120] = a, b
    lengths = np.concatenate([la, lb])
    for k in (31, 63):
        assert np.array_equal(model(stacked, lengths, k),
                              plain(stacked, lengths, k))


def _bases(codes, u, n):
    """Bases u .. u + n - 1 of a code row as an int, first on top."""
    v = 0
    for c in codes[u:u + n]:
        v = (v << 2) | (int(c) & 3)
    return v


@pytest.mark.parametrize("misalign", [0, 1, 15])
def test_funnel_extract_every_offset(misalign):
    """window64 at every frame offset of three chunks, offset 0 (a shift
    by 0, not by 32) included, against the bases read one by one; and the
    reverse complement of each first n bases, n = 1..31."""
    rng = np.random.default_rng(misalign)
    codes = rng.integers(0, 4, (1, 200), dtype=np.uint8)
    t = make_tile(0, 200, 200, 200 - 31 + 1, 31, misalign, K_TILE)
    pk, _nm = load_tile(codes.reshape(-1), t, K_TILE, rng, misalign)
    for q in range(64):
        u = q + t["head"]
        win = int(window64(pk, np.array([u]))[0])
        assert win == _bases(codes[0], q, 32)
        for n in range(1, 32):
            fwd = int(forward_bases(np.array([win], U64), n)[0])
            rc = int(reverse_complement(np.array([win], U64), n)[0])
            assert fwd == _bases(codes[0], q, n)
            want = 0
            for i in range(n):
                want = (want << 2) | (3 - int(codes[0, q + n - 1 - i]))
            assert rc == want


def test_n_tests_every_span():
    """Both N tests against a direct look at the codes, for every start
    in two mask words and k = 1..31 (the funnel) or 33..207 (the word
    OR)."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, (1, 400), dtype=np.uint8)
    codes[0, rng.random(400) < 0.03] = 4
    t = make_tile(0, 400, 400, 400 - MAX_K + 1, MAX_K, 0, K_TILE)
    _pk, nm = load_tile(codes.reshape(-1), t, K_TILE, rng, 0)
    bad = codes[0] >= 4
    u = np.arange(64)
    for k in range(1, MAX_K + 1, 2):
        want = np.array([bad[x:x + k].any() for x in u])
        assert np.array_equal(any_n(nm, u, k), want), f"k={k}"
        if k <= 31:
            assert np.array_equal(any_n_short(nm, u, k), want), f"k={k}"
