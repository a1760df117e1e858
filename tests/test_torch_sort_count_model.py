"""Kernel K12 (``ops/sortcount.py``, ``csrc/sort_count.cu``): a numpy
model of its arithmetic, on the CPU.

The model follows K12's launches over K9d's (K9dw's) slots, which hold
junk past each segment's count, as K9d leaves them:

* ``sc_offsets``: the counts scanned into run offsets off[0..S];
* ``sc_merge``, a round a launch: round r merges pairs of runs of 2^r
  segments, each pair's bounds a stride over off; round 0 reads the
  slots in place and writes compacted rows; a run with no partner is
  copied.  A round's output is cut into tiles of T rows: a tile finds
  the pairs of its first and last rows and the merge path's splits
  there by the block's global search (half the block a search, G
  candidates a step), stages each pair's part of the tile (a tile
  straddles pairs when runs are shorter than T), and each thread merges
  its T / threads outputs from the split at its first output, on into
  the next piece;
* the run combine: run starts counted by block, ranked, and each run's
  weights summed.

It equals the plain version (what a CPU tensor runs) on every input the
tests pin, at K12's own tile, threads and search group and at small
ones (tiles of 32 and 5 rows, groups of 3 and 2), so that runs are
longer and shorter than a tile.  The JAX parity is
``tests/test_torch_sort_count.py``; the card's is
``tests/test_torch_gpu.py``.  Every comparison is exact.
"""

import bisect
import math
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops import segsort
from kmer_denovo_filter_tpu_torch.ops import sortcount as sc

SENTINEL = keys64.SENTINEL
SEGMENT = segsort.SEGMENT
KS = [15, 21, 31, 33, 63, 127, 201, 207]
# csrc/sort_count.cu: kMergeThreads, kGroup, kThreads, kCombineBlocks
MERGE_THREADS, GROUP = 256, 128
COMBINE_THREADS, COMBINE_BLOCKS = 256, 512


def tile_rows(q):
    """csrc/sort_count.cu's MergeTile<Q>::kRows."""
    return 2048 if q == 1 else 1024 if q <= 3 else 512


def k12_shape(q):
    """K12's own (tile rows, outputs a thread, search group) at *q*."""
    return tile_rows(q), tile_rows(q) // MERGE_THREADS, GROUP


# (tile rows, outputs a thread, search group) smaller than K12's
SMALL_SHAPES = [(32, 4, 3), (5, 5, 2), (5, 1, GROUP)]


# ── the inputs ───────────────────────────────────────────────────────


def random_rows(n, k, seed, distinct=None):
    """(n, Q) int64 limb rows at k: keys drawn from *distinct* random
    keys (all distinct when None), every 11th row a sentinel row."""
    rng = np.random.default_rng(seed)
    tops = [1 << (2 * nb) for nb in keys64.limb_bases(k)]
    m = n if distinct is None else distinct
    pool = np.stack([rng.integers(0, top, m, dtype=np.int64)
                     for top in tops], axis=1)
    rows = pool if distinct is None else pool[rng.integers(0, m, n)]
    rows = rows.copy()
    rows[::11] = SENTINEL
    return rows


def read_rows(k, seed, copies=1):
    """The window keys of a batch of reads (ragged, N bases, one all-N
    row), as (n, Q) rows; *copies* times over (a duplicated batch)."""
    rng = np.random.default_rng(seed)
    b, length = 24, max(k + 40, 160)
    codes = rng.integers(0, 4, (b, length), dtype=np.uint8)
    codes[rng.random((b, length)) < 0.01] = 4
    codes[3] = 4
    lengths = rng.integers(0, length + 1, b).astype(np.int32)
    lengths[::2] = length
    return np.concatenate([window_rows(codes, lengths, k)] * copies)


def window_rows(codes, lengths, k):
    """The plain extract's window keys of a (B, L) batch as (n, Q)."""
    codes, lengths = torch.from_numpy(codes), torch.from_numpy(lengths)
    if k <= keys64.NARROW_K:
        rows = dev.extract_canonical_windows(codes, lengths, k)[0]
        return rows.reshape(-1, 1).numpy()
    rows = dev.extract_canonical_windows_wide(codes, lengths, k)[0]
    return rows.reshape(-1, keys64.limbs_per_kmer(k)).numpy()


def one_read_repeated(k, seed, copies=150):
    """The window keys of one read (k + 40 bases, 160 at least),
    *copies* times: every segment holds the same keys."""
    rng = np.random.default_rng(seed)
    length = max(k + 40, 160)
    codes = rng.integers(0, 4, (1, length), dtype=np.uint8)
    lengths = np.array([length], np.int32)
    return np.concatenate([window_rows(codes, lengths, k)] * copies)


def limb0_tie_rows(k, seed):
    """Wide rows that share limb 0 and differ in the limbs after it."""
    rows = random_rows(3000, k, seed, distinct=400)
    rows[rows[:, 0] != SENTINEL, 0] = 12345
    return rows


def homopolymer_rows(k, n=5000):
    return np.zeros((n, keys64.limbs_per_kmer(k)), np.int64)


def segmented_rows(k, pools, seed, tail=SEGMENT):
    """Rows of len(pools) segments, SEGMENT rows each but the last
    (*tail* rows): segment s draws its keys from the first pools[s] keys
    of one shared pool (0: sentinel rows only), so keys recur across
    segments and runs differ in length."""
    rng = np.random.default_rng(seed)
    tops = [1 << (2 * nb) for nb in keys64.limb_bases(k)]
    pool = np.stack([rng.integers(0, top, max(pools), dtype=np.int64)
                     for top in tops], axis=1)
    parts = []
    for s, m in enumerate(pools):
        n = tail if s == len(pools) - 1 else SEGMENT
        if m == 0:
            parts.append(np.full((n, len(tops)), SENTINEL, np.int64))
        else:
            parts.append(pool[rng.integers(0, m, n)])
    return np.concatenate(parts)


def cases(k):
    """{label: (n, Q) rows} of every input the tests pin at *k*."""
    out = {"reads": read_rows(k, k), "duplicated reads": read_rows(k, k, 2),
           "one key": homopolymer_rows(k),
           "no rows": np.zeros((0, keys64.limbs_per_kmer(k)), np.int64),
           "one row": np.full((1, keys64.limbs_per_kmer(k)), 7, np.int64),
           "sentinels": np.full((3000, keys64.limbs_per_kmer(k)), SENTINEL,
                                np.int64),
           "distinct": random_rows(8193, k, k + 1)}
    for n in (8191, 8192, 8193):
        out[f"N={n}"] = random_rows(n, k, n + k, distinct=2000)
    if k > keys64.NARROW_K:
        out["limb-0 tie"] = limb0_tie_rows(k, k + 2)
    return out


def merge_cases(k):
    """{label: (n, Q) rows} that shape the merge tree at *k*: one
    segment, odd S, S = 2^m + 1, a key in every segment, empty segments,
    one read repeated, a batch repeated."""
    return {
        "S=1": random_rows(5000, k, k + 3, distinct=1500),
        "S=3": segmented_rows(k, [900, 700, 1200], k + 4, tail=3001),
        "S=5 (2^2 + 1)": segmented_rows(k, [400] * 5, k + 5, tail=17),
        "S=9 (2^3 + 1)": segmented_rows(
            k, [300, 50, 300, 1, 300, 200, 300, 80, 300], k + 6, tail=999),
        "one key in every segment": segmented_rows(k, [1] * 6, k + 7),
        "empty segments": segmented_rows(k, [500, 0, 0, 300, 0, 700, 0],
                                         k + 8, tail=100),
        "one read repeated": one_read_repeated(k, k + 9),
        "batch repeated": read_rows(k, k + 10, copies=8),
    }


def as_tensor(rows):
    """(n, Q) rows as the wrappers take them: (n,) keys for Q = 1."""
    t = torch.from_numpy(np.ascontiguousarray(rows))
    return t[:, 0].contiguous() if rows.shape[1] == 1 else t


def to_words(rows, k):
    """(n, Q) limb rows to the JAX package's (n, W) uint32 words."""
    if k <= keys64.NARROW_K:
        return keys64.keys64_to_words(rows[:, 0], k)
    return keys64.limbs_to_words(rows, k)


# ── the model ────────────────────────────────────────────────────────


def slots_of(rows, seed):
    """K9d's (K9dw's) slots of (n, Q) rows, by the plain versions, with
    junk in every row past a segment's count: (n_slots, Q) keys,
    (n_slots,) weights, (S,) counts."""
    q = rows.shape[1]
    flat = as_tensor(rows)
    segs = segsort.segments(flat, SENTINEL)
    if q == 1:
        keys, weights, counts = dev.segment_runs(segs)
    else:
        keys, weights, counts = dev.segment_runs_wide(segs)
    keys = keys.reshape(-1, q).numpy().copy()
    weights = weights.reshape(-1).numpy().copy()
    counts = counts.numpy()
    r = np.arange(keys.shape[0])
    dead = r % SEGMENT >= counts[r // SEGMENT]
    rng = np.random.default_rng(seed)
    keys[dead] = rng.integers(0, 1 << 62, (int(dead.sum()), q))
    weights[dead] = rng.integers(1, 1 << 20, int(dead.sum()))
    return keys, weights, counts


def offsets(seg_counts):
    """sc_offsets: off[s] = the rows of segments before s, off[S] all."""
    off = np.zeros(len(seg_counts) + 1, np.int64)
    np.cumsum(seg_counts, out=off[1:])
    return off


def widths(n_segments):
    """Segments a run in each merge round: 1, 2, 4, ... below S."""
    w = 1
    while w < n_segments:
        yield w
        w *= 2


def group_search(lo, hi, pred, group):
    """The first index in [lo, hi) where *pred* (true, then false) is
    false, or hi, by *group* candidates a step: csrc's group_search."""
    while lo < hi:
        length = hi - lo
        stride = -(-length // group)
        first = group
        for t in range(group):
            at = lo + t * stride
            if at < hi and not pred(at):
                first = t
                break
        if first < group:
            at_false = lo + first * stride
            lo = at_false - stride + 1 if first > 0 else lo
            hi = at_false
        else:
            lo += (length - 1) // stride * stride + 1
    return lo


@dataclass
class Round:
    off: np.ndarray
    n_segments: int
    width: int
    slot_shift: int  # round 0: segment s starts at s << shift; 0: off[s]


@dataclass
class TileSpan:
    o0: int
    o1: int
    first: int
    last: int
    split_first: int
    split_last: int


@dataclass
class Piece:
    begin: int
    length: int
    a_len: int
    a_src: int
    b_src: int


def pair_of(r, p):
    """Pair p: its first output row, A's and B's rows, their bases."""
    s0 = p * 2 * r.width
    s1 = min(s0 + r.width, r.n_segments)
    s2 = min(s0 + 2 * r.width, r.n_segments)
    start, off1 = int(r.off[s0]), int(r.off[s1])
    a_base = s0 << r.slot_shift if r.slot_shift else start
    b_base = s1 << r.slot_shift if r.slot_shift else off1
    return start, off1 - start, int(r.off[s2]) - off1, a_base, b_base


def piece_of(r, s, p):
    start, a_len, b_len, a_base, b_base = pair_of(r, p)
    lo, hi = max(start, s.o0), min(start + a_len + b_len, s.o1)
    a0 = s.split_first if p == s.first else 0
    a1 = s.split_last if p == s.last else a_len
    return Piece(lo - s.o0, hi - lo, a1 - a0, a_base + a0,
                 b_base + (lo - start - a0))


def pair_at(r, s, i):
    """The last pair of the tile that starts at or before its row i."""
    lo, hi = s.first, s.last
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if r.off[mid * 2 * r.width] <= s.o0 + i:
            lo = mid
        else:
            hi = mid - 1
    return lo


def merge_round(r, src, src_w, dst, dst_w, tile, per, group):
    """sc_merge: the round's tiles, from the rows *src* (tuples) and
    weights *src_w* into *dst* / *dst_w*."""
    live = int(r.off[-1])
    span = 2 * r.width
    pairs = -(-r.n_segments // span)
    for o0 in range(0, live, tile):
        o1 = min(o0 + tile, live)
        n = o1 - o0
        bounds = []
        for row, end in ((o0, o0), (o1 - 1, o1)):  # a. the two halves
            p = group_search(0, pairs, lambda i: r.off[i * span] <= row,
                             group) - 1
            start, a_len, b_len, a_base, b_base = pair_of(r, p)
            d = end - start
            split = group_search(
                max(0, d - b_len), min(d, a_len),
                lambda i: src[a_base + i] <= src[b_base + d - 1 - i], group)
            bounds.append((p, split))
        s = TileSpan(o0, o1, bounds[0][0], bounds[1][0], bounds[0][1],
                     bounds[1][1])
        staged, staged_w = [None] * n, [None] * n  # b. stage
        c = Piece(0, 0, 0, 0, 0)
        for i in range(n):
            if i >= c.begin + c.length:
                c = piece_of(r, s, pair_at(r, s, i))
            local = i - c.begin
            at = (c.a_src + local if local < c.a_len
                  else c.b_src + local - c.a_len)
            staged[i], staged_w[i] = src[at], src_w[at]
        order = [None] * n
        for i0 in range(0, min(n, tile), per):  # c. thread by thread
            p = pair_at(r, s, i0)
            c = piece_of(r, s, p)
            d = i0 - c.begin
            a, b = c.begin, c.begin + c.a_len
            lo, hi = max(0, d - (c.length - c.a_len)), min(d, c.a_len)
            while lo < hi:
                mid = (lo + hi) // 2
                if staged[a + mid] <= staged[b + d - 1 - mid]:
                    lo = mid + 1
                else:
                    hi = mid
            ia, ib = lo, d - lo
            for i in range(i0, min(i0 + per, n)):
                while ia + ib == c.length:
                    p += 1
                    c = piece_of(r, s, p)
                    a, b = c.begin, c.begin + c.a_len
                    ia = ib = 0
                take_a = ia < c.a_len and (
                    ib == c.length - c.a_len
                    or staged[a + ia] <= staged[b + ib])
                if take_a:
                    order[i] = c.begin + ia
                    ia += 1
                else:
                    order[i] = c.begin + c.a_len + ib
                    ib += 1
        assert sorted(order) == list(range(n))
        for i in range(n):  # d. out in order
            dst[o0 + i] = staged[order[i]]
            dst_w[o0 + i] = staged_w[order[i]]


def block_ranges(rows, blocks, threads):
    """Each combine block's [lo, hi): equal runs of whole rounds."""
    per = -(-rows // (blocks * threads)) * threads
    return [(min(rows, b * per), min(rows, b * per + per))
            for b in range(blocks)]


def combine(rows, weights, live, n_slots):
    """sc_starts, sc_scan, sc_combine over the first *live* merged rows:
    (distinct rows, summed weights)."""
    blocks = min(COMBINE_BLOCKS, -(-n_slots // COMBINE_THREADS))
    start = [i == 0 or rows[i] != rows[i - 1] for i in range(live)]
    ranges = block_ranges(live, blocks, COMBINE_THREADS)
    per_block = np.array([sum(start[lo:hi]) for lo, hi in ranges], np.int64)
    rank = np.cumsum(per_block) - per_block
    out_rows, out_counts = [], []
    for b, (lo, hi) in enumerate(ranges):
        assert len(out_rows) == rank[b]
        for i in range(lo, hi):
            if not start[i]:
                continue
            end = i + 1
            while end < live and rows[end] == rows[i]:
                end += 1
            out_rows.append(rows[i])
            out_counts.append(sum(weights[i:end]))
    q = len(rows[0]) if rows else 1
    return (np.array(out_rows, np.int64).reshape(-1, q),
            np.array(out_counts, np.int64))


def k12_model(keys, weights, seg_counts, tile, per, group):
    """K12's launches over K9d's slots: (distinct rows (D, Q), counts)."""
    n_slots, q = keys.shape
    off = offsets(seg_counts)
    rng = np.random.default_rng(n_slots)
    bufs = [(list(map(tuple, keys.tolist())), weights.tolist()),
            (list(map(tuple, rng.integers(0, 1 << 62, (n_slots, q))
                      .tolist())), rng.integers(1, 99, n_slots).tolist())]
    src = 0
    for width in widths(len(seg_counts)):
        r = Round(off, len(seg_counts), width,
                  sc.SEGMENT_SHIFT if width == 1 else 0)
        merge_round(r, *bufs[src], *bufs[1 - src], tile, per, group)
        src = 1 - src
    return combine(*bufs[src], int(off[-1]), n_slots)


def plain_rows(rows, k):
    """The plain version's (distinct (D, Q) rows, counts) as numpy."""
    flat = as_tensor(rows)
    if rows.shape[1] == 1:
        uk, counts = sc.sort_count(flat, k)
        return uk.numpy()[:, None], counts.numpy()
    uk, counts = sc.sort_count_wide(flat, k)
    return uk.numpy(), counts.numpy()


def check_model(rows, k, shape, label):
    keys, weights, seg_counts = slots_of(rows, seed=k + shape[0])
    got = k12_model(keys, weights, seg_counts, *shape)
    want = plain_rows(rows, k)
    assert np.array_equal(got[0], want[0]), label
    assert np.array_equal(got[1], want[1]), label


# ── the tests ────────────────────────────────────────────────────────


def test_offsets_and_run_bounds():
    """The offsets scan; ceil(log2 S) rounds; each round's pairs, a
    stride over off, tile the live rows in order, and pair p's runs are
    the previous round's output runs 2p and 2p + 1 (round 0: the
    segments' slots)."""
    rng = np.random.default_rng(0)
    for n_segments in (1, 2, 3, 5, 8, 9, 13, 17):
        counts = rng.integers(0, 50, n_segments)
        counts[rng.random(n_segments) < 0.3] = 0
        off = offsets(counts)
        assert off[0] == 0 and off[-1] == counts.sum()
        assert np.array_equal(np.diff(off), counts)
        ws = list(widths(n_segments))
        assert len(ws) == math.ceil(math.log2(n_segments))
        runs = [(int(s) << sc.SEGMENT_SHIFT, int(c))
                for s, c in enumerate(counts)]  # (base, rows) of round 0
        for width in ws:
            r = Round(off, n_segments, width,
                      sc.SEGMENT_SHIFT if width == 1 else 0)
            pairs = -(-n_segments // (2 * width))
            assert pairs == -(-len(runs) // 2)
            out, at = [], 0
            for p in range(pairs):
                start, a_len, b_len, a_base, b_base = pair_of(r, p)
                assert start == at
                assert (a_base, a_len) == runs[2 * p]
                if 2 * p + 1 < len(runs):
                    assert (b_base, b_len) == runs[2 * p + 1]
                else:  # no partner: a copy
                    assert b_len == 0
                out.append((start, a_len + b_len))
                at += a_len + b_len
            assert at == off[-1]
            runs = out
        assert len(runs) == 1 and runs[0] == (0, counts.sum())


@pytest.mark.parametrize("group", [2, 3, GROUP])
def test_group_search_finds_the_first_false(group):
    """The block's global search, G candidates a step, gives bisect's
    answer on every range and turning point, empty ranges included."""
    rng = np.random.default_rng(group)
    for _ in range(400):
        lo = int(rng.integers(0, 50))
        hi = lo + int(rng.integers(0, 3000 if group > 3 else 300))
        turn = int(rng.integers(lo, hi + 1))
        calls = []

        def pred(i, turn=turn, calls=calls):
            calls.append(i)
            return i < turn

        assert group_search(lo, hi, pred, group) == turn
        assert all(lo <= i < hi for i in calls)
        values = list(range(lo, hi))
        assert bisect.bisect_left(values, turn) + lo == turn


@pytest.mark.parametrize("k", KS)
def test_model_matches_plain(k):
    """K12's model at its own tile, threads and search group equals the
    plain version on every input at *k*."""
    shape = k12_shape(keys64.limbs_per_kmer(k))
    for label, rows in {**cases(k), **merge_cases(k)}.items():
        if rows.shape[0]:
            check_model(rows, k, shape, label)


@pytest.mark.parametrize("shape", SMALL_SHAPES)
@pytest.mark.parametrize("k", [15, 31, 63, 201])
def test_model_at_small_tiles(k, shape):
    """Tiles of 32 and 5 rows: tiles that straddle pairs of one-row
    runs and tiles inside runs of thousands, a thread's outputs that
    cross pieces, searches of several steps.  The model still equals
    the plain version."""
    picked = {**cases(k), **merge_cases(k)}
    for label in ("N=8193", "S=3", "S=9 (2^3 + 1)",
                  "one key in every segment", "empty segments",
                  "one read repeated"):
        check_model(picked[label], k, shape, label)


def test_wrappers_check_their_input():
    with pytest.raises(ValueError, match="int64"):
        sc.sort_count(torch.zeros(4, dtype=torch.int32), 31)
    with pytest.raises(ValueError, match="limbs"):
        sc.sort_count(torch.zeros(4, dtype=torch.int64), 33)
    with pytest.raises(ValueError, match="rows"):
        sc.sort_count_wide(torch.zeros((4, 1), dtype=torch.int64), 33)
    with pytest.raises(ValueError, match="limbs"):
        sc.sort_count_wide(torch.zeros((4, 2), dtype=torch.int64), 201)
    empty = sc.sort_count_wide(torch.zeros((0, 3), dtype=torch.int64), 63)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0,)
