"""Kernel K12 (``ops/sortcount.py``, ``csrc/sort_count.cu``): a numpy
model of its arithmetic, on the CPU.

The model follows K12's launches over K9d's (K9dw's) slots: the first
pass reads the slots and drops the rows past each segment's count (the
rows there hold junk, as K9d leaves them); each radix pass takes a
8-bit digit of one limb, the last limb first, and stops at the limb's
top bit; it counts digits a block, scans the counts digit-major, and
ranks each row stably in its block by lower warps, lower lanes and
earlier rounds; the run combine ranks the run starts the same way and
sums each run's weights.  It equals the plain version (what a CPU
tensor runs) on every input the tests pin, at K12's launch shape and
at smaller ones.  The JAX parity is ``tests/test_torch_sort_count.py``;
the card's is ``tests/test_torch_gpu.py``.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops import segsort
from kmer_denovo_filter_tpu_torch.ops import sortcount as sc

SENTINEL = keys64.SENTINEL
SEGMENT = segsort.SEGMENT
WARP = 32
KS = [15, 21, 31, 33, 63, 127, 201, 207]
# (threads, most blocks) of a launch: K12's, and smaller ones, so that a
# block walks many rounds and the rows span few blocks
SHAPES = [(sc.THREADS, sc.MAX_BLOCKS), (64, 3), (32, 1)]


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
    codes, lengths = torch.from_numpy(codes), torch.from_numpy(lengths)
    if k <= keys64.NARROW_K:
        rows = dev.extract_canonical_windows(codes, lengths, k)[0]
        rows = rows.reshape(-1, 1)
    else:
        rows = dev.extract_canonical_windows_wide(codes, lengths, k)[0]
        rows = rows.reshape(-1, keys64.limbs_per_kmer(k))
    return np.concatenate([rows.numpy()] * copies)


def limb0_tie_rows(k, seed):
    """Wide rows that share limb 0 and differ in the limbs after it."""
    rows = random_rows(3000, k, seed, distinct=400)
    rows[rows[:, 0] != SENTINEL, 0] = 12345
    return rows


def homopolymer_rows(k, n=5000):
    return np.zeros((n, keys64.limbs_per_kmer(k)), np.int64)


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


def block_ranges(rows, blocks, threads):
    """Each block's [lo, hi): equal runs of whole rounds."""
    per = -(-rows // (blocks * threads)) * threads
    return [(min(rows, b * per), min(rows, b * per + per))
            for b in range(blocks)]


def round_rank(d, bins, threads):
    """Each row's place among the rows of its bin in one round of
    *threads* rows: those of lower warps (a count a warp and bin) plus
    those of lower lanes of its warp (``__match_any_sync``, ``__popc``).
    Rows past the round's end and dead rows vote bin *bins*."""
    padded = np.full(threads, bins, np.int64)
    padded[:d.shape[0]] = d
    lanes = padded.reshape(threads // WARP, WARP)
    same = lanes[:, :, None] == lanes[:, None, :]
    in_warp = np.tril(same, -1).sum(axis=2).reshape(-1)
    warp_count = np.stack([np.bincount(w, minlength=bins + 1)
                           for w in lanes])
    below = np.cumsum(warp_count, axis=0) - warp_count
    t = np.arange(d.shape[0])
    return below[t // WARP, d] + in_warp[t]


def k12_model(keys, weights, seg_counts, k, threads, max_blocks):
    """K12's launches over K9d's slots: (distinct rows (D, Q), counts)."""
    n_slots, q = keys.shape
    blocks = min(max_blocks, -(-n_slots // threads))
    r = np.arange(n_slots)
    live = r % SEGMENT < seg_counts[r // SEGMENT]
    rows = n_slots
    for limb, shift, bits in sc.passes(q, k):
        bins = 1 << bits
        digit = np.where(live, (keys[:, limb] >> shift) & (bins - 1), bins)
        ranges = block_ranges(rows, blocks, threads)
        # 1. each block's histogram, digit-major
        counts = np.stack([np.bincount(digit[lo:hi], minlength=bins + 1)
                           [:bins] for lo, hi in ranges], axis=1)
        # 2. one exclusive scan: within a digit the blocks keep their order
        flat = counts.reshape(-1)
        offsets = (np.cumsum(flat) - flat).reshape(bins, blocks)
        total = int(flat.sum())
        # 3. the stable scatter, round by round
        out_keys = np.full_like(keys, -1)
        out_weights = np.full_like(weights, -1)
        for b, (lo, hi) in enumerate(ranges):
            nxt = offsets[:, b].copy()
            for first in range(lo, hi, threads):
                d = digit[first:min(hi, first + threads)]
                rank = round_rank(d, bins, threads)
                ok = d < bins
                dest = nxt[d[ok]] + rank[ok]
                src = first + np.flatnonzero(ok)
                out_keys[dest] = keys[src]
                out_weights[dest] = weights[src]
                nxt += np.bincount(d[ok], minlength=bins)
        keys, weights = out_keys, out_weights
        live = r < total
        rows = total
    # the runs: a start is a row that differs from the row before
    start = np.zeros(n_slots, bool)
    start[:rows] = True
    if rows > 1:
        start[1:rows] &= (keys[1:rows] != keys[:rows - 1]).any(axis=1)
    ranges = block_ranges(rows, blocks, threads)
    per_block = np.array([start[lo:hi].sum() for lo, hi in ranges])
    offsets = np.cumsum(per_block) - per_block
    distinct = int(start.sum())
    out_keys = np.full((distinct, q), -1, np.int64)
    out_counts = np.full(distinct, -1, np.int64)
    for b, (lo, hi) in enumerate(ranges):
        nxt = offsets[b]
        for first in range(lo, hi, threads):
            s = start[first:min(hi, first + threads)]
            rank = nxt + np.cumsum(s) - s
            for t in np.flatnonzero(s):
                row = first + t
                end = row + 1
                while end < rows and not start[end]:
                    end += 1
                out_keys[rank[t]] = keys[row]
                out_counts[rank[t]] = weights[row:end].sum()
            nxt += int(s.sum())
    return out_keys, out_counts


def plain_rows(rows, k):
    """The plain version's (distinct (D, Q) rows, counts) as numpy."""
    flat = as_tensor(rows)
    if rows.shape[1] == 1:
        uk, counts = sc.sort_count(flat, k)
        return uk.numpy()[:, None], counts.numpy()
    uk, counts = sc.sort_count_wide(flat, k)
    return uk.numpy(), counts.numpy()




# ── the tests ────────────────────────────────────────────────────────


def test_pass_plan():
    """A limb's passes stop at its top bit: k = 15 takes 4, k = 31
    takes 8, k = 63 takes 8 + 8 + 1 (the last limb first)."""
    assert len(sc.passes(1, 15)) == 4
    assert len(sc.passes(1, 31)) == 8
    assert sc.passes(1, 31)[-1] == (0, 56, 6)
    p63 = sc.passes(3, 63)
    assert p63[0] == (2, 0, 2)
    assert [p[0] for p in p63] == [2] + [1] * 8 + [0] * 8
    assert len(sc.passes(7, 207)) == 6 * 8 + 6
    assert len(sc.passes(2, 61)) == 16
    with pytest.raises(ValueError, match="limbs"):
        sc.passes(1, 33)
    assert sc.plan(8192) == 32 and sc.plan(1 << 22) == sc.MAX_BLOCKS
    assert block_ranges(0, 4, sc.THREADS) == [(0, 0)] * 4
    assert block_ranges(1, 4, sc.THREADS) == [(0, 1)] + [(1, 1)] * 3


@pytest.mark.parametrize("k", KS)
def test_model_matches_plain(k):
    """K12's model at its own launch shape equals the plain version on
    every input at *k*."""
    for label, rows in cases(k).items():
        if rows.shape[0] == 0:
            continue
        keys, weights, seg_counts = slots_of(rows, seed=k)
        got = k12_model(keys, weights, seg_counts, k, sc.THREADS,
                        sc.MAX_BLOCKS)
        want = plain_rows(rows, k)
        assert np.array_equal(got[0], want[0]), label
        assert np.array_equal(got[1], want[1]), label


@pytest.mark.parametrize("threads,max_blocks", SHAPES[1:])
@pytest.mark.parametrize("k", [15, 31, 63, 201])
def test_model_at_other_block_shapes(k, threads, max_blocks):
    """Blocks of many rounds and runs of one key that cross blocks: the
    model still equals the plain version."""
    for label in ("duplicated reads", "N=8193", "one key"):
        rows = cases(k)[label]
        keys, weights, seg_counts = slots_of(rows, seed=k + threads)
        got = k12_model(keys, weights, seg_counts, k, threads, max_blocks)
        want = plain_rows(rows, k)
        assert np.array_equal(got[0], want[0]), label
        assert np.array_equal(got[1], want[1]), label


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
