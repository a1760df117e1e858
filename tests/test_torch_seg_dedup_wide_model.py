"""A CPU model of kernel K9dw (``csrc/seg_dedup_wide.cu``,
``seg_dedup_wide_kernel``), held against its plain version
``dev.segment_runs_wide``.  Integer outputs, exact equality.

The CUDA kernel runs only on the card; this file transcribes its steps
in numpy so the algorithm is proven on the CPU: the shared-memory hash of
8,192 slots (a word of fingerprint bits 13..62, a claimed bit and the
row's index in the segment, claimed by one compare-and-swap; a
fingerprint match confirmed on all limbs; linear probing), its give-up
tests (more than 7/8 of the live rows among the first 512 distinct, or
past 6,144 distinct rows), the compaction of the occupied slots into an
element table (row | count << 13), the sort of limb 0 with the element
as a carried payload by K9's register network
(``tests/test_torch_seg_sort_model.py``),
the limb-0 tie pass (a run of equal limb 0 of up to 32 elements sorted
by its other limbs by one thread; a longer one, unless it is one row
repeated after a give-up, sorts all elements again limb by limb from the
last, pairs ordered lexicographically, each pass stable on the
position of the pass before), and the
output (the hash's counts, or the run lengths of the sorted rows).
Fingerprint collisions are forced through a replaceable hash.  The
unordered form too: after the same hash no sort and no tie pass; a kept
segment's distinct rows with their counts in slot order, a segment the
hash gave up on passed through (every live row, weight 1) in row order,
placed by ``block_sort.cuh``'s ``RowOrder``
(``tests/test_torch_seg_dedup_model.py``), and held to the looser
contract: row by row the same weight sums as the plain version.  The
model is on no path.
"""

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import segsort
from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL
from tests.test_torch_seg_dedup_model import (
    LOG_SEG,
    REGS,
    THREADS,
    row_order,
)
from tests.test_torch_seg_sort_model import block_sort_pay, natural_out

SEG = segsort.SEGMENT
# csrc/seg_dedup_wide.cu
SLOTS, LOG_SLOTS, LIMIT, SERIAL_TIE = 8192, 13, 6144, 32
MASK = SEG - 1
CLAIMED = 1 << 63
M64 = (1 << 64) - 1


def row_hash(row):
    """``row_hash<Q>``: a multiply-xorshift round per limb."""
    h = 0
    for limb in row:
        h = ((h ^ (int(limb) & M64)) * 0x9E3779B97F4A7C15) & M64
        h ^= h >> 29
    return (h * 0xBF58476D1CE4E5B9) & M64


class Hash:
    """``hash_rows<Q>`` over one segment's rows, inserted in the kernel's
    rounds (row t + 512 r in round r) in an order *rng* draws within a
    round (the race of the inserts)."""

    def __init__(self, rows, live_rows, rng, hash_fn=row_hash):
        self.word = [0] * SLOTS
        self.count = [0] * SLOTS
        self.rows = rows
        self.max_probe = 0
        n_distinct, overflow = 0, False
        for r in range(REGS):
            if r == 1:
                first = rows[:THREADS]
                n_live = int((first[:live_rows, 0] != SENTINEL).sum())
                if n_distinct * 8 > n_live * 7:
                    self.distinct = -1  # random-like
                    return
            if overflow:
                break
            for t in rng.permutation(THREADS):
                idx = int(t) + r * THREADS
                if idx >= live_rows or rows[idx, 0] == SENTINEL:
                    continue
                h = hash_fn(rows[idx])
                word = (h & ~MASK & M64) | CLAIMED | idx
                s = h >> (64 - LOG_SLOTS)
                for probe in range(SLOTS):
                    prev = self.word[s]
                    if prev == 0:
                        self.word[s] = word
                        overflow |= n_distinct >= LIMIT
                        n_distinct += 1
                        break
                    if ((prev ^ word) & ~MASK & M64) == 0 and np.array_equal(
                            rows[prev & MASK], rows[idx]):
                        break
                    s = (s + 1) & (SLOTS - 1)
                else:
                    raise AssertionError("a probe sequence did not end")
                self.count[s] += 1
                self.max_probe = max(self.max_probe, probe)
        self.distinct = -1 if overflow else n_distinct


def sort_elements(key, pay, log_p, mode="carried"):
    """K9's network on p elements given as (p,) arrays in the load
    arrangement e = t + r * holders; returns them in position order."""
    holders = (1 << log_p) // REGS
    k = np.full((THREADS, REGS), -1, dtype=np.int64)  # non-holders: unread
    p_ = np.full((THREADS, REGS), -1, dtype=np.int64)
    k[:holders] = key.reshape(REGS, holders).T
    p_[:holders] = pay.reshape(REGS, holders).T
    p = 1 << log_p
    block_sort_pay(k, p_, log_p, np.full(p, -5, np.int64),
                   np.full(p, -5, np.int64), mode)
    return natural_out(k, p_, holders)


def write_unordered(rows, h):
    """``write_unordered<Q>`` after the hash *h*: (keys (count, Q),
    weights, path), the path {"pass"} for a segment passed through (its
    live rows in row order), {"hash"} for one the hash kept (each slot's
    first row and count, in slot order)."""
    if h.distinct < 0:  # every live row
        live = rows[:, 0] != SENTINEL
        places = row_order(live)
        assert np.array_equal(places, np.arange(places.size))
        return rows[live], np.ones(places.size, dtype=np.int64), {"pass"}
    word = np.array(h.word, dtype=np.uint64)
    occupied = word != 0
    places = row_order(occupied)
    assert places.size == h.distinct
    first = (word[occupied] & np.uint64(MASK)).astype(np.int64)
    return rows[first], np.array(h.count)[occupied], {"hash"}


def seg_dedup_wide_block(rows, live_rows, rng, hash_fn=row_hash,
                         ordered=True):
    """The kernel on one segment of (8,192, Q) rows, the first *live_rows*
    of them real; *ordered* False its unordered form.  Returns (keys
    (count, Q), weights, path), path a set of the steps taken."""
    q = rows.shape[1]
    rows = rows.copy()
    rows[live_rows:] = SENTINEL
    h = Hash(rows, live_rows, rng, hash_fn)
    if not ordered:
        return write_unordered(rows, h)
    hashed = h.distinct >= 0
    path = {"hash" if hashed else "sort"}
    if hashed:
        # the occupied slots, 16 a thread, in slot order
        elem = np.array([(w & MASK) | (c << LOG_SEG)
                         for w, c in zip(h.word, h.count) if w],
                        dtype=np.int64)
        assert elem.size == h.distinct
        log_p = max(9, (h.distinct - 1).bit_length())
        p = 1 << log_p
        key = np.full(p, SENTINEL, dtype=np.int64)
        key[:h.distinct] = rows[elem & MASK, 0]

        def row_of(e):
            """Rows of elements (dead elements: row 0, never read)."""
            return elem[np.minimum(e, h.distinct - 1)] & MASK
    else:
        log_p, p = LOG_SEG, SEG
        key = rows[:, 0].copy()

        def row_of(e):
            return e
    skey, spay = sort_elements(key, np.arange(p), log_p)
    # the limb-0 ties
    big = False
    i = 0
    while i < p:
        k = skey[i]
        end = i + 1
        while end < p and skey[end] == k:
            end += 1
        if k != SENTINEL and end - i > 1:
            if end - i <= SERIAL_TIE:
                group = sorted(spay[i:end].tolist(), key=lambda x: (
                    tuple(rows[row_of(x), 1:]), x))
                spay[i:end] = group
                path.add("serial tie")
            elif hashed or any(not np.array_equal(rows[row_of(x)],
                                                  rows[row_of(spay[i])])
                               for x in spay[i:end]):
                big = True
            else:
                path.add("one-row tie")
        i = end
    if big:
        path.add("lsd")
        # position i = t + r * holders loads into register r of thread t:
        # the load arrangement of sort_elements
        pos = np.arange(p)
        for j in range(q - 1, -1, -1):
            el = spay & MASK
            key = np.where(skey == SENTINEL, SENTINEL, rows[row_of(el), j])
            skey, spay = sort_elements(key, (pos << LOG_SEG) | el, log_p,
                                       "lexicographic")
            spay &= MASK
    if hashed:
        n = h.distinct
        return rows[row_of(spay[:n])], elem[spay[:n]] >> LOG_SEG, path
    live = skey != SENTINEL
    fresh = live.copy()
    for i in range(1, SEG):
        if fresh[i] and skey[i] == skey[i - 1]:
            fresh[i] = not np.array_equal(rows[spay[i]], rows[spay[i - 1]])
    start = np.flatnonzero(fresh)
    n_live = int(live.sum())
    ends = np.append(start[1:], n_live)
    return rows[spay[start]], (ends - start).astype(np.int64), path


def model_seg_dedup_wide(flat, seed=0, hash_fn=row_hash, ordered=True):
    """The kernel over a (N, Q) stream: per segment (keys, weights,
    path)."""
    n, q = flat.shape
    rng = np.random.default_rng(seed)
    out = []
    for s in range(-(-n // SEG)):
        seg = np.full((SEG, q), SENTINEL, dtype=np.int64)
        part = flat[s * SEG:(s + 1) * SEG]
        seg[:part.shape[0]] = part
        out.append(seg_dedup_wide_block(seg, part.shape[0], rng, hash_fn,
                                        ordered))
    return out


def check_against_plain(flat, out):
    want_keys, want_weights, want_counts = tdev.segment_runs_wide(
        segsort.segments(torch.from_numpy(flat), SENTINEL))
    assert [o[0].shape[0] for o in out] == want_counts.tolist()
    for s, (keys, weights, path) in enumerate(out):
        c = keys.shape[0]
        assert np.array_equal(keys, want_keys[s, :c].numpy())
        assert np.array_equal(weights, want_weights[s, :c].numpy())


def weight_sums(keys, weights):
    """{row: the sum of its weights} over a segment's live slots."""
    out = {}
    for row, w in zip(map(tuple, keys.tolist()), weights.tolist()):
        out[row] = out.get(row, 0) + w
    return out


def check_weight_sums(flat, out):
    """The unordered form's contract: each segment's weights sum, row by
    row, as the plain version's."""
    want_keys, want_weights, want_counts = tdev.segment_runs_wide(
        segsort.segments(torch.from_numpy(flat), SENTINEL))
    assert len(out) == want_counts.shape[0]
    for s, (keys, weights, path) in enumerate(out):
        c = int(want_counts[s])
        assert weight_sums(keys, weights) == weight_sums(
            want_keys[s, :c].numpy(), want_weights[s, :c].numpy())
        if path == {"pass"}:  # every live row in row order
            part = flat[s * SEG:(s + 1) * SEG]
            assert np.array_equal(keys, part[part[:, 0] != SENTINEL])


def pool(rng, n, q, limb0=None):
    rows = rng.integers(0, 1 << 62, (n, q))
    if limb0 is not None:
        rows[:, 0] = limb0
    return rows


def draw(rng, rows, n, first=None):
    """n rows of *rows*; the first 512 from rows[:first] when given (as
    consecutive reads repeat theirs)."""
    out = rows[rng.integers(0, rows.shape[0], n)]
    if first is not None:
        out[:THREADS] = rows[rng.integers(0, first, THREADS)]
    return out


def segment(kind, q, rng):
    """One segment's rows (or a ragged tail) of *kind*."""
    if kind == "all-sentinel":
        return np.full((SEG, q), SENTINEL, dtype=np.int64)
    if kind == "all-distinct":
        return pool(rng, SEG, q)
    if kind == "one-run":
        return np.repeat(pool(rng, 1, q), SEG, axis=0)
    if kind == "ragged-tail":
        return draw(rng, pool(rng, 300, q), 5000)
    if kind == "40x":
        out = draw(rng, pool(rng, 1100, q), SEG)
        out[rng.random(SEG) < 0.05] = SENTINEL
        return out
    if kind == "last-limb":  # limb-0 ties of 4 rows, the hash's
        rows = np.repeat(pool(rng, 1000, q), 4, axis=0)
        rows[:, -1] = rng.integers(0, 1 << 62, rows.shape[0])
        return draw(rng, rows, SEG, first=400)
    if kind == "tied-distinct":  # every row on one limb 0, all distinct
        return pool(rng, SEG, q, limb0=7)
    if kind == "tied-40":  # random head, then 40 rows on one limb 0
        return np.concatenate([pool(rng, THREADS, q),
                               draw(rng, pool(rng, 40, q, limb0=5),
                                    SEG - THREADS)])
    if kind == "tied-one-row":  # random head, then one row repeated
        return np.concatenate([pool(rng, THREADS, q),
                               np.repeat(pool(rng, 1, q), SEG - THREADS,
                                         axis=0)])
    if kind == "tied-pairs":  # random head, then ties of 2 duplicated
        rows = np.repeat(pool(rng, 500, q), 2, axis=0)
        rows[1::2, 1:] = rng.integers(0, 1 << 62, (500, q - 1))
        return np.concatenate([pool(rng, THREADS, q),
                               draw(rng, rows, SEG - THREADS)])
    if kind == "hash-tie-40":  # the hash's rows, 40 of them on limb 0
        rows = np.concatenate([pool(rng, 1000, q), pool(rng, 40, q, 9)])
        return draw(rng, rows, SEG, first=100)
    if kind == "past-limit":  # a repeating head, then 7,680 distinct
        return np.concatenate([draw(rng, pool(rng, 100, q), THREADS),
                               pool(rng, SEG - THREADS, q)])
    raise ValueError(kind)


# kind: the steps the kernel takes on it
KINDS = {
    "all-sentinel": {"hash"},
    "all-distinct": {"sort"},
    "one-run": {"hash"},
    "ragged-tail": {"hash"},
    "40x": {"hash"},
    "last-limb": {"hash", "serial tie"},
    "tied-distinct": {"sort", "lsd"},
    "tied-40": {"sort", "lsd"},
    "tied-one-row": {"sort", "one-row tie"},
    "tied-pairs": {"sort", "serial tie"},
    "hash-tie-40": {"hash", "lsd"},
    "past-limit": {"sort", "serial tie"},  # the head's duplicates tie
}


@pytest.mark.parametrize(
    "q,ordered", [(2, True), (3, True), (7, True)]
    + [(q, False) for q in range(2, 8)],
    ids=["2", "3", "7"] + [f"{q}-unordered" for q in range(2, 8)])
@pytest.mark.parametrize("kind", list(KINDS))
def test_model_matches_segment_runs_wide(kind, q, ordered):
    rng = np.random.default_rng(len(kind) + q)
    flat = segment(kind, q, rng).astype(np.int64)
    out = model_seg_dedup_wide(flat, q, ordered=ordered)
    live = flat[flat[:, 0] != SENTINEL]
    if ordered:
        assert out[0][2] == KINDS[kind]
        check_against_plain(flat, out)
    else:
        passed = "sort" in KINDS[kind]  # the hash gave up
        assert out[0][2] == ({"pass"} if passed else {"hash"})
        check_weight_sums(flat, out)
        if passed:  # every live row, weight 1
            assert weight_sums(out[0][0], out[0][1]) == weight_sums(
                live, np.ones(live.shape[0], dtype=np.int64))
            assert out[0][0].shape == live.shape
    assert int(out[0][1].sum()) == live.shape[0]


def test_model_over_segments_and_a_ragged_tail():
    rng = np.random.default_rng(11)
    flat = np.concatenate([segment(kind, 3, rng) for kind in (
        "40x", "all-distinct", "last-limb", "all-sentinel", "tied-pairs",
        "ragged-tail")]).astype(np.int64)
    out = model_seg_dedup_wide(flat, 11)
    assert [sorted(o[2]) for o in out] == [
        ["hash"], ["sort"], ["hash", "serial tie"], ["hash"],
        ["serial tie", "sort"], ["hash"]]
    check_against_plain(flat, out)
    out = model_seg_dedup_wide(flat, 11, ordered=False)
    paths = [o[2] for o in out]
    assert paths == [{"hash"}, {"pass"}, {"hash"}, {"hash"}, {"pass"},
                     {"hash"}]
    assert sum(p == {"pass"} for p in paths) == 2
    check_weight_sums(flat, out)


@pytest.mark.parametrize("fingerprint", ["one slot", "one word"])
def test_forced_fingerprint_collisions(fingerprint):
    """Every row hashed to one start slot (and, for "one word", to one
    fingerprint, so every claimed slot is compared on all limbs): the
    probes chain, rows are told apart by their limbs, and the result is
    the same."""
    rng = np.random.default_rng(3)
    flat = draw(rng, pool(rng, 200, 3), SEG, first=50).astype(np.int64)
    if fingerprint == "one slot":
        def hash_fn(row):
            return (5 << 51) | (row_hash(row) & ((1 << 51) - 1))
    else:
        def hash_fn(_row):
            return 5 << 51
    out = model_seg_dedup_wide(flat, 3, hash_fn)
    assert out[0][2] == {"hash"}
    check_against_plain(flat, out)
    h = Hash(flat, SEG, rng, hash_fn)
    assert h.distinct == 200 and h.max_probe == 199


def test_hash_gives_up_on_a_random_first_round():
    """2,000 distinct rows take the hash unless more than 7/8 of the
    live rows among the first 512 are distinct; then all rows are
    sorted, with the same result."""
    rng = np.random.default_rng(5)
    rows = pool(rng, 2000, 3)
    grouped = draw(rng, rows, SEG, first=100)
    spread = np.concatenate([rows[:THREADS], draw(rng, rows,
                                                  SEG - THREADS)])
    for flat, path in ((grouped, {"hash"}), (spread, {"sort"})):
        out = model_seg_dedup_wide(flat.astype(np.int64), 5)
        assert out[0][2] - {"serial tie"} == path
        check_against_plain(flat.astype(np.int64), out)


def test_hash_never_fills_and_gives_up_past_the_limit():
    """The 6,145th distinct row sets the flag; each thread may claim one
    slot more before it sees it, so at most 6,144 + 512 of the 8,192
    slots are ever claimed, every probe ends, and the compacted elements
    fit 13 bits with counts up to 8,192 beside them."""
    assert LIMIT + THREADS < SLOTS
    assert (SEG << LOG_SEG | MASK) < 1 << 31
    rng = np.random.default_rng(9)
    flat = segment("past-limit", 3, rng).astype(np.int64)
    h = Hash(flat, SEG, rng)
    assert h.distinct == -1
    assert sum(w != 0 for w in h.word) <= LIMIT + THREADS
