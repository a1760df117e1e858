"""A CPU model of kernel K9d (``csrc/seg_sort.cu``, ``seg_dedup_kernel``),
held against its plain version ``dev.segment_runs``.  Integer outputs,
exact equality.

The CUDA kernel runs only on the card; this file transcribes its steps
in numpy so the index arithmetic is proven on the CPU: the register
bitonic network of ``block_sort`` (element 16 t + r in register r of
thread t; strides 1..8 between registers, 16..256 by lane-xor shuffles
inside a warp, 512..4096 in the transposed layout t + 512 r through the
XOR-swizzled shared buffer, whose 8-byte accesses this checks are free
of bank conflicts), the shared-memory hash (Fibonacci slot, linear
probing, the 3,072-key limit, the give-up when more than 7/8 of the live
keys among the first 512 rows are distinct, and the fallback to a sort
of all 8,192
rows), the compaction of the occupied slots by an exclusive scan, the
sort of p = max(512, 2^ceil(log2(distinct))) compacted keys on p / 16
threads, the weights read back from the hash, and the fallback's run
starts and run lengths by a packed block scan, read out through shared
memory.  The unordered form too: after the same hash, no sort; a kept
segment's distinct keys with their counts in slot order, a segment the
hash gave up on passed through (every live key, weight 1) in row order,
both placed by ``block_sort.cuh``'s ``RowOrder`` (a ballot a warp and
round, one block scan); it is held to the looser contract, key by key
the same weight sums as the plain version.
The model is on no path.
"""

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import segsort
from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL

SEG = segsort.SEGMENT
# csrc/seg_sort.cu
THREADS, REGS, LOG_SEG = 512, 16, 13
HASH_SLOTS, HASH_LIMIT = 4096, 3072
FIB = 0x9E3779B97F4A7C15


def swizzle(i):
    return i ^ ((i >> 4) & 15)


def compare_exchange(a, b, ascending):
    """(a, b) after the pair's compare-exchange, a at the lower position;
    *ascending* a bool or a bool array."""
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    return np.where(ascending, lo, hi), np.where(ascending, hi, lo)


def block_sort(key, log_p, buf):
    """``block_sort``: *key* is (THREADS, REGS), element 16 t + r at
    key[t, r] for the p / 16 holders; *buf* the shared buffer (p slots).
    Rows past the holders are garbage in the natural layout."""
    p = 1 << log_p
    holders = p // REGS
    n_tr = p >> 9
    assert holders % 32 == 0  # shuffles take whole warps
    t_all = np.arange(THREADS)[:, None]
    t_h = np.arange(holders)[:, None]
    r = np.arange(REGS)[None, :]
    natural = swizzle(t_h * REGS + r)
    transposed = swizzle(t_all + (np.arange(n_tr)[None, :] << 9))
    assert natural.max() < p and transposed.max(initial=0) < p
    for j in range(1, log_p + 1):
        if j > 9:
            buf[natural] = key[:holders]
            key[:, :n_tr] = buf[transposed]
            for b in range(LOG_SEG - 1, 8, -1):
                if b >= j:
                    continue
                rb = 1 << (b - 9)
                for rr in range(n_tr):
                    if rr & rb == 0:
                        key[:, rr], key[:, rr | rb] = compare_exchange(
                            key[:, rr], key[:, rr | rb],
                            ((rr >> (j - 9)) & 1) == 0)
            buf[transposed] = key[:, :n_tr]
            key[:holders] = buf[natural]
        t = np.arange(holders)
        for b in range(8, 3, -1):
            if b >= j:
                continue
            lanes = 1 << (b - 4)
            partner = t ^ lanes
            assert (partner >> 5 == t >> 5).all()  # inside the warp
            other = key[partner].copy()
            keep_min = ((((t >> (j - 4)) & 1) == 0)
                        == ((t & lanes) == 0))[:, None]
            mine = key[:holders]
            key[:holders] = np.where(keep_min, np.minimum(mine, other),
                                     np.maximum(mine, other))
        for b in range(3, -1, -1):
            if b >= j:
                continue
            rb = 1 << b
            for rr in range(REGS):
                if rr & rb == 0:
                    key[:holders, rr], key[:holders, rr | rb] = (
                        compare_exchange(key[:holders, rr],
                                         key[:holders, rr | rb],
                                         (((t * REGS + rr) >> j) & 1) == 0))
    return key


def hash_slot(k):
    return ((int(k) * FIB) & ((1 << 64) - 1)) >> 52


def exclusive_sum(v):
    """``block_exclusive_sum``: (exclusive sums, total)."""
    c = np.cumsum(v)
    return c - v, int(c[-1])


def write_runs(key):
    """``write_runs`` over the natural layout of all 512 threads: run
    starts by the packed scan, then the rows read out of the swizzled
    sorted keys and the start array in rank order (coalesced)."""
    sorted_buf = np.full(SEG, -5, dtype=np.int64)
    pos_all = np.arange(THREADS)[:, None] * REGS + np.arange(REGS)[None, :]
    sorted_buf[swizzle(pos_all)] = key
    before = np.concatenate([[SENTINEL], key[:-1, -1]])
    prev = np.concatenate([before[:, None], key[:, :-1]], axis=1)
    live = key != SENTINEL
    starts = live & (key != prev)
    packed = (starts.sum(1) + (live.sum(1) << 16)).astype(np.int64)
    exclusive, total = exclusive_sum(packed)
    n_runs, n_live = total & 0xFFFF, total >> 16
    start = np.full(SEG, -7)  # garbage past n_runs
    pos = np.arange(THREADS)[:, None] * REGS + np.arange(REGS)[None, :]
    ranks = (exclusive & 0xFFFF)[:, None] + np.cumsum(starts, 1) - starts
    start[ranks[starts]] = pos[starts]
    out_keys = np.full(SEG, -9, dtype=np.int64)  # unwritten slots
    out_weights = np.full(SEG, -9, dtype=np.int64)
    q = np.arange(n_runs)
    pos_q = start[q]
    end = np.where(q + 1 < n_runs, start[np.minimum(q + 1, SEG - 1)],
                   n_live)
    out_keys[q] = sorted_buf[swizzle(pos_q)]
    out_weights[q] = end - pos_q
    return out_keys, out_weights, n_runs


def row_order(live):
    """``RowOrder`` over a segment's elements t + 512 r (*live*, flat in
    element order, 512 a round): the places of the live ones, in element
    order.  A ballot counts each warp's live lanes a round, one block
    scan turns the (round, warp) counts into first places, and a second
    ballot ranks each live lane among its warp's."""
    lanes = live.reshape(-1, THREADS // 32, 32)
    first, _total = exclusive_sum(lanes.sum(2).reshape(-1))
    rank = np.cumsum(lanes, 2) - lanes
    return (first.reshape(lanes.shape[:2])[:, :, None] + rank)[lanes]


def write_unordered(raw, hkey, hcount, gave_up):
    """``write_unordered``: (keys, weights, count, path), the path
    "pass" for a segment passed through (its rows in row order), "hash"
    for one the hash kept (its slots in slot order)."""
    out_keys = np.full(SEG, -9, dtype=np.int64)  # unwritten slots
    out_weights = np.full(SEG, -9, dtype=np.int64)
    values, weights = (raw, np.ones_like(raw)) if gave_up else (hkey, hcount)
    live = values != SENTINEL
    places = row_order(live)
    assert np.array_equal(places, np.arange(places.size))
    out_keys[places] = values[live]
    out_weights[places] = weights[live]
    return out_keys, out_weights, places.size, "pass" if gave_up else "hash"


def seg_dedup_block(raw, rng, hash_first=True, ordered=True):
    """``seg_dedup_kernel`` on one segment's 8,192 raw keys (sentinel
    padded); inserts race in the order *rng* draws.  *hash_first* False
    takes the sort of all rows at once, the path of a segment whose hash
    gives up; *ordered* False the unordered form (after the hash).
    Returns (keys, weights, count, path)."""
    # thread t takes rows t + 512 r as its elements 16 t + r
    key = raw.reshape(REGS, THREADS).T.copy()
    if hash_first:
        hkey = np.full(HASH_SLOTS, SENTINEL, dtype=np.int64)
        hcount = np.zeros(HASH_SLOTS, dtype=np.int64)
        n_distinct, overflow = 0, False
        # the first round (rows 0..511, one a thread), a barrier, the
        # uniform give-up test, then the other rows racing
        first = raw[:THREADS][rng.permutation(THREADS)]
        rest = raw[THREADS:][rng.permutation(SEG - THREADS)]
        n_live = int((first != SENTINEL).sum())
        for n_row, k in enumerate(np.concatenate([first, rest])):
            if n_row == THREADS and n_distinct * 8 > n_live * 7:
                overflow = True
            if k == SENTINEL:
                continue
            if overflow:
                break  # (each thread stops at its next key)
            s = hash_slot(k)
            while hkey[s] not in (SENTINEL, k):
                s = (s + 1) & (HASH_SLOTS - 1)
            if hkey[s] == SENTINEL:
                hkey[s] = k
                overflow |= n_distinct >= HASH_LIMIT
                n_distinct += 1
            hcount[s] += 1
        if not ordered:
            return write_unordered(raw, hkey, hcount, overflow)
        if not overflow:
            per = HASH_SLOTS // THREADS
            occupied = (hkey != SENTINEL).reshape(THREADS, per)
            pos, distinct = exclusive_sum(occupied.sum(1))
            buf = np.full(HASH_SLOTS, -5, dtype=np.int64)  # garbage
            for t in range(THREADS):
                for m in np.flatnonzero(occupied[t]):
                    buf[pos[t]] = hkey[t * per + m]
                    pos[t] += 1
            log_p = max(9, (distinct - 1).bit_length())
            assert log_p <= 12
            holders = (1 << log_p) // REGS
            i = np.arange(holders)[:, None] + np.arange(REGS)[None, :] * holders
            key[:holders] = np.where(i < distinct, buf[np.minimum(i, 4095)],
                                     SENTINEL)
            block_sort(key, log_p, buf)
            # the sorted keys through buf, read back in coalesced order
            t_h = np.arange(holders)[:, None] * REGS + np.arange(REGS)[None, :]
            buf[swizzle(t_h)] = key[:holders]
            out_keys = np.full(SEG, -9, dtype=np.int64)
            out_weights = np.full(SEG, -9, dtype=np.int64)
            for i in range(distinct):
                k = buf[swizzle(i)]
                s = hash_slot(k)
                while hkey[s] != k:
                    s = (s + 1) & (HASH_SLOTS - 1)
                out_keys[i], out_weights[i] = k, hcount[s]
            return out_keys, out_weights, distinct, "hash"
    block_sort(key, LOG_SEG, np.full(SEG, -5, dtype=np.int64))
    return (*write_runs(key), "sort")


def model_seg_dedup(flat, seed=0, hash_first=True, ordered=True):
    """The kernel over a flat stream: (S, 8192) keys and weights, (S,)
    counts, and each segment's path."""
    n_seg = -(-flat.size // SEG)
    padded = np.full(n_seg * SEG, SENTINEL, dtype=np.int64)
    padded[:flat.size] = flat
    rng = np.random.default_rng(seed)
    out = [seg_dedup_block(padded[s * SEG:(s + 1) * SEG], rng, hash_first,
                           ordered)
           for s in range(n_seg)]
    return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out]),
            np.array([o[2] for o in out]), [o[3] for o in out])


def segment(kind, rng):
    """8,192 keys (or a ragged tail) of one kind of segment."""
    live = rng.integers(0, 1 << 62, 5000, dtype=np.int64)
    if kind == "all-sentinel":
        return np.full(SEG, SENTINEL, dtype=np.int64)
    if kind == "all-distinct":
        return rng.permutation(np.arange(SEG, dtype=np.int64) * 977 + 3)
    if kind == "one-run":
        return np.full(SEG, 4 ** 31 - 1, dtype=np.int64)
    if kind == "padded-tail":
        return rng.choice(live[:300], 5000)
    if kind == "random+sentinels":
        out = rng.integers(0, 1 << 62, SEG, dtype=np.int64)
        out[rng.random(SEG) < 0.1] = SENTINEL
        return out
    if kind == "40x":  # ~1,090 keys of ~7.5 copies
        return rng.choice(live[:1090], SEG)
    distinct = int(kind.split("-")[0])  # "<n>-distinct"
    repeats = rng.choice(live[:distinct], SEG - distinct)
    repeats[rng.random(repeats.size) < 0.05] = SENTINEL
    return rng.permutation(np.concatenate([live[:distinct], repeats]))


KINDS = ("all-sentinel", "all-distinct", "one-run", "padded-tail",
         "random+sentinels", "40x", "1-distinct", "511-distinct",
         "512-distinct", "513-distinct", "1024-distinct", "1025-distinct",
         "2048-distinct", "2049-distinct", "3072-distinct", "3073-distinct",
         "4097-distinct")


def weight_sums(keys, weights):
    """{key: the sum of its weights} over a segment's live slots."""
    out = {}
    for k, w in zip(keys.tolist(), weights.tolist()):
        out[k] = out.get(k, 0) + w
    return out


def gives_up(flat):
    """Whether the hash gives up on the segment *flat* (past the key
    limit, or more than 7/8 of the live keys of its first 512 rows
    distinct)."""
    live = flat[flat != SENTINEL]
    first = flat[:THREADS]
    first_live = first[first != SENTINEL]
    return (np.unique(live).size > HASH_LIMIT
            or np.unique(first_live).size * 8 > first_live.size * 7)


@pytest.mark.parametrize("hash_first,ordered",
                         [(True, True), (False, True), (True, False)],
                         ids=["hash", "sort", "unordered"])
@pytest.mark.parametrize("kind", KINDS)
def test_model_matches_segment_runs(kind, hash_first, ordered):
    rng = np.random.default_rng(len(kind))
    flat = segment(kind, rng)
    keys, weights, counts, paths = model_seg_dedup(flat, len(kind),
                                                   hash_first, ordered)
    want_keys, want_weights, want_counts = tdev.segment_runs(
        segsort.segments(torch.from_numpy(flat), SENTINEL))
    live = flat[flat != SENTINEL]
    if ordered:
        assert np.array_equal(counts, want_counts.numpy())
        for s, c in enumerate(counts):
            assert np.array_equal(keys[s, :c], want_keys[s, :c].numpy())
            assert np.array_equal(weights[s, :c],
                                  want_weights[s, :c].numpy())
    else:
        # the looser contract: key by key the same weight sums
        c, want_c = int(counts[0]), int(want_counts[0])
        assert weight_sums(keys[0, :c], weights[0, :c]) == weight_sums(
            want_keys[0, :want_c].numpy(), want_weights[0, :want_c].numpy())
        if paths == ["pass"]:  # every live key in row order, weight 1
            assert np.array_equal(keys[0, :c], live)
            assert (weights[0, :c] == 1).all()
        else:
            assert c == want_c
    if hash_first:
        gave_up = gives_up(flat)
        assert paths == [("pass" if not ordered else "sort") if gave_up
                         else "hash"]
    assert int(weights[0, :counts[0]].sum()) == live.size


def test_model_matches_segment_runs_over_segments():
    """Five segments, one of each path, and a ragged tail; in the
    unordered form the two the hash gives up on are passed through, and
    every segment's weights sum key by key as the plain version's."""
    rng = np.random.default_rng(3)
    flat = np.concatenate([segment(kind, rng) for kind in (
        "40x", "random+sentinels", "all-sentinel", "3073-distinct",
        "padded-tail")])
    keys, weights, counts, paths = model_seg_dedup(flat, 3)
    assert paths == ["hash", "sort", "hash", "sort", "hash"]
    want = tdev.segment_runs(segsort.segments(torch.from_numpy(flat),
                                              SENTINEL))
    assert np.array_equal(counts, want[2].numpy())
    got = tdev.segment_compact(torch.from_numpy(keys),
                               torch.from_numpy(weights),
                               torch.from_numpy(counts))
    for g, w in zip(got, tdev.segment_compact(*want)):
        assert torch.equal(g, w)
    keys, weights, counts, paths = model_seg_dedup(flat, 3, ordered=False)
    assert paths == ["hash", "pass", "hash", "pass", "hash"]
    assert paths.count("pass") == 2
    for s, c in enumerate(counts):
        c_want = int(want[2][s])
        assert weight_sums(keys[s, :c], weights[s, :c]) == weight_sums(
            want[0][s, :c_want].numpy(), want[1][s, :c_want].numpy())
        if paths[s] == "pass":  # every live key in row order
            part = flat[s * SEG:(s + 1) * SEG]
            assert np.array_equal(keys[s, :c], part[part != SENTINEL])


@pytest.mark.parametrize("log_p", [9, 10, 11, 12, 13])
def test_block_sort_sorts_any_input(log_p):
    """The register network sorts p keys with many ties, sentinels among
    them, and leaves the non-holders' natural rows unread."""
    rng = np.random.default_rng(log_p)
    p = 1 << log_p
    key = rng.integers(-3, 3, (THREADS, REGS)).astype(np.int64)
    key[:p // REGS][rng.random((p // REGS, REGS)) < 0.1] = SENTINEL
    want = np.sort(key[:p // REGS].reshape(-1))
    key[p // REGS:] = 99  # garbage that must not leak in
    got = block_sort(key, log_p, np.full(p, -5, dtype=np.int64))
    assert np.array_equal(got[:p // REGS].reshape(-1), want)


@pytest.mark.parametrize("layout", ["natural", "transposed"])
def test_swizzle_is_free_of_bank_conflicts(layout):
    """Every 8-byte shared access of a half-warp hits 16 distinct bank
    pairs (32 banks of 4 bytes) in both layouts, for every register."""
    t = np.arange(THREADS)
    for r in range(REGS):
        i = t * REGS + r if layout == "natural" else t + (r << 9)
        slot = swizzle(i)
        assert np.unique(slot).size == THREADS
        pairs = (slot % 16).reshape(-1, 16)
        assert all(np.unique(row).size == 16 for row in pairs)


def test_hash_gives_up_on_a_random_first_round():
    """A segment of 2,000 distinct keys takes the hash, unless more than
    7/8 of the live keys of its first 512 rows (one a thread, read before
    a barrier) are distinct, sentinels not counted: then all rows are
    sorted, with the same result."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 62, 2000, dtype=np.int64)
    grouped = np.sort(rng.choice(keys, SEG))  # first rows repeat: hash
    spread = np.concatenate([keys[:512], rng.choice(keys, SEG - 512)])
    sparse = spread.copy()  # 150 sentinels among the first rows
    sparse[rng.choice(512, 150, replace=False)] = SENTINEL
    for flat, path in ((grouped, "hash"), (spread, "sort"),
                       (sparse, "sort")):
        want = tdev.segment_runs(segsort.segments(torch.from_numpy(flat),
                                                  SENTINEL))
        keys_m, weights_m, counts_m, paths = model_seg_dedup(flat, 1)
        assert paths == [path]
        assert np.array_equal(counts_m, want[2].numpy())
        c = int(counts_m[0])
        assert np.array_equal(keys_m[0, :c], want[0][0, :c].numpy())
        assert np.array_equal(weights_m[0, :c], want[1][0, :c].numpy())


def test_hash_never_fills_and_gives_up_past_the_limit():
    """Random keys: the 3,073rd distinct key sets the flag; each thread
    may claim one slot more before it sees it, so at most 3,072 + 512 of
    the 4,096 slots are ever claimed and every probe ends."""
    assert HASH_LIMIT + THREADS < HASH_SLOTS
    assert ((HASH_LIMIT - 1).bit_length()) <= 12  # p <= 4,096 slots of buf
    rng = np.random.default_rng(9)
    flat = rng.integers(0, 1 << 62, SEG, dtype=np.int64)
    assert model_seg_dedup(flat)[3] == ["sort"]
