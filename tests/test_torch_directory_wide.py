"""A CPU model of the wide-row probes K7 and K8 through a prefix
directory over limb 0 (``csrc/sorted_rows.cuh``, ``csrc/probe_wide.cu``,
``csrc/directory.cu``), held against the port's plain versions
(``ops/device.py``: ``member_wide``, ``find_rows_wide``,
``small_table_tally_wide``, ``weighted_tally_wide``).  Integer outputs,
exact equality.

The CUDA kernels run only on the card; this file transcribes their steps
in numpy so the arithmetic is proven on the CPU: the directory filled
from limb 0 read at a row stride of Q limbs, the search of one bucket
comparing limb 0 first and
the other limbs only on a tie, the query rows a thread takes per Q and
their sentinel padding, and K7's one add per hit.  The model is on no
path.  Last, ``build_directory`` of an (M, Q) table
and ``directory_for``'s refusal of another wide table's directory.
"""

import functools

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import directory as tdir
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL
from tests.test_torch_directory import bitlen, directory_shape, fill_directory

KS = (33, 63, 127, 151, 201, 207)
# 2**12 live rows take bits 12, one more takes bits 13 (directory_bits)
BITS_EDGE = (4096, 4097)
TIE_ROWS = 3000  # rows of the limb-0-tie table sharing their first 31 bases


def row_keys(q):
    """``kdf::row_keys<Q>()``: the query rows a thread takes."""
    return 4 if q <= 3 else 2


def fill_directory_strided(table, live, shift, bits):
    """``build_directory_kernel``: the directory from limb 0 read at a row
    stride of Q int64 in the flat (M * Q,) table."""
    q = table.shape[1]
    return fill_directory(table.reshape(-1)[np.arange(live) * q], live,
                          shift, bits)


def compare_tail(rows, q):
    """-1, 0 or 1 per pair as limbs 1..Q-1 of *rows* compare with those
    of *q* (limbs 0 tie): the first limb that differs decides."""
    out = np.zeros(rows.shape[0], dtype=np.int64)
    for l in range(rows.shape[1] - 1, 0, -1):
        diff = rows[:, l] != q[:, l]
        out = np.where(diff, np.where(rows[:, l] < q[:, l], -1, 1), out)
    return out


def find_rows_dir_wide(table, d, shift, bits, q):
    """``kdf::find_rows_dir_wide`` for every query row: the row of each in
    *table*, or -1.  A probe reads limb 0 of its row and, when that ties
    the query's, the row's other limbs.  Asserts each probe lies in its
    key's bucket and no key takes more than bitlen(bucket rows) probes;
    returns (rows, tie reads)."""
    q0 = q[:, 0]
    p = q0.view(np.uint64) >> np.uint64(shift)
    inb = (q0 != SENTINEL) & ((p >> np.uint64(bits)) == 0)
    pi = np.where(inb, p, 0).astype(np.int64)
    lo = np.where(inb, d[pi], 0)
    hi = np.where(inb, d[np.minimum(pi + 1, d.size - 1)], 0)
    base, left = lo - 1, hi - lo
    eq = np.zeros(q0.shape, dtype=bool)
    probes = np.zeros(q0.shape, dtype=np.int64)
    ties = 0
    while (left > 0).any():
        act = left > 0
        half = (left + 1) >> 1
        mid = base + half
        assert ((mid[act] >= lo[act]) & (mid[act] < hi[act])).all()
        at = np.where(act, mid, 0)
        v = table[at, 0]
        cmp = np.where(v < q0, -1, np.where(v > q0, 1, 0))
        tie = act & (cmp == 0)
        ties += int(tie.sum())
        cmp = np.where(tie, compare_tail(table[at], q), cmp)
        below = act & (cmp < 0)
        at_or_above = act & (cmp >= 0)
        base = np.where(below, mid, base)
        left = np.where(below, left - half,
                        np.where(at_or_above, half - 1, left))
        eq = np.where(at_or_above, cmp == 0, eq)
        probes += act
    assert (probes <= bitlen(hi - lo)).all()
    return np.where(eq, base + 1, -1), ties


def probe_groups_wide(table, d, shift, bits, keys):
    """``load_rows`` + ``find_rows_dir_wide`` + ``store_group``: groups of
    row_keys(Q) consecutive rows, the last padded with sentinel rows,
    the rows of the n keys kept."""
    n, q = keys.shape
    k = row_keys(q)
    padded = np.full((-(-n // k) * k, q), SENTINEL, dtype=np.int64)
    padded[:n] = keys
    rows, _ties = find_rows_dir_wide(table, d, shift, bits, padded)
    assert (rows[n:] == -1).all()
    return rows[:n]


def random_rows(rng, k, n):
    """n random limb rows of k bases (not canonical: the search does not
    care), unsorted, possibly repeating."""
    return np.stack([rng.integers(0, 4 ** nb, n, dtype=np.int64)
                     for nb in keys64.limb_bases(k)], 1)


def unique_sorted(rows):
    return np.unique(rows, axis=0)


@functools.lru_cache(maxsize=None)
def make_table_wide(kind, k):
    """Sorted (M, Q) table of *kind*: M random rows, all sentinel, 3,000
    rows then 7 sentinel rows, or the limb-0-tie table (the wide poly-A
    case): TIE_ROWS rows whose first 31 bases are all A (limb 0 = 0),
    1,000 more with limb 0 = 1, and 2,000 spread rows."""
    rng = np.random.default_rng(k)
    q = keys64.limbs_per_kmer(k)
    if kind == "all-sentinel":
        return np.full((5, q), SENTINEL, dtype=np.int64)
    if kind == "trailing-sentinels":
        live = unique_sorted(random_rows(rng, k, 3000))
        return np.concatenate([live, np.full((7, q), SENTINEL,
                                             dtype=np.int64)])
    if kind == "limb-0-tie":
        tie = random_rows(rng, k, 2 * TIE_ROWS)
        tie[:, 0] = 0
        tie = unique_sorted(tie)[:TIE_ROWS]
        near = random_rows(rng, k, 1000)
        near[:, 0] = 1
        rows = np.concatenate([tie, near, random_rows(rng, k, 2000)])
        return unique_sorted(rows)
    m = int(kind)
    rows = unique_sorted(random_rows(rng, k, m + m // 8 + 16))
    return rows[np.sort(rng.choice(rows.shape[0], m, replace=False))]


def queries_wide(table, k):
    """Every live row; 500 of them each with its last limb +- 1, with
    limb 0 +- 1 (another bucket) and with limb 0 kept but the rest
    random (a limb-0 tie that is absent); random rows; a sentinel row;
    limb 0 past the last live one and 2**62 - 1."""
    q = table.shape[1]
    live = table[table[:, 0] != SENTINEL]
    rng = np.random.default_rng(k + 7)
    parts = [live, random_rows(rng, k, 500)]
    some = live[rng.integers(0, live.shape[0], 500)] if live.size else live
    for limb, delta in ((q - 1, 1), (q - 1, -1), (0, 1), (0, -1)):
        moved = some.copy()
        moved[:, limb] = np.maximum(moved[:, limb] + delta, 0)
        parts.append(moved)
    tied = random_rows(rng, k, some.shape[0])
    tied[:, 0] = some[:, 0]
    parts.append(tied)
    special = np.zeros((3, q), dtype=np.int64)
    special[0] = SENTINEL
    special[1, 0] = int(live[-1, 0]) + 1 if live.size else 1
    special[2, 0] = (1 << 62) - 1
    parts.append(special)
    rows = np.concatenate(parts)
    return rows[rng.permutation(rows.shape[0])]


def _global(table):
    live = int((table[:, 0] != SENTINEL).sum())
    bits, shift = directory_shape(live, table[live - 1, 0] if live else 0)
    return live, bits, shift, fill_directory_strided(table, live, shift,
                                                     bits)


TABLES = ("1", "2", "all-sentinel", "trailing-sentinels", "limb-0-tie")


def _cases():
    """(kind, k): the small tables and the directory's bits edge at every
    k."""
    cases = [(kind, k) for k in KS
             for kind in TABLES + tuple(str(m) for m in BITS_EDGE)]
    return sorted(cases, key=lambda c: (c[1], c[0]))


CASES = _cases()


@pytest.mark.parametrize("kind,k", CASES)
def test_fill_directory_strided_matches_plain(kind, k):
    """The model's strided fill equals ``plain_directory`` of the (M, Q)
    table (over limb 0) and ``build_directory``'s plain version."""
    table = make_table_wide(kind, k)
    live, bits, shift, d = _global(table)
    t = torch.from_numpy(table)
    assert np.array_equal(d, tdir.plain_directory(t, live, bits,
                                                  shift).numpy())
    assert np.array_equal(d, tdir.plain_directory(
        t[:, 0].contiguous(), live, bits, shift).numpy())
    built = tdir.build_directory(t)
    assert (built.bits, built.shift, built.live) == (bits, shift, live)
    assert np.array_equal(built.offsets.numpy(), d)
    if live:
        assert table[live - 1, 0] >> shift < 1 << bits


@pytest.mark.parametrize("kind,k", CASES)
def test_member_search_matches_plain(kind, k):
    """K8's rows and found bytes through the directory equal
    ``dev.find_rows_wide`` / ``dev.member_wide``."""
    table = make_table_wide(kind, k)
    live, bits, shift, d = _global(table)
    q = queries_wide(table, k)
    t, tq = torch.from_numpy(table), torch.from_numpy(q)
    want_rows = tdev.find_rows_wide(t, tq).numpy()
    want_found = tdev.member_wide(t, tq).numpy()
    rows = probe_groups_wide(table, d, shift, bits, q)
    assert np.array_equal(rows, want_rows)
    assert np.array_equal(rows >= 0, want_found)
    if live:
        assert want_found.any() and not want_found.all()


@pytest.mark.parametrize("kind,k", CASES)
def test_tally_matches_plain(kind, k):
    """K7, one add per hit, unweighted on a stream that repeats rows and
    weighted on its dedup, equals ``dev.small_table_tally_wide`` and
    ``dev.weighted_tally_wide``."""
    table = make_table_wide(kind, k)
    live, bits, shift, d = _global(table)
    rng = np.random.default_rng(k)
    q = queries_wide(table, k)
    q = np.concatenate([q, q[rng.integers(0, q.shape[0], q.shape[0])]])
    t = torch.from_numpy(table)
    want = tdev.small_table_tally_wide(t, torch.from_numpy(q)).numpy()
    uniq, weights = tdev.dedup_windows_wide(torch.from_numpy(q))
    want_w = tdev.weighted_tally_wide(
        t, uniq, weights, torch.zeros(table.shape[0],
                                      dtype=torch.int64)).numpy()
    assert np.array_equal(want, want_w)
    for keys, w in ((q, None), (uniq.numpy(), weights.numpy())):
        add = np.ones(keys.shape[0], np.int64) if w is None else w
        acc = np.zeros(table.shape[0], dtype=np.int64)
        rows = probe_groups_wide(table, d, shift, bits, keys)
        np.add.at(acc, rows[rows >= 0], add[rows >= 0])
        assert np.array_equal(acc, want)


@pytest.mark.parametrize("k", KS)
def test_limb_0_tie_bucket_is_searched_exactly(k):
    """The rows that share limb 0 = 0 (TIE_ROWS, or all 4**(k - 31) of
    them at k = 33) fill one bucket: each is found at its own row after
    bitlen(bucket) probes, every probe of them a tie that reads the other
    limbs."""
    table = make_table_wide("limb-0-tie", k)
    live, bits, shift, d = _global(table)
    n_tie = int((table[:, 0] == 0).sum())
    assert n_tie == min(TIE_ROWS, 4 ** (k - 31))
    assert d[0] == 0 and d[1] >= n_tie
    tie = table[:n_tie]
    rows, ties = find_rows_dir_wide(table, d, shift, bits, tie)
    assert np.array_equal(rows, np.arange(n_tie))
    assert ties >= n_tie


@pytest.mark.parametrize("q", range(2, 8))
def test_thread_rows_are_whole_16_byte_loads(q):
    """A thread's rows are 8Q x keys contiguous bytes, a whole number of
    16-byte loads, and a tail group is padded with sentinel rows that
    are never found."""
    assert (8 * q * row_keys(q)) % 16 == 0
    table = make_table_wide("2", 31 * q)
    live, bits, shift, d = _global(table)
    keys = table[:1]
    rows = probe_groups_wide(table, d, shift, bits, keys)
    assert rows.tolist() == [0]


def test_build_directory_of_a_wide_table():
    """``build_directory`` of an (M, Q) table equals ``plain_directory``
    over limb 0, as an (M,) table of those keys gets it."""
    table = torch.from_numpy(make_table_wide("trailing-sentinels", 63))
    wide = tdir.build_directory(table)
    narrow = tdir.build_directory(table[:, 0].contiguous())
    assert (wide.bits, wide.shift, wide.live) == (narrow.bits, narrow.shift,
                                                  narrow.live) != (0, 0, 0)
    assert torch.equal(wide.offsets, narrow.offsets)
    assert tdir.directory_for(table, wide) is wide
    assert tdir.directory_for(table, None).offsets.equal(wide.offsets)


@pytest.mark.parametrize("other", ["same-size table", "copy", "narrow",
                                   "prefix"])
def test_directory_for_refuses_another_wide_tables_directory(other):
    """A directory built from another wide table is refused: one of the
    same size and bits, a copy in other memory, the (M,) limb-0 column
    of the same table, or a view of part of it."""
    t = torch.from_numpy(make_table_wide("4096", 63))
    if other == "same-size table":
        foreign = torch.from_numpy(make_table_wide("4096", 93))
    elif other == "copy":
        foreign = t.clone()
    elif other == "narrow":
        foreign = t[:, 0].contiguous()
    else:
        foreign = t[:4095]
    d = tdir.build_directory(foreign)
    with pytest.raises(ValueError, match="does not belong"):
        tdir.directory_for(t, d)
