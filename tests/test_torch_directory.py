"""A CPU model of the prefix-directory probe of kernels K2 and K4
(``csrc/sorted_table.cuh``, ``csrc/directory.cu``, ``probe_member.cu``,
``probe_tally.cu``), held against the port's plain versions.  Integer
outputs, exact equality.

The CUDA kernels run only on the card; this file transcribes their steps
in numpy so the arithmetic is proven on the CPU: the directory's sizing
(bits, shift from the last live key), ``fill_directory`` (each row fills
the prefixes after its predecessor's, items past the last row fill the
tail; every entry written exactly once, from garbage), the staged
form's uint16 copy of the directory, the launch's staged-or-global
choice by shared-memory bytes, the groups of four keys padded with the
sentinel, the bounded lower-bound search of one bucket (every probe
inside the bucket, at most bitlen(bucket rows) of them) and K2's
block-private counts flushed once per block and row.  The model is on
no path.  The launch plan under a launch override (``LaunchOverride``:
the form, threads a block, a cap on blocks an SM) is pinned with it:
the default is the plan of an H100 SXM, number for number, and the
wrappers validate an override on the CPU and give the plain result.
Last, ``directory_for`` refuses a directory built from another table.
"""

import functools

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import directory as tdir
from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL
from kmer_denovo_filter_tpu_torch.ops.member import probe_member
from kmer_denovo_filter_tpu_torch.ops.probe import (
    probe_tally,
    probe_tally_weighted,
)

# csrc/sorted_table.cuh
KEYS = 4
STAGED_THREADS, GLOBAL_THREADS, GLOBAL_BLOCKS_PER_SM = 512, 256, 4
# an H100 SXM's cudaDevAttr values: shared memory a multiprocessor, a
# block by opt-in, reserved a block; multiprocessors
SMEM_PER_SM, SMEM_OPTIN, SMEM_RESERVED, SMS = 233472, 232448, 1024, 132
STAGED_LIMIT_K4, STAGED_LIMIT_K2 = 10367, 6207  # the header notes' limits
FORM_AUTO, FORM_STAGED, FORM_GLOBAL = 0, 1, 2  # kdf::LaunchForm
N_BATCH = 32768 * 122  # the k = 31 windows of a 32,768 x 152 bp batch
KS = (15, 17, 21, 31)
TABLES = ("1", "2", "4095", "4096", "6144", "6145", "6207", "6208", "10367",
          "10368", "all-sentinel", "trailing-sentinels", "poly-A")


def ceil_log2(x):
    b = 0
    while (1 << b) < x:
        b += 1
    return b


def bitlen(x):
    """int bit length of each entry of a non-negative int64 array."""
    x = np.asarray(x, dtype=np.int64)
    out = np.zeros(x.shape, dtype=np.int64)
    while (x > 0).any():
        out += x > 0
        x = x >> 1
    return out


def fill_directory(t, live, shift, bits):
    """``kdf::fill_directory``: (2**bits + 1,) entries.  Row i writes the
    prefixes (prefix(i - 1), prefix(i)], the items past the last row
    write the tail with *live*; asserts every entry is written once."""
    n_dir = (1 << bits) + 1
    d = np.full(n_dir, -7, dtype=np.int64)  # garbage
    own = t[:live] >> shift
    first = np.concatenate([[0], own[:-1] + 1]) if live else own
    n_writes = own - first + 1
    rows = np.repeat(np.arange(live), n_writes)
    starts = np.repeat(first, n_writes)
    offsets = np.arange(rows.size) - np.repeat(
        np.cumsum(n_writes) - n_writes, n_writes)
    p_rows = starts + offsets
    tail_start = int(own[-1]) + 1 if live else 0
    p_tail = tail_start + np.arange(n_dir - tail_start)
    written = np.concatenate([p_rows, p_tail])
    assert (written >= 0).all() and (written < n_dir).all()
    assert (np.bincount(written, minlength=n_dir) == 1).all()
    d[p_rows] = rows
    d[p_tail] = live
    return d


FINE_BITS = 22  # ops/directory.py


def directory_bits(live):
    """bits of the global directory: ceil(log2(live)) up to FINE_BITS,
    past it no fewer than ceil(log2(live)) - 2."""
    c = ceil_log2(max(live, 1))
    return max(c - 2, min(c, FINE_BITS))


def directory_shape(live, max_key):
    """(bits, shift) of the global directory (``ops/directory.py``)."""
    bits = directory_bits(live)
    shift = max(0, int(max_key).bit_length() - bits) if live else 0
    return bits, shift


def launch(n, live, bits, counts, form=FORM_AUTO, threads=0, per_sm=0):
    """``kdf::dir_probe_launch``: (staged, blocks, threads, shared
    bytes), under a launch override (*form*, *threads*, *per_sm*; 0
    keeps the plan's value).  Raises ``ValueError`` where the C code
    returns cudaErrorInvalidValue."""
    if not (FORM_AUTO <= form <= FORM_GLOBAL
            and threads in (0, 128, 256, 512) and 0 <= per_sm <= 32):
        raise ValueError("not a launch override")
    smem = live * (16 if counts else 8) + 2 * ((1 << bits) + 1)
    budget = min(SMEM_PER_SM // 2 - SMEM_RESERVED, SMEM_OPTIN)
    fits = smem <= budget
    staged = fits if form == FORM_AUTO else form == FORM_STAGED
    if staged and not fits:
        raise ValueError("the staged form does not hold this table")
    threads = threads or (STAGED_THREADS if staged else GLOBAL_THREADS)
    per_sm = per_sm or (2 if staged else GLOBAL_BLOCKS_PER_SM)
    groups = -(-n // KEYS)
    blocks = min(-(-groups // threads), SMS * per_sm)
    return staged, blocks, threads, smem if staged else 0


def find_rows_dir(t, d, shift, bits, q):
    """``kdf::find_rows_dir`` for every key (a thread's four searches are
    interleaved; the order of probes changes no key's result): the row of
    each key in t, or -1.  Asserts each probe lies in its key's bucket
    and no key takes more than bitlen(bucket rows) probes."""
    p = q.view(np.uint64) >> np.uint64(shift)
    inb = (q != SENTINEL) & ((p >> np.uint64(bits)) == 0)
    pi = np.where(inb, p, 0).astype(np.int64)
    lo = np.where(inb, d[pi], 0)
    hi = np.where(inb, d[np.minimum(pi + 1, d.size - 1)], 0)
    base, left = lo - 1, hi - lo
    eq = np.zeros(q.shape, dtype=bool)
    probes = np.zeros(q.shape, dtype=np.int64)
    while (left > 0).any():
        act = left > 0
        half = (left + 1) >> 1
        mid = base + half
        assert ((mid[act] >= lo[act]) & (mid[act] < hi[act])).all()
        v = t[np.where(act, mid, 0)]
        below = act & (v < q)
        at_or_above = act & ~(v < q)
        base = np.where(below, mid, base)
        left = np.where(below, left - half,
                        np.where(at_or_above, half - 1, left))
        eq = np.where(at_or_above, v == q, eq)
        probes += act
    assert (probes <= bitlen(hi - lo)).all()
    return np.where(eq, base + 1, -1)


def probe_groups(t, d, shift, bits, keys):
    """``load_keys`` + ``find_rows_dir`` + ``store_group``: groups of four
    consecutive keys, the last padded with the sentinel, rows of the n
    keys kept."""
    n = keys.size
    padded = np.full(-(-n // KEYS) * KEYS, SENTINEL, dtype=np.int64)
    padded[:n] = keys
    rows = find_rows_dir(t, d, shift, bits, padded)
    assert (rows[n:] == -1).all()
    return rows[:n]


def staged_directory(table, live, glob_dir):
    """The staged form's rows and its uint16 copy of the global
    directory (``stage_directory``)."""
    assert glob_dir.max(initial=0) < 1 << 16
    return table[:live], glob_dir.astype(np.uint16).astype(np.int64)


@functools.lru_cache(maxsize=None)
def canonical_keys(k, seed, n_reads=256):
    """Sorted distinct canonical keys of random 152 bp reads, the windows
    with an N base dropped."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n_reads, 152), dtype=np.uint8)
    keys = tdev.extract_canonical_windows(
        torch.from_numpy(codes), torch.full((n_reads,), 152,
                                            dtype=torch.int32), k)[0]
    return np.unique(keys.numpy().ravel())


@functools.lru_cache(maxsize=None)
def make_table(kind, k):
    """(M,) sorted int64 table of *kind*: M random canonical keys, all
    sentinel, 3,000 keys then 7 sentinel rows, or a poly-A-like table
    whose 10,000 smallest keys (0..9,999) share prefix 0."""
    rng = np.random.default_rng(k)
    pool = canonical_keys(k, 1000 + k)
    if kind == "all-sentinel":
        return np.full(5, SENTINEL, dtype=np.int64)
    if kind == "trailing-sentinels":
        live = np.sort(rng.choice(pool, 3000, replace=False))
        return np.concatenate([live, np.full(7, SENTINEL, dtype=np.int64)])
    if kind == "poly-A":
        spread = rng.choice(pool[pool >= 10000], 2000, replace=False)
        return np.sort(np.concatenate([np.arange(10000), spread]))
    return np.sort(rng.choice(pool, int(kind), replace=False))


def queries(table, k):
    """Every live key, each +- 1, random canonical windows with sentinels,
    0, 4**k - 1, the sentinel, the last live key + 1 and 2**62 - 1."""
    live = table[table != SENTINEL]
    rng = np.random.default_rng(k + 7)
    codes = rng.integers(0, 4, (128, 152), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    windows = tdev.extract_canonical_windows(
        torch.from_numpy(codes), torch.full((128,), 152, dtype=torch.int32),
        k)[0].numpy().ravel()
    top = int(live[-1]) + 1 if live.size else 1
    special = np.array([0, 4 ** k - 1, SENTINEL, top, (1 << 62) - 1],
                       dtype=np.int64)
    q = np.concatenate([live, live + 1, np.maximum(live - 1, 0), windows,
                        special])
    return rng.permutation(q)


def _global(table):
    live = int((table != SENTINEL).sum())
    bits, shift = directory_shape(live, table[live - 1] if live else 0)
    return live, bits, shift, fill_directory(table, live, shift, bits)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", TABLES)
def test_fill_directory_matches_searchsorted(kind, k):
    """The model's directory (and the staged form's uint16 copy of it)
    equals ``torch.searchsorted`` of the live prefixes, and
    ``build_directory``'s plain version equals the model's."""
    table = make_table(kind, k)
    live, bits, shift, d = _global(table)
    t = torch.from_numpy(table)
    assert np.array_equal(d, tdir.plain_directory(t, live, bits,
                                                  shift).numpy())
    built = tdir.build_directory(t)
    assert (built.bits, built.shift, built.live) == (bits, shift, live)
    assert built.offsets.dtype == torch.int32
    assert np.array_equal(built.offsets.numpy(), d)
    if live:
        assert table[live - 1] >> shift < 1 << bits
        assert bits == ceil_log2(live) == tdir.directory_bits(live)
    _t, ds = staged_directory(table, live, d)
    assert np.array_equal(ds, tdir.plain_directory(t, live, bits,
                                                   shift).numpy())


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", TABLES)
def test_member_search_matches_plain(kind, k):
    """K4's rows and found bits through the global directory and the
    staged copy equal ``dev.find_rows`` / ``dev.member``."""
    table = make_table(kind, k)
    live, bits, shift, d = _global(table)
    q = queries(table, k)
    t, tq = torch.from_numpy(table), torch.from_numpy(q)
    want_rows = tdev.find_rows(t, tq).numpy()
    want_found = tdev.member(t, tq).numpy()
    for t_form, d_form in ((table, d), staged_directory(table, live, d)):
        rows = probe_groups(t_form, d_form, shift, bits, q)
        assert np.array_equal(rows, want_rows)
        assert np.array_equal(rows >= 0, want_found)
    if live:
        assert want_found.any() and not want_found.all()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", TABLES)
def test_tally_matches_plain(kind, k):
    """K2 in the form its launch picks: staged, block-private counts
    flushed once per block and nonzero row; global, one add per hit.
    Both equal ``dev.small_table_tally`` on a stream that repeats keys."""
    table = make_table(kind, k)
    live, bits, shift, d = _global(table)
    rng = np.random.default_rng(k)
    q = queries(table, k)
    q = np.concatenate([q, rng.choice(q, 3 * q.size)])  # coverage repeats
    want = tdev.small_table_tally(torch.from_numpy(table),
                                  torch.from_numpy(q)).numpy()
    staged, blocks, threads, _smem = launch(q.size, live, bits, True)
    assert staged == (live <= STAGED_LIMIT_K2)
    acc = np.zeros(table.size, dtype=np.int64)
    if staged:
        t_s, d_s = staged_directory(table, live, d)
        rows = probe_groups(t_s, d_s, shift, bits, q)
        block = (np.arange(q.size) // KEYS) % (blocks * threads) // threads
        adds = 0
        for b in range(blocks):
            hit = rows[(block == b) & (rows >= 0)]
            counts = np.bincount(hit, minlength=live)
            acc[:live] += counts
            adds += int((counts != 0).sum())
        assert adds <= int((rows >= 0).sum())
    else:
        rows = probe_groups(table, d, shift, bits, q)
        np.add.at(acc, rows[rows >= 0], 1)
    assert np.array_equal(acc, want)


@pytest.mark.parametrize("counts,limit", [
    (False, STAGED_LIMIT_K4), (True, STAGED_LIMIT_K2)], ids=["K4", "K2"])
def test_staged_limit_is_the_shared_memory_budget(counts, limit):
    """The staged form holds up to the header notes' live rows: 8 B a row
    (16 with K2's counts) and 2 B a directory entry within the 115,712
    bytes that let two blocks share an SM."""
    def launched(live):
        return launch(1 << 20, live, directory_bits(live), counts)

    assert launched(limit)[0] and not launched(limit + 1)[0]
    assert launched(1)[0] and launched(4096)[0]
    assert not launched(1 << 20)[0]
    assert 0 < launched(limit)[3] <= 115712


@pytest.mark.parametrize("counts,live,n,want", [
    (True, 1, N_BATCH, (True, 264, 512, 16 + 2 * 2)),
    (True, 4096, N_BATCH, (True, 264, 512, 4096 * 16 + 2 * 4097)),
    (True, 6207, N_BATCH, (True, 264, 512, 6207 * 16 + 2 * 8193)),
    (True, 6208, N_BATCH, (False, 528, 256, 0)),
    (False, 10367, N_BATCH, (True, 264, 512, 10367 * 8 + 2 * 16385)),
    (False, 10368, N_BATCH, (False, 528, 256, 0)),
    (True, 1 << 24, N_BATCH, (False, 528, 256, 0)),
    (False, 4096, 100, (True, 1, 512, 4096 * 8 + 2 * 4097)),
    (True, 262144, 100, (False, 1, 256, 0))])
def test_default_launch_plan_is_unchanged(counts, live, n, want):
    """With no override the plan is the one K2 and K4 always had on an
    H100 SXM: staged 512-thread blocks, two an SM, or global 256-thread
    blocks, four an SM (132 SMs)."""
    assert launch(n, live, directory_bits(live), counts) == want
    assert launch(n, live, directory_bits(live), counts, FORM_AUTO, 0,
                  0) == want


def test_launch_override_plans():
    """The form, the threads and the cap each replace one value of the
    plan; the staged form of a table that does not fit, and any value
    the kernels do not take, are refused."""
    small, large = (4096, directory_bits(4096)), (262144,
                                                  directory_bits(262144))
    smem = 4096 * 16 + 2 * 4097
    assert launch(N_BATCH, *small, True, FORM_GLOBAL) == (False, 528, 256, 0)
    assert launch(N_BATCH, *small, True, FORM_STAGED) == (True, 264, 512,
                                                          smem)
    assert launch(N_BATCH, *small, True, FORM_AUTO, 128, 1) == (
        True, 132, 128, smem)
    assert launch(N_BATCH, *large, True, FORM_AUTO, 512, 1) == (
        False, 132, 512, 0)
    assert launch(100, *large, False, FORM_AUTO, 128, 4) == (False, 1, 128,
                                                             0)
    for bad in ((STAGED_LIMIT_K2 + 1, True), (STAGED_LIMIT_K4 + 1, False)):
        with pytest.raises(ValueError):
            launch(N_BATCH, bad[0], directory_bits(bad[0]), bad[1],
                   FORM_STAGED)
    for form, threads, per_sm in ((3, 0, 0), (0, 384, 0), (0, 1024, 0),
                                  (0, 0, 33), (0, 0, -1)):
        with pytest.raises(ValueError):
            launch(N_BATCH, *small, True, form, threads, per_sm)


def _override_case():
    rng = np.random.default_rng(3)
    table = torch.from_numpy(np.unique(rng.integers(0, 1 << 40, 500)))
    keys = torch.cat([table[::3], table[::7],
                      torch.from_numpy(rng.integers(0, 1 << 40, 300)),
                      torch.full((5,), SENTINEL)])
    return table, keys


@pytest.mark.parametrize("launch_", [
    tdir.Launch("staged"), tdir.Launch("global", 512, 1),
    tdir.Launch("auto", 128, 4), tdir.Launch(threads=256)])
def test_launch_override_leaves_the_results_on_the_cpu(launch_):
    """On a CPU tensor a valid override changes nothing: K2, K4 and (but
    for the staged form, which it has not) K3 give the plain results."""
    table, keys = _override_case()

    def tally(launch=None):
        acc = torch.zeros(table.shape[0], dtype=torch.int64)
        return probe_tally(keys, table, acc, None, launch)

    assert torch.equal(tally(launch_), tally())
    assert (tally() > 1).any()
    assert torch.equal(probe_member(keys, table, None, launch_),
                       tdev.member(table, keys))
    weights = torch.arange(keys.shape[0], dtype=torch.int64)
    acc = torch.zeros(table.shape[0], dtype=torch.int64)
    if launch_.form == "staged":
        with pytest.raises(ValueError, match="no staged form"):
            probe_tally_weighted(keys, weights, table, acc, None, None,
                                 launch_)
        return
    assert torch.equal(
        probe_tally_weighted(keys, weights, table, acc, None, None, launch_),
        tdev.weighted_tally(table, keys, weights,
                            torch.zeros_like(acc)))


@pytest.mark.parametrize("bad", [
    tdir.Launch("fast"), tdir.Launch("auto", 384), tdir.Launch("auto", 1024),
    tdir.Launch("auto", 0, 33), tdir.Launch("global", 0, -1)])
def test_launch_override_refuses_what_the_kernels_do_not_take(bad):
    table, keys = _override_case()
    acc = torch.zeros(table.shape[0], dtype=torch.int64)
    for call in (lambda: probe_tally(keys, table, acc, None, bad),
                 lambda: probe_member(keys, table, None, bad),
                 lambda: probe_tally_weighted(keys, torch.ones_like(keys),
                                              table, acc, None, None, bad)):
        with pytest.raises(ValueError, match="launch override"):
            call()


def test_poly_a_bucket_is_searched_exactly():
    """The 10,000-row bucket at prefix 0 takes bitlen(10,000) = 14 probes
    and still finds each of its keys at its own row."""
    table = make_table("poly-A", 31)
    live, bits, shift, d = _global(table)
    assert d[0] == 0 and d[1] >= 10000
    q = np.arange(10000, dtype=np.int64)
    assert np.array_equal(probe_groups(table, d, shift, bits, q), q)


@pytest.mark.parametrize("live,bits", [
    (0, 0), (1, 0), (2, 1), (4096, 12), (4097, 13), (1 << 22, 22),
    ((1 << 22) + 1, 22), (1 << 24, 22), ((1 << 24) + 1, 23), (1 << 28, 26)])
def test_directory_sizing_rule(live, bits):
    """One row a bucket up to a 16 MB directory, then no coarser than
    four rows a bucket."""
    assert directory_bits(live) == tdir.directory_bits(live) == bits
    assert tdir.directory_bytes(live) == 4 * ((1 << bits) + 1)


def test_directory_for_takes_its_own_table_or_builds_one():
    """``directory_for`` passes the table's own directory through and
    builds one (the plain version on the CPU) when given none."""
    t = torch.from_numpy(make_table("4096", 31))
    own = tdir.build_directory(t)
    assert tdir.directory_for(t, own) is own
    built = tdir.directory_for(t, None)
    assert built.table is t and torch.equal(built.offsets, own.offsets)


@pytest.mark.parametrize("other", ["same-size table", "copy", "prefix"])
def test_directory_for_refuses_another_tables_directory(other):
    """A directory built from another table is refused, even one of the
    same size and bits (whose offsets would give wrong rows), a copy of
    the table in other memory, or a view of part of it."""
    t = torch.from_numpy(make_table("4096", 31))
    if other == "same-size table":
        foreign = torch.from_numpy(make_table("4096", 21))
    elif other == "copy":
        foreign = t.clone()
    else:
        foreign = t[:4095]
    d = tdir.build_directory(foreign)
    if other == "same-size table":
        assert (d.bits, d.live) == (tdir.build_directory(t).bits, t.numel())
    with pytest.raises(ValueError, match="does not belong"):
        tdir.directory_for(t, d)
