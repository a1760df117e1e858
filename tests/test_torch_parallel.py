"""The port's sharded engine (:mod:`kmer_denovo_filter_tpu_torch.parallel`)
against the JAX package's on the CPU, and against its own single-device
engine.

The port's mesh is ``[cpu] * S``; the JAX package's is
``parallel.make_mesh(S)`` over the 8 host devices tests/conftest.py
forces.  Every comparison is exact.  The JAX filtered counter is built
directly (``make_filtered_counter`` on JAX picks its tile counter).
"""

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu import kmer as jkmer
from kmer_denovo_filter_tpu import parallel as jpar
from kmer_denovo_filter_tpu.ops import encode as jenc
from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch import steps
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.route import hash_owner
from kmer_denovo_filter_tpu_torch.parallel import (
    ShardedFilteredCounter,
    ShardedKmerIndex,
    ShardedStreamCounter,
    sharded_count,
    sharded_scan_reads_for_hits,
)
from kmer_denovo_filter_tpu_torch.parallel.sharded import (
    _in_order,
    _route_table,
)
from tests.test_engine import pack_reads, random_reads

CPU = torch.device("cpu")
SENTINEL_ROW = np.uint32(0xFFFFFFFF)


def _kmers(reads, k):
    return sorted({c for s in reads
                   for c in jkmer.extract_read_kmers(s, k)[0].values()})


def _case(k, seed):
    """(table keys, stream reads as (codes, lengths)): a table of the
    k-mers of 36 reads (6 of them in the stream) and a 40-read stream of
    ragged lengths, 30 reads with N bases and 10 without."""
    stream = (random_reads(30, k, seed=seed)
              + random_reads(10, k, with_n=False, seed=seed + 2))
    table_reads = stream[-6:] + random_reads(30, k, with_n=False,
                                             seed=seed + 1)
    keys = jenc.kmers_to_keys(_kmers(table_reads, k), k)
    return keys, pack_reads(stream)


def _queries(keys, k, seed):
    """Table keys, random keys and sentinel rows, shuffled."""
    rng = np.random.default_rng(seed)
    other = jenc.kmers_to_keys(
        _kmers(random_reads(10, k, with_n=False, seed=seed), k), k)
    sent = np.full((5, keys.shape[1]), SENTINEL_ROW, dtype=np.uint32)
    q = np.concatenate([keys[::3], other, sent])
    return q[rng.permutation(q.shape[0])]


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("k", [31, 63])
def test_membership_matches_jax_and_one_device(s, k):
    keys, _ = _case(k, 10 + k)
    q = _queries(keys, k, 1)
    got = ShardedKmerIndex(keys, k, [CPU] * s).membership(q)
    one = eng.KmerIndex(keys, k, device=CPU).membership(q)
    assert got.dtype == bool and got.any() and not got.all()
    assert np.array_equal(got, one)
    if k == 31:
        ref = jpar.ShardedKmerIndex(keys, k, jpar.make_mesh(s))
        assert np.array_equal(got, ref.membership(q))


@pytest.mark.parametrize("s", [2, 4])
def test_tally_batch_and_result_match_jax(s):
    k = 31
    keys, (codes, lengths) = _case(k, 20)
    idx = ShardedKmerIndex(keys, k, [CPU] * s)
    ref = jpar.ShardedKmerIndex(keys, k, jpar.make_mesh(s))
    for rows in (slice(0, 20), slice(20, 40)):
        flat = steps.window_keys(codes[rows], lengths[rows], k, CPU)
        words = keys64.keys64_to_words(flat.reshape(-1), k)
        idx.tally_batch(words)
        ref.tally_batch(words)
    got = idx.tally_result()
    assert got.sum() > 0
    assert np.array_equal(got, ref.tally_result())
    fc = eng.FilteredCounter(eng.KmerIndex(keys, k, device=CPU))
    fc.feed(codes, lengths)
    assert np.array_equal(got, fc.result())


@pytest.mark.parametrize("dedup", [False, True], ids=["plain", "dedup"])
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("k", [31, 63])
def test_filtered_counter_matches_jax_and_one_device(k, s, dedup):
    keys, (codes, lengths) = _case(k, 30 + k)
    fc = ShardedFilteredCounter(keys, k, [CPU] * s, dedup=dedup)
    one = eng.FilteredCounter(eng.KmerIndex(keys, k, device=CPU),
                              dedup=dedup)
    for rows in (slice(0, 25), slice(25, 40)):
        fc.feed(codes[rows], lengths[rows])
        one.feed(codes[rows], lengths[rows])
    got = fc.result()
    assert got.sum() > 0
    assert np.array_equal(got, one.result())
    if not dedup:
        ref = jpar.ShardedFilteredCounter(keys, k, jpar.make_mesh(s))
        ref.feed(codes[:25], lengths[:25])
        ref.feed(codes[25:], lengths[25:])
        assert np.array_equal(got, ref.result())


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("k", [31, 63])
def test_scan_matches_jax_and_one_device(s, k):
    keys, (codes, lengths) = _case(k, 40 + k)
    idx = ShardedKmerIndex(keys, k, [CPU] * s)
    got = sharded_scan_reads_for_hits(idx, codes, lengths)
    one = eng.scan_reads_for_hits(eng.KmerIndex(keys, k, device=CPU),
                                  codes, lengths)
    assert got.shape == (codes.shape[0], codes.shape[1] - k + 1)
    assert got.any()
    assert np.array_equal(got, one)
    if k == 31:
        ref = jpar.sharded_scan_reads_for_hits(
            jpar.ShardedKmerIndex(keys, k, jpar.make_mesh(s)), codes,
            lengths)
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("k", [31, 63])
def test_sharded_count_matches_jax_and_stream_counter(s, k):
    _keys, (codes, lengths) = _case(k, 50 + k)
    got_k, got_c = sharded_count(codes, lengths, k, [CPU] * s)
    sc = eng.StreamCounter(k, device=CPU)
    sc.feed(codes, lengths)
    one_k, one_c = sc.result()
    assert got_k.dtype == np.uint32 and got_c.dtype == np.int64
    assert np.array_equal(got_k, one_k) and np.array_equal(got_c, one_c)
    if k == 31:
        ref_k, ref_c = jpar.sharded_count(codes, lengths, k,
                                          jpar.make_mesh(s))
        assert np.array_equal(got_k, ref_k) and np.array_equal(got_c, ref_c)


@pytest.mark.parametrize("s", [2, 4])
def test_homopolymer_batch_goes_to_one_owner(s):
    """Every window of a homopolymer batch is one canonical key, so one
    shard receives them all: no capacity to overflow, counts exact."""
    k = 31
    codes, lengths = pack_reads(["A" * 64] * 64)
    keys = jenc.kmers_to_keys(["A" * k, "C" * k], k)
    owners = hash_owner(steps.key_tensor(keys[:1], k), s)
    assert owners.numel() == 1
    fc = ShardedFilteredCounter(keys, k, [CPU] * s)
    fc.feed(codes, lengths)
    assert fc.result().tolist() == [64 * 34, 0]
    got_k, got_c = sharded_count(codes, lengths, k, [CPU] * s)
    ref_k, ref_c = jpar.sharded_count(codes, lengths, k, jpar.make_mesh(s))
    assert np.array_equal(got_k, ref_k) and np.array_equal(got_c, ref_c)
    assert got_c.tolist() == [64 * 34]


@pytest.mark.parametrize("k", [31, 63])
def test_sentinels_and_empty_batches(k):
    keys, (codes, lengths) = _case(k, 60 + k)
    mesh = [CPU] * 3
    idx = ShardedKmerIndex(keys, k, mesh)
    w = keys.shape[1]
    assert idx.membership(np.zeros((0, w), np.uint32)).shape == (0,)
    sent = np.full((4, w), SENTINEL_ROW, dtype=np.uint32)
    assert not idx.membership(sent).any()
    idx.tally_batch(sent)
    idx.tally_batch(np.zeros((0, w), np.uint32))
    assert not idx.tally_result().any()
    fc = ShardedFilteredCounter(keys, k, mesh, dedup=True)
    fc.feed(codes[:0], lengths[:0])              # no read
    fc.feed(codes[:2, :k - 1], lengths[:2])      # reads shorter than k
    fc.feed(np.full((2, k + 4), 4, np.uint8), np.full(2, k + 4, np.int32))
    assert not fc.result().any()
    assert sharded_scan_reads_for_hits(idx, codes[:0], lengths[:0]).shape \
        == (0, codes.shape[1] - k + 1)
    assert sharded_scan_reads_for_hits(
        idx, codes[:2, :k - 1], lengths[:2]).shape == (2, 0)
    got_k, got_c = sharded_count(codes[:0], lengths[:0], k, mesh)
    assert got_k.shape == (0, w) and got_c.shape == (0,)


def test_a_table_with_an_empty_shard():
    """One key, four shards: three shards hold no row."""
    k = 31
    keys, (codes, lengths) = _case(k, 70)
    one_key = keys[:1]
    fc = ShardedFilteredCounter(one_key, k, [CPU] * 4)
    fc.feed(codes, lengths)
    ref = eng.FilteredCounter(eng.KmerIndex(one_key, k, device=CPU))
    ref.feed(codes, lengths)
    assert np.array_equal(fc.result(), ref.result())
    assert sum(s.n == 0 for s in fc.index.shards) == 3


@pytest.mark.parametrize("k", [31, 63])
def test_an_unsorted_table(k):
    """Table rows in any order: each shard sorts its own, and the tally
    comes back in the order of the rows given."""
    keys, (codes, lengths) = _case(k, 90 + k)
    perm = np.random.default_rng(k).permutation(keys.shape[0])
    fc = ShardedFilteredCounter(keys[perm], k, [CPU] * 3)
    fc.feed(codes, lengths)
    ref = eng.FilteredCounter(eng.KmerIndex(keys, k, device=CPU))
    ref.feed(codes, lengths)
    assert np.array_equal(fc.result(), ref.result()[perm])
    q = _queries(keys, k, 2)
    assert np.array_equal(fc.index.membership(q),
                          eng.KmerIndex(keys, k, device=CPU).membership(q))


@pytest.mark.parametrize("rows, want", [
    ([], True), ([[5, 1]], True), ([[1, 9], [2, 0], [2, 1]], True),
    ([[2, 0], [1, 9]], False), ([[1, 2], [1, 1]], False),
    ([[1, 1], [1, 1]], True),
])
def test_rows_sorted(rows, want):
    """Limb rows in lexicographic order, and their first limbs alone."""
    limbs = torch.tensor(rows, dtype=torch.int64).reshape(-1, 2)
    assert bool(_in_order(limbs)) is want
    first = limbs[:, 0]
    assert bool(_in_order(first)) is bool((first[1:] >= first[:-1]).all())


@pytest.mark.parametrize("s", [1, 2, 3, 5])
@pytest.mark.parametrize("k", [31, 63])
def test_table_owners_in_slices(k, s):
    """Routed slice by slice, each shard holds the rows the whole
    table's hash gives it, in table order, and the order check sees a
    swap where two slices meet."""
    keys, _ = _case(k, 110 + k)
    tables, rows, ordered = _route_table(keys, k, [CPU] * s)
    assert ordered
    host = steps.key_tensor(keys, k)
    owner = hash_owner(host, s).numpy()
    for d in range(s):
        assert np.array_equal(rows[d], np.flatnonzero(owner == d))
        assert torch.equal(tables[d], host[torch.from_numpy(rows[d])])
    per = -(-keys.shape[0] // s)
    cut = per if s > 1 else keys.shape[0] // 2
    swapped = keys.copy()
    swapped[[cut - 1, cut]] = keys[[cut, cut - 1]]
    assert not _route_table(swapped, k, [CPU] * s)[2]


@pytest.mark.parametrize("k", [31, 63])
def test_owners_roughly_uniform(k):
    """As tests/test_parallel.py:95 holds the JAX hash: 8 shards over the
    distinct k-mers of 200 random reads."""
    keys = jenc.kmers_to_keys(
        _kmers(random_reads(200, k, with_n=False, seed=6), k), k)
    owners = hash_owner(steps.key_tensor(keys, k), 8).numpy()
    counts = np.bincount(owners, minlength=8)
    assert counts.min() > 0.5 * counts.mean()
    assert counts.max() < 1.5 * counts.mean()


def test_owner_hash_of_extreme_keys():
    """No int64 overflow: the largest limbs and the sentinel give owners
    in range, the same as a Python-integer model of the hash."""
    mask = 0xFFFFFFFF

    def mix(h):
        for _ in range(2):
            h = (((h >> 16) ^ h) * 0x045D9F3B) & mask
        return (h >> 16) ^ h

    def model(limbs, n):
        h = 0x811C9DC5
        for limb in limbs:
            h = mix(h ^ (limb & mask))
            h = mix(h ^ (limb >> 32))
        return (h * n) >> 32

    rows = [[0, 0], [(1 << 62) - 1, 1], [keys64.SENTINEL, keys64.SENTINEL],
            [12345678901234, (1 << 62) - 7]]
    got = hash_owner(torch.tensor(rows, dtype=torch.int64), 7).tolist()
    assert got == [model(r, 7) for r in rows]
    flat = hash_owner(torch.tensor([r[0] for r in rows]), 5).tolist()
    assert flat == [model(r[:1], 5) for r in rows]


@pytest.mark.parametrize("mode, n_bytes, count, device, want", [
    (None, (1 << 33) + 1, 2, "cuda", True),
    (None, 1 << 33, 2, "cuda", False),
    ("1", 0, 2, "cuda", True),
    ("0", 1 << 36, 2, "cuda", False),
    ("1", 0, 1, "cuda", False),
    ("1", 1 << 36, 4, "cpu", False),
])
def test_shard_dispatch(monkeypatch, mode, n_bytes, count, device, want):
    """KDF_SHARDED: 0 off, 1 forced, unset only for a table the card
    cannot hold (8 GiB free here); only over 2 or more local CUDA
    devices (a CPU entry point keeps one device)."""
    if mode is None:
        monkeypatch.delenv("KDF_SHARDED", raising=False)
    else:
        monkeypatch.setenv("KDF_SHARDED", mode)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(eng, "_card_free", lambda device: 1 << 33)
    assert eng._shard_dispatch(torch.device(device), n_bytes) is want


@pytest.mark.parametrize("mode, sharded", [(None, False), ("0", False),
                                           ("1", True)])
def test_stream_counter_shards_only_when_forced(monkeypatch, mode, sharded):
    """Two local devices: the stream count stays on one unless
    KDF_SHARDED=1."""
    if mode is None:
        monkeypatch.delenv("KDF_SHARDED", raising=False)
    else:
        monkeypatch.setenv("KDF_SHARDED", mode)
    monkeypatch.setattr(eng, "_local_mesh", lambda device: [CPU, CPU])
    sc = eng.make_stream_counter(31, device=CPU)
    assert isinstance(sc, ShardedStreamCounter) is sharded


@pytest.fixture
def two_cpu_shards(monkeypatch):
    """The engine's local mesh as two CPU devices, sharding forced."""
    monkeypatch.setattr(eng, "_local_mesh", lambda device: [CPU, CPU])
    monkeypatch.setenv("KDF_SHARDED", "1")


@pytest.mark.parametrize("k", [31, 63])
def test_engine_factories_take_the_sharded_engine(two_cpu_shards, k):
    keys, (codes, lengths) = _case(k, 80 + k)
    index = eng.KmerIndex(keys, k, device=CPU)
    plain = eng.make_filtered_counter(index)
    parent = eng.make_parent_filter_counter(keys, k, device=CPU)
    assert isinstance(plain, ShardedFilteredCounter) and not plain.dedup
    assert isinstance(parent, ShardedFilteredCounter) and parent.dedup
    ref = eng.FilteredCounter(index)
    for fc in (plain, parent, ref):
        fc.feed(codes, lengths)
    assert np.array_equal(plain.result(), ref.result())
    assert np.array_equal(parent.result(), ref.result())
    sc = eng.make_stream_counter(k, device=CPU)
    assert isinstance(sc, ShardedStreamCounter)
    one = eng.StreamCounter(k, device=CPU)
    for rows in (slice(0, 15), slice(15, 40)):
        sc.feed(codes[rows], lengths[rows])
        one.feed(codes[rows], lengths[rows])
    for got, want in zip(sc.result(), one.result()):
        assert np.array_equal(got, want)
    assert sc.total_windows == one.total_windows
    groups = [(codes[:20], lengths[:20]), (codes[20:], lengths[20:])]
    for got, want in zip(eng.make_scanner_many(index)(groups),
                         eng.scan_reads_for_hits_many(index, groups)):
        assert np.array_equal(got, want)
    assert np.array_equal(eng.make_scanner(index)(codes, lengths),
                          eng.scan_reads_for_hits(index, codes, lengths))
