"""Port FilteredCounter vs the JAX FilteredCounter and the host k-mer
oracle (pattern of tests/test_engine.py:123).  Integer counts, exact."""

import time
from collections import Counter

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu import engine as jeng
from kmer_denovo_filter_tpu import kmer as K
from kmer_denovo_filter_tpu.htsio import native as jnative
from kmer_denovo_filter_tpu.ops import encode as jenc
from kmer_denovo_filter_tpu_torch import engine as teng
from kmer_denovo_filter_tpu_torch.ops import directory as tdir
from kmer_denovo_filter_tpu_torch.ops import encode as tenc
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from tests.test_engine import pack_reads

CPU = torch.device("cpu")


def _reads(seed, n, k, with_n):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(
        b"ACGTACGTACGTACGTN" if with_n else b"ACGT", np.uint8)
    return [alphabet[rng.integers(0, len(alphabet), m)].tobytes().decode()
            for m in rng.integers(k, k + 81, n)]


def _filter_set(reads, k):
    out = set()
    for s in reads:
        out.update(K.extract_read_kmers(s, k)[0].values())
    return out


def _oracle(reads, filter_set, k):
    oc = Counter()
    for s in reads:
        for c in K.extract_read_kmers(s, k)[0].values():
            if c in filter_set:
                oc[c] += 1
    return dict(oc)


def _jax_native_available(tries=30):
    """Whether the JAX package's native library loads, waiting out a
    concurrent build.  Its builder (kmer_denovo_filter_tpu/htsio/native.py
    ``_build``) writes ``kdf_native.so`` in place, not write-then-rename,
    so in a fresh tree several pytest workers compile it at once and a
    load that meets another worker's half-written file fails and is
    cached for the process.  The cached failure is dropped and the load
    tried again, once a second, until the library is whole."""
    for _ in range(tries):
        if jnative.available():
            return True
        jnative._lib = None
        time.sleep(1)
    return False


def _found(index, counts):
    return {s: int(c) for s, c in zip(index.to_strings(), counts) if c > 0}


@pytest.mark.parametrize("k", [15, 31])
def test_filtered_counter_matches_oracle_and_jax(k):
    stream = _reads(21, 80, k, with_n=False)
    filter_set = _filter_set(stream[:10] + _reads(22, 20, k, False), k)
    batch, lens = pack_reads(stream)

    tidx = teng.KmerIndex.from_strings(filter_set, k, device=CPU)
    fc = teng.make_filtered_counter(tidx)
    fc.feed(batch, lens)
    got = fc.result()
    assert got.dtype == np.int64 and got.shape == (tidx.n,)
    assert _found(tidx, got) == _oracle(stream, filter_set, k)

    jidx = jeng.KmerIndex.from_strings(filter_set, k)
    jfc = jeng.FilteredCounter(jidx)
    jfc.feed(batch, lens)
    assert np.array_equal(got, jfc.result())


def test_multiple_feeds_with_shape_change():
    k = 31
    stream = sorted(_reads(31, 90, k, with_n=True), key=len)
    filter_set = _filter_set(stream[::3], k)
    tidx = teng.KmerIndex.from_strings(filter_set, k, device=CPU)
    jidx = jeng.KmerIndex.from_strings(filter_set, k)
    fc = teng.FilteredCounter(tidx)
    jfc = jeng.FilteredCounter(jidx)
    shapes = set()
    for lo, hi in ((0, 30), (30, 75), (75, 90)):
        batch, lens = pack_reads(stream[lo:hi])
        shapes.add(batch.shape)
        fc.feed(batch, lens)
        jfc.feed(batch, lens)
    assert len(shapes) > 1
    got = fc.result()
    assert np.array_equal(got, jfc.result())
    assert _found(tidx, got) == _oracle(stream, filter_set, k)


def test_batch_narrower_than_k_counts_nothing():
    k = 31
    stream = _reads(37, 12, k, with_n=False)
    tidx = teng.KmerIndex.from_strings(_filter_set(stream, k), k,
                                       device=CPU)
    fc = teng.FilteredCounter(tidx)
    short, short_lens = pack_reads([s[:k - 1] for s in stream])
    assert short.shape[1] < k
    fc.feed(short, short_lens)
    fc.feed(short[:0], short_lens[:0])
    assert not fc.result().any()
    batch, lens = pack_reads(stream)
    fc.feed(batch, lens)
    assert _found(tidx, fc.result()) == _oracle(stream, tidx.to_strings(), k)


def test_result_is_a_snapshot():
    k = 31
    stream = _reads(35, 20, k, with_n=False)
    tidx = teng.KmerIndex.from_strings(_filter_set(stream, k), k,
                                       device=CPU)
    fc = teng.FilteredCounter(tidx)
    batch, lens = pack_reads(stream)
    fc.feed(batch, lens)
    first = fc.result()
    kept = first.copy()
    fc.feed(batch, lens)
    assert np.array_equal(first, kept)
    assert np.array_equal(fc.result(), 2 * kept)


def test_index_from_jax_keys_and_counts():
    k = 21
    filter_set = _filter_set(_reads(45, 10, k, with_n=False), k)
    jidx = jeng.KmerIndex.from_strings(filter_set, k)
    counts = np.arange(jidx.n, dtype=np.int64)
    tidx = teng.KmerIndex.from_keys_counts(jidx.keys_np, counts, k,
                                           device=CPU)
    assert (tidx.n, tidx.k, tidx.w) == (jidx.n, k, 2)
    assert tidx.counts_np is counts
    assert tidx.to_strings() == jidx.to_strings() == sorted(filter_set)
    assert torch.equal(tidx.table,
                       keys64.words_to_keys64(jidx.keys_np, k))
    assert (tidx.table[1:] > tidx.table[:-1]).all()


def test_empty_table():
    k = 31
    batch, lens = pack_reads(_reads(41, 5, k, with_n=False))
    tidx = teng.KmerIndex.from_strings(set(), k, device=CPU)
    fc = teng.FilteredCounter(tidx)
    fc.feed(batch, lens)
    jfc = jeng.FilteredCounter(jeng.KmerIndex.from_strings(set(), k))
    jfc.feed(batch, lens)
    assert fc.result().shape == (0,)
    assert np.array_equal(fc.result(), jfc.result())


def test_state_carried_over_from_jax(monkeypatch):
    """JAX accumulator after 2 feeds → keys.py → 2 port feeds equals
    JAX after all 4 feeds."""
    monkeypatch.setenv("KDF_SB_JOIN", "1")  # JAX acc current per feed
    k = 31
    stream = _reads(51, 120, k, with_n=True)
    filter_set = _filter_set(stream[::4], k)
    parts = [pack_reads(stream[i:i + 30]) for i in range(0, 120, 30)]
    jidx = jeng.KmerIndex.from_strings(filter_set, k)
    jfc = jeng.FilteredCounter(jidx)
    for batch, lens in parts[:2]:
        jfc.feed(batch, lens)
    carried = keys64.acc_to_int64(np.asarray(jfc.acc), jidx.n)

    tidx = teng.KmerIndex(jidx.keys_np, k, device=CPU)
    fc = teng.FilteredCounter(tidx)
    fc.acc.copy_(carried)
    for batch, lens in parts[2:]:
        fc.feed(batch, lens)
        jfc.feed(batch, lens)
    assert np.array_equal(fc.result(), jfc.result())
    assert _found(tidx, fc.result()) == _oracle(stream, filter_set, k)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        teng.KmerIndex.from_strings({"A" * 31}, 31, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        teng.resolve_device(torch.device("cuda"))


def test_wide_k_not_ported():
    """k = 33 is a wide index now; k = 209 (W = 14) raises."""
    idx = teng.KmerIndex.from_strings({"A" * 33}, 33, device=CPU)
    assert idx.table.shape == (1, 2) and idx.to_strings() == ["A" * 33]
    with pytest.raises(ValueError, match="W <= 13"):
        teng.KmerIndex.from_strings({"A" * 209}, 209, device=CPU)


# ── slice 2: stream counter, indexes, dedup-first and host counters ──


def _words(kmers, k):
    return jeng.KmerIndex.from_strings(kmers, k).keys_np


@pytest.mark.parametrize("k", [15, 31])
def test_stream_counter_matches_jax_and_oracle(k, monkeypatch):
    """Several feeds with a tiny merge floor, so per-batch chunks
    consolidate more than once."""
    monkeypatch.setenv("KDF_MERGE_ROWS", "64")
    stream = _reads(61, 60, k, with_n=True)
    sc = teng.make_stream_counter(k, device=CPU)
    jsc = jeng.StreamCounter(k)
    for lo in range(0, 60, 20):
        batch, lens = pack_reads(stream[lo:lo + 20])
        sc.feed(batch, lens)
        jsc.feed(batch, lens)
    keys, counts = sc.result()
    jkeys, jcounts = jsc.result()
    assert keys.dtype == np.uint32 and keys.shape[1] == (2 * k + 31) // 32
    assert np.array_equal(keys, jkeys) and np.array_equal(counts, jcounts)
    assert sc.total_windows == jsc.total_windows == int(counts.sum())
    oracle = Counter()
    for s in stream:
        oracle.update(K.extract_read_kmers(s, k)[0].values())
    got = dict(zip(tenc.keys_to_kmers(keys, k), counts.tolist()))
    assert got == dict(oracle)
    idx = sc.to_index()
    assert idx.device == CPU and np.array_equal(idx.counts_np, counts)


def test_stream_counter_feed_sequence_crosses_chunk_boundary():
    """A contig longer than the 2**20-base chunk: every window counted
    once, equal to a host count by the JAX package's numpy encoder (the
    JAX StreamCounter pads the contig to 1,024 rows, too large for a
    CPU test)."""
    k = 31
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, (1 << 20) + 3000).astype(np.uint8)
    codes[500] = 4
    seq = np.frombuffer(b"ACGTN", np.uint8)[codes].tobytes().decode()
    sc = teng.StreamCounter(k, device=CPU)
    sc.feed_sequence(seq)
    sc.feed_sequence(seq[:k - 1])  # shorter than k: nothing
    keys, counts = sc.result()
    windows = np.lib.stride_tricks.sliding_window_view(codes, k)
    ref_keys, valid = jenc.canonical_keys(windows)
    ref_keys, ref_counts = jenc.unique_with_counts(ref_keys[valid])
    assert np.array_equal(keys, ref_keys)
    assert np.array_equal(counts, ref_counts)
    assert sc.total_windows == len(seq) - k + 1 - k  # k windows hold the N


def test_count_reads_and_empty_result():
    k = 21
    assert teng.StreamCounter(k, device=CPU).result()[0].shape == (0, 2)
    stream = _reads(62, 10, k, with_n=False)
    sc = teng.count_reads([pack_reads(stream)], k, device=CPU)
    jsc = jeng.count_reads([pack_reads(stream)], k)
    assert all(np.array_equal(a, b)
               for a, b in zip(sc.result(), jsc.result()))


def test_index_membership_and_counts_of_match_jax():
    k = 31
    kmers = _filter_set(_reads(63, 30, k, with_n=False), k)
    words = _words(kmers, k)
    counts = np.arange(1, words.shape[0] + 1, dtype=np.int64)
    queries = np.concatenate([
        words[::3], _words(_filter_set(_reads(64, 5, k, False), k), k),
        np.full((2, 2), 0xFFFFFFFF, np.uint32)])
    tidx = teng.KmerIndex(words, k, counts, device=CPU)
    jidx = jeng.KmerIndex(words, k, counts)
    found = tidx.membership(queries)
    assert found.any() and not found.all() and not found[-2:].any()
    assert np.array_equal(found, jidx.membership(queries))
    assert np.array_equal(tidx.counts_of(queries), jidx.counts_of(queries))
    hidx = teng.HostKmerIndex(words, k, counts)
    jhidx = jeng.HostKmerIndex(words, k, counts)
    assert np.array_equal(hidx.membership(queries), found)
    assert np.array_equal(hidx.membership(queries),
                          jhidx.membership(queries))
    assert np.array_equal(hidx.counts_of(queries), jhidx.counts_of(queries))
    with pytest.raises(ValueError, match="no counts"):
        teng.KmerIndex(words, k, device=CPU).counts_of(queries)


def test_budget_gate_sends_tables_to_the_host(monkeypatch):
    k = 31
    stream = _reads(65, 40, k, with_n=True)
    words = _words(_filter_set(stream[::2], k), k)
    assert isinstance(teng.make_membership_index(words, k, device=CPU),
                      teng.KmerIndex)
    assert isinstance(teng.make_parent_filter_counter(words, k, device=CPU),
                      teng.FilteredCounter)
    monkeypatch.setenv("KDF_DEVICE_TABLE_BYTES", str(8 * words.shape[0] - 1))
    assert isinstance(teng.make_membership_index(words, k, device=CPU),
                      teng.HostKmerIndex)
    fc = teng.make_parent_filter_counter(words, k, device=CPU)
    assert isinstance(fc, teng.HostFilteredCounter)
    assert _jax_native_available()
    jfc = jeng.HostFilteredCounter(words, k)
    for lo in range(0, 40, 15):
        batch, lens = pack_reads(stream[lo:lo + 15])
        fc.feed(batch, lens)
        jfc.feed(batch, lens)
    got = fc.result()
    assert np.array_equal(got, jfc.result())
    tidx = teng.KmerIndex(words, k, device=CPU)
    assert _found(tidx, got) == _oracle(stream, set(tidx.to_strings()), k)


def test_card_table_that_does_not_fit_raises(monkeypatch):
    """On a CUDA device no table goes to the host, whatever
    ``KDF_DEVICE_TABLE_BYTES`` says: one the card cannot hold (the
    filter needs its accumulator too) raises before any allocation."""
    k = 31
    words = _words(_filter_set(_reads(67, 20, k, with_n=False), k), k)
    n = words.shape[0]
    monkeypatch.setenv("KDF_DEVICE_TABLE_BYTES", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: 24)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: 16)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (8 * n - 9, 1 << 40))
    with pytest.raises(RuntimeError, match="sharded engine"):
        teng.make_membership_index(words, k, device="cuda")
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (16 * n - 9, 1 << 40))
    with pytest.raises(RuntimeError, match="sharded engine"):
        teng.make_parent_filter_counter(words, k, device="cuda")


def test_card_check_counts_the_prefix_directory(monkeypatch):
    """A narrow table on the card needs its keys and its prefix
    directory: short of the directory's bytes by one, both gates raise."""
    k = 31
    words = _words(_filter_set(_reads(67, 20, k, with_n=False), k), k)
    n = words.shape[0]
    need = 8 * n + tdir.directory_bytes(n)
    assert tdir.directory_bytes(n) == 4 * ((1 << tdir.directory_bits(n)) + 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (need - 1, 1 << 40))
    with pytest.raises(RuntimeError, match="sharded engine"):
        teng.make_membership_index(words, k, device="cuda")
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (need + 8 * n - 1, 1 << 40))
    with pytest.raises(RuntimeError, match="sharded engine"):
        teng.make_parent_filter_counter(words, k, device="cuda")


def test_card_check_counts_the_wide_directory(monkeypatch):
    """A wide (k = 63) table on the card needs its limb rows and its
    prefix directory over limb 0: short of the directory's bytes by one,
    both gates raise."""
    k = 63
    words = _words(_filter_set(_reads(68, 20, k, with_n=False), k), k)
    n = words.shape[0]
    need = 8 * keys64.limbs_per_kmer(k) * n + tdir.directory_bytes(n)
    assert need == teng._table_bytes(n, k) and tdir.directory_bytes(n) > 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (need - 1, 1 << 40))
    with pytest.raises(RuntimeError, match="sharded engine"):
        teng.make_membership_index(words, k, device="cuda")
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (need + 8 * n - 1, 1 << 40))
    with pytest.raises(RuntimeError, match="sharded engine"):
        teng.make_parent_filter_counter(words, k, device="cuda")


def test_dedup_first_counter_over_several_feeds():
    """The discovery parent filter (K1 → dedup → K3) equals the plain
    K1 → K2 counter and the JAX FilteredCounter, with duplicated reads
    giving dedup weights above 1."""
    k = 31
    stream = _reads(66, 60, k, with_n=True)
    stream = stream + stream[:20]
    words = _words(_filter_set(stream[::4], k), k)
    fc = teng.make_parent_filter_counter(words, k, device=CPU)
    assert fc.dedup
    plain = teng.make_filtered_counter(teng.KmerIndex(words, k, device=CPU))
    assert not plain.dedup
    jfc = jeng.FilteredCounter(jeng.KmerIndex(words, k))
    for lo in range(0, 80, 25):
        batch, lens = pack_reads(stream[lo:lo + 25])
        for c in (fc, plain, jfc):
            c.feed(batch, lens)
    got = fc.result()
    assert np.array_equal(got, plain.result())
    assert np.array_equal(got, jfc.result())
    assert (got > 1).any()


# ── slice 3: wide keys (k = 63, Q = 3 limbs) ──────────────────────────

K_WIDE = 63


def test_wide_index_membership_and_counts_of_match_jax():
    k = K_WIDE
    kmers = _filter_set(_reads(71, 30, k, with_n=False), k)
    words = _words(kmers, k)
    counts = np.arange(1, words.shape[0] + 1, dtype=np.int64)
    queries = np.concatenate([
        words[::3], _words(_filter_set(_reads(72, 5, k, False), k), k),
        np.full((2, words.shape[1]), 0xFFFFFFFF, np.uint32)])
    tidx = teng.KmerIndex(words, k, counts, device=CPU)
    assert tidx.table.shape == (words.shape[0], 3)
    jidx = jeng.KmerIndex(words, k, counts)
    found = tidx.membership(queries)
    assert found.any() and not found.all() and not found[-2:].any()
    assert np.array_equal(found, jidx.membership(queries))
    assert np.array_equal(tidx.counts_of(queries), jidx.counts_of(queries))
    hidx = teng.HostKmerIndex(words, k, counts)
    jhidx = jeng.HostKmerIndex(words, k, counts)
    assert np.array_equal(hidx.membership(queries), found)
    assert np.array_equal(hidx.counts_of(queries), jhidx.counts_of(queries))
    assert np.array_equal(hidx.counts_of(queries), tidx.counts_of(queries))
    empty = teng.KmerIndex(words[:0], k, counts[:0], device=CPU)
    assert not empty.membership(queries).any()
    assert not empty.counts_of(queries).any()
    assert not teng.HostKmerIndex(words[:0], k).membership(queries).any()


def test_wide_stream_counter_matches_jax(monkeypatch):
    """Batches with N bases (several merges under a tiny merge floor)
    and a short contig through feed_sequence."""
    monkeypatch.setenv("KDF_MERGE_ROWS", "64")
    k = K_WIDE
    stream = _reads(73, 45, k, with_n=True)
    sc = teng.make_stream_counter(k, device=CPU)
    jsc = jeng.StreamCounter(k)
    stream = stream + _reads(79, 15, k, with_n=False) * 2
    for lo in range(0, 75, 15):
        batch, lens = pack_reads(stream[lo:lo + 15])
        sc.feed(batch, lens)
        jsc.feed(batch, lens)
    contig = "".join(_reads(74, 30, k, with_n=True))
    sc.feed_sequence(contig)
    jsc.feed_sequence(contig)
    keys, counts = sc.result()
    jkeys, jcounts = jsc.result()
    assert keys.dtype == np.uint32 and keys.shape[1] == 4
    assert np.array_equal(keys, jkeys) and np.array_equal(counts, jcounts)
    assert sc.total_windows == jsc.total_windows == int(counts.sum())
    assert (counts > 1).any()
    idx = sc.to_index()
    assert idx.table.shape == (keys.shape[0], 3)


@pytest.mark.parametrize("dedup", [False, True], ids=["K7", "dedup-K7w"])
def test_wide_filtered_counter_matches_jax_and_oracle(dedup):
    """Both forms over several feeds, duplicated reads giving dedup
    weights above 1, against the JAX FilteredCounter and the oracle."""
    k = K_WIDE
    stream = _reads(75, 60, k, with_n=True)
    stream = stream + stream[:20]
    filter_set = _filter_set(stream[::4] + _reads(76, 10, k, False), k)
    words = _words(filter_set, k)
    if dedup:
        fc = teng.make_parent_filter_counter(words, k, device=CPU)
    else:
        fc = teng.make_filtered_counter(teng.KmerIndex(words, k, device=CPU))
    assert fc.dedup == dedup
    jfc = jeng.FilteredCounter(jeng.KmerIndex(words, k))
    for lo in range(0, 80, 25):
        batch, lens = pack_reads(stream[lo:lo + 25])
        fc.feed(batch, lens)
        jfc.feed(batch, lens)
    got = fc.result()
    assert got.shape == (words.shape[0],) and (got > 1).any()
    assert np.array_equal(got, jfc.result()[:words.shape[0]])
    assert _found(fc.index, got) == _oracle(stream, filter_set, k)


def test_wide_scan_many_matches_jax_per_batch():
    """A group of batches of different B and L, one narrower than k."""
    k = K_WIDE
    stream = _reads(77, 50, k, with_n=False)
    words = _words(_filter_set(stream[::3], k), k)
    tidx = teng.KmerIndex(words, k, device=CPU)
    jidx = jeng.KmerIndex(words, k)
    batches = [pack_reads(stream[lo:hi])
               for lo, hi in ((0, 20), (20, 28), (28, 50))]
    short, short_lens = pack_reads([s[:k - 2] for s in stream[:4]])
    batches.insert(1, (short, short_lens))
    masks = teng.make_scanner_many(tidx)(batches)
    assert masks[1].shape == (4, 0)
    for (codes, lens), mask in zip(batches, masks):
        if codes.shape[1] >= k:
            assert np.array_equal(mask,
                                  jeng.scan_reads_for_hits(jidx, codes, lens))
    assert all(m.any() for i, m in enumerate(masks) if i != 1)
    assert np.array_equal(teng.make_scanner(tidx)(*batches[0]), masks[0])


def test_wide_tables_stay_on_the_device_over_budget(monkeypatch):
    """Over ``KDF_DEVICE_TABLE_BYTES`` a wide reference set goes to the
    host (numpy search), but a wide filter table stays on the device
    (the host hash is k <= 31, as in the reference)."""
    k = K_WIDE
    stream = _reads(78, 30, k, with_n=True)
    words = _words(_filter_set(stream[::2], k), k)
    monkeypatch.setenv("KDF_DEVICE_TABLE_BYTES", str(24 * words.shape[0] - 1))
    idx = teng.make_membership_index(words, k, device=CPU)
    assert isinstance(idx, teng.HostKmerIndex)
    assert idx.membership(words).all()
    fc = teng.make_parent_filter_counter(words, k, device=CPU)
    assert isinstance(fc, teng.FilteredCounter) and fc.dedup
    with pytest.raises(ValueError, match="W <= 2"):
        teng.HostFilteredCounter(words, k)
    monkeypatch.setenv("KDF_DEVICE_TABLE_BYTES", str(24 * words.shape[0]))
    assert isinstance(teng.make_membership_index(words, k, device=CPU),
                      teng.KmerIndex)
