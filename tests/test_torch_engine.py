"""Port FilteredCounter vs the JAX FilteredCounter and the host k-mer
oracle (pattern of tests/test_engine.py:123).  Integer counts, exact."""

from collections import Counter

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu import engine as jeng
from kmer_denovo_filter_tpu import kmer as K
from kmer_denovo_filter_tpu_torch import engine as teng
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
    with pytest.raises(NotImplementedError, match="item 8"):
        teng.KmerIndex.from_strings({"A" * 33}, 33, device=CPU)
