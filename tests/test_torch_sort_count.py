"""Kernel K12's plain version and the stream count against the JAX
package, on the CPU.

* The plain version (what a CPU tensor runs: ``torch.unique``, or Q
  stable sorts for limb rows) equals the JAX ``ops/device.py:sort_count``
  on the CPU backend, with the sentinel run masked as
  ``StreamCounter.feed`` masks it (engine.py:381), at k in {15, 21, 31,
  33, 63, 127, 201, 207}, on duplicated batches, ragged reads with N
  bases and an all-N row, one key, no row, one row, all sentinels, all
  distinct, N = 8,191, 8,192 and 8,193, and a limb-0 tie across rows.
* ``StreamCounter`` with ``KDF_MERGE_ROWS=64`` (a consolidation at every
  feed) equals the JAX ``StreamCounter``.

The numpy model of K12 is ``tests/test_torch_sort_count_model.py``.
Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from kmer_denovo_filter_tpu import engine as jeng
from kmer_denovo_filter_tpu.ops import device as jdev
from kmer_denovo_filter_tpu_torch import engine as teng
from kmer_denovo_filter_tpu_torch.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from tests.test_engine import pack_reads
from tests.test_torch_sort_count_model import (
    KS,
    SENTINEL,
    cases,
    plain_rows,
    to_words,
)


def jax_rows(rows, k):
    """JAX ``sort_count`` on the words, its sentinel run masked as
    ``StreamCounter.feed`` masks it: (distinct (D, W) words, counts)."""
    w = enc.words_per_kmer(k)
    words = to_words(rows, k)
    if words.shape[0] == 0:
        return words, np.zeros(0, np.int64)
    skeys, starts, counts = (np.asarray(a) for a in jdev.sort_count(
        jnp.asarray(words), w))
    mask = starts & ~(skeys == keys64.SENTINEL32).all(axis=1)
    return skeys[mask], counts[mask].astype(np.int64)



@pytest.mark.parametrize("k", KS)
def test_plain_matches_jax_sort_count(k):
    """The plain version equals the JAX sort-count with its sentinel run
    masked, on every input at *k*."""
    for label, rows in cases(k).items():
        uk, counts = plain_rows(rows, k)
        jkeys, jcounts = jax_rows(rows, k)
        assert np.array_equal(to_words(uk, k), jkeys), label
        assert np.array_equal(counts, jcounts), label
        assert counts.sum() == (rows[:, 0] != SENTINEL).sum(), label


@pytest.mark.parametrize("k", KS)
def test_stream_counter_matches_jax(k, monkeypatch):
    """Three batches (ragged, N bases, a duplicated batch) under a merge
    floor of 64 rows, so the chunks consolidate at every feed."""
    monkeypatch.setenv("KDF_MERGE_ROWS", "64")
    rng = np.random.default_rng(k)
    alphabet = np.frombuffer(b"ACGT" * 16 + b"N", np.uint8)
    reads = [alphabet[rng.integers(0, len(alphabet), m)].tobytes().decode()
             for m in rng.integers(k, k + 100, 30)]
    counter = teng.StreamCounter(k, device="cpu")
    jcounter = jeng.StreamCounter(k)
    for batch in (reads[:10], reads[10:20], reads[:10] + reads[20:]):
        codes, lens = pack_reads(batch)
        counter.feed(codes, lens)
        jcounter.feed(codes, lens)
    keys, counts = counter.result()
    jkeys, jcounts = jcounter.result()
    assert keys.shape[0] and (counts > 1).any()
    assert np.array_equal(keys, jkeys) and np.array_equal(counts, jcounts)
    assert counter.total_windows == jcounter.total_windows
