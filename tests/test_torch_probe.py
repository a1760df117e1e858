"""Port tally (K2's plain path) vs the JAX package's small-table tallies:
the XLA ``small_tally_step``, the Pallas ``pallas_small_tally`` kernel and
the dedup-first ``small_tally_step_dedup`` (both in interpret mode).
Integer outputs, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu import kmer as K
from kmer_denovo_filter_tpu.ops import device as jdev
from kmer_denovo_filter_tpu.ops import encode as enc
from kmer_denovo_filter_tpu.ops import pallas_join as pj
from kmer_denovo_filter_tpu.ops.pallas_probe import pallas_small_tally
from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical
from kmer_denovo_filter_tpu_torch.ops.probe import probe_tally

_SENT = np.uint32(0xFFFFFFFF)


def _case(seed, k, n_reads=256, length=160):
    """Reads with N bases and ragged lengths; a sentinel-padded table
    of half the canonical k-mers of the first 30 reads plus random
    keys (misses)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n_reads, length), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    lengths = np.full(n_reads, length, np.int32)
    lengths[::5] = 120
    reads = ["".join("ACGTN"[c] for c in row[:n])
             for row, n in zip(codes[:30], lengths[:30])]
    hits = sorted({c for s in reads
                   for c in K.extract_read_kmers(s, k)[0].values()})[::2]
    misses = ["".join("ACGT"[b] for b in rng.integers(0, 4, k))
              for _ in range(50)]
    kmers = sorted(set(hits) | {K.canonicalize(s) for s in misses})
    words = jdev.pad_pow2_rows(enc.kmers_to_keys(kmers, k), _SENT)
    assert words.shape[0] > len(kmers)  # sentinel table rows present
    return codes, lengths, words, len(kmers)


def _port_tally(codes, lengths, words, k):
    table = keys64.words_to_keys64(words, k)
    acc = torch.zeros(table.shape[0], dtype=torch.int64)
    win = extract_canonical(torch.from_numpy(codes),
                            torch.from_numpy(lengths), k)
    return probe_tally(win.reshape(-1), table, acc).numpy()


@pytest.mark.parametrize("k", [15, 31])
def test_matches_xla_small_tally_step(k):
    codes, lengths, words, n = _case(k, k)
    ref = np.asarray(jdev.small_tally_step(
        jnp.asarray(words), jnp.zeros(words.shape[0], jnp.int32),
        jnp.asarray(codes), jnp.asarray(lengths), k,
        enc.words_per_kmer(k), 2048))
    got = _port_tally(codes, lengths, words, k)
    assert np.array_equal(got, ref)
    assert got[:n].sum() > 0 and not got[n:].any()
    # a duplicated batch counts every hit twice
    twice = _port_tally(np.concatenate([codes, codes]),
                        np.concatenate([lengths, lengths]), words, k)
    assert np.array_equal(twice, 2 * ref)


@pytest.mark.parametrize("k", [15, 31])
def test_matches_pallas_sweep_interpret(k):
    codes, lengths, words, _n = _case(50 + k, k)
    if words.shape[1] == 1:  # k <= 15: the kernel's 2-word form
        words2 = np.concatenate([words, np.zeros_like(words)], axis=1)
        words2[words2[:, 0] == _SENT, 1] = _SENT
    else:
        words2 = words
    ref = np.asarray(pallas_small_tally(
        jnp.asarray(codes), jnp.asarray(lengths),
        jnp.asarray(np.ascontiguousarray(words2[:, 0])),
        jnp.asarray(np.ascontiguousarray(words2[:, 1])),
        k, block_reads=128, m_tile=128, interpret=True))
    assert np.array_equal(_port_tally(codes, lengths, words, k), ref)


def test_steps_match_xla_small_tally_steps():
    """NB stacked batches folded through the step (JAX: one scan)."""
    k = 31
    codes, lengths, words, _n = _case(91, k, n_reads=64)
    codes_nb = np.stack([codes, codes[::-1]])
    lengths_nb = np.stack([lengths, lengths[::-1]])
    ref = np.asarray(jdev.small_tally_steps(
        jnp.asarray(words), jnp.zeros(words.shape[0], jnp.int32),
        jnp.asarray(codes_nb), jnp.asarray(lengths_nb), k, 2, 2048))
    acc = torch.zeros(words.shape[0], dtype=torch.int64)
    got = tdev.small_tally_steps(
        keys64.words_to_keys64(words, k), acc, torch.from_numpy(codes_nb),
        torch.from_numpy(lengths_nb), k)
    assert got is acc
    assert np.array_equal(got.numpy(), ref) and ref.sum() > 0


def test_matches_dedup_tally_interpret():
    """The TPU's dedup-first step compares MIXED words against a mixed
    table; the port probes raw int64 keys.  Adjacent duplicate reads
    give the dedup real run weights of 2."""
    k = 31
    codes, lengths, words, _n = _case(77, k)
    codes = np.repeat(codes, 2, axis=0)
    lengths = np.repeat(lengths, 2)
    th, tl = pj._mix_keys(jnp.asarray(words[:, 0]),
                          jnp.asarray(words[:, 1]))
    ref, ovf = pj.small_tally_step_dedup(
        th, tl, jnp.zeros(words.shape[0], jnp.int32), jnp.asarray(codes),
        jnp.asarray(lengths), k, u_chunk=pj.LCHUNK_DD, interpret=True)
    assert not bool(ovf)
    assert np.array_equal(_port_tally(codes, lengths, words, k),
                          np.asarray(ref))


def test_plain_tally_edges():
    table = torch.tensor([2, 5, 9, keys64.SENTINEL, keys64.SENTINEL])
    q = torch.tensor([9, 5, 5, 1, 10, keys64.SENTINEL, 2, 9, 9])
    assert tdev.small_table_tally(table, q).tolist() == [1, 2, 3, 0, 0]
    empty = torch.zeros(0, dtype=torch.int64)
    assert tdev.small_table_tally(empty, q).numel() == 0
    assert tdev.small_table_tally(table, empty).tolist() == [0] * 5


def test_wrapper_rejects_bad_inputs():
    table = torch.arange(8, dtype=torch.int64)
    acc = torch.zeros(8, dtype=torch.int64)
    keys = torch.arange(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        probe_tally(keys.to(torch.int32), table, acc)
    with pytest.raises(ValueError):
        probe_tally(keys, table, acc[:4])
    with pytest.raises(ValueError):
        probe_tally(keys.reshape(2, 2), table, acc)
    with pytest.raises(ValueError, match="unsupported device"):
        probe_tally(keys.to("meta"), table.to("meta"), acc.to("meta"))
