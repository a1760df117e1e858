"""Port membership and anchoring scan (K4's plain path) vs the JAX
package: the XLA ``small_table_member`` / ``small_scan_hits_step`` and
the Pallas member joins in interpret mode — ``join_member_step`` and
``join_member_step_dedup`` (kernel 6) and ``join_member_superbatch_dedup``
(kernel 5).  Bool outputs, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu import engine as jeng
from kmer_denovo_filter_tpu.ops import device as jdev
from kmer_denovo_filter_tpu.ops import encode as jenc
from kmer_denovo_filter_tpu.ops import pallas_join as pj
from kmer_denovo_filter_tpu_torch import engine as teng
from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.member import probe_member, probe_rows

CPU = torch.device("cpu")
_SENT = np.uint32(0xFFFFFFFF)


def _batch(seed, n, length, k):
    """Reads with N bases (sentinel windows) and ragged lengths, some
    rows shorter than k."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, length), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    lengths = rng.integers(k - 6, length + 1, n).astype(np.int32)
    lengths[::3] = length
    lengths[1::7] = k - 2
    return codes, lengths


def _table(k, batches, seed):
    """(M, W) sorted unique words: a third of the batches' live keys
    plus random misses."""
    live = torch.cat([
        tdev.extract_canonical_windows(torch.from_numpy(c),
                                       torch.from_numpy(l), k)[0].reshape(-1)
        for c, l in batches])
    live = torch.unique(live[live != keys64.SENTINEL])[::3]
    rng = np.random.default_rng(seed)
    rand = torch.from_numpy(rng.integers(0, 4 ** k, 200, dtype=np.int64))
    return keys64.keys64_to_words(torch.unique(torch.cat([live, rand])), k)


def _expected_hits(found):
    assert found.any() and not found.all()
    return found


@pytest.mark.parametrize("k", [17, 31])
def test_member_matches_small_table_member(k):
    codes, lengths = _batch(k, 96, 60, k)
    words = _table(k, [(codes, lengths)], k)
    qwords = np.asarray(jdev.extract_canonical_windows(
        jnp.asarray(codes), jnp.asarray(lengths), k)[0]).reshape(-1, 2)
    assert (qwords == _SENT).all(axis=1).any()  # sentinel queries present
    table_pad = jdev.pad_pow2_rows(words, _SENT)
    ref = np.asarray(jdev.small_table_member(
        jnp.asarray(table_pad), jnp.asarray(qwords), 2, 2048))
    ref = ref & ~(qwords == _SENT).all(axis=1)  # the engine's mask
    got = probe_member(keys64.words_to_keys64(qwords, k),
                       keys64.words_to_keys64(words, k))
    assert np.array_equal(_expected_hits(got.numpy()), ref)
    tidx = teng.KmerIndex(words, k, device=CPU)
    jidx = jeng.KmerIndex(words, k)
    assert np.array_equal(tidx.membership(qwords), jidx.membership(qwords))
    assert np.array_equal(tidx.membership(qwords), ref)


@pytest.mark.parametrize("k", [17, 31])
def test_rows_match_lookup_sorted(k):
    """K4's row output (what ``KmerIndex.counts_of`` gathers at) equals
    the positions of the JAX ``lookup_sorted`` where a live key is found,
    and is -1 elsewhere."""
    codes, lengths = _batch(30 + k, 96, 60, k)
    words = _table(k, [(codes, lengths)], k)
    qwords = np.asarray(jdev.extract_canonical_windows(
        jnp.asarray(codes), jnp.asarray(lengths), k)[0]).reshape(-1, 2)
    idx, found = jdev.lookup_sorted(jnp.asarray(words), jnp.asarray(qwords),
                                    2)
    found = np.asarray(found) & ~(qwords == _SENT).all(axis=1)
    rows = probe_rows(keys64.words_to_keys64(qwords, k),
                      keys64.words_to_keys64(words, k)).numpy()
    assert np.array_equal(rows[found], np.asarray(idx)[found])
    assert (rows[~_expected_hits(found)] == -1).all()


@pytest.mark.parametrize("k", [17, 31])
def test_scan_matches_small_scan_hits_step(k):
    codes, lengths = _batch(10 + k, 80, 70, k)
    words = _table(k, [(codes, lengths)], 1)
    ref = np.asarray(jdev.small_scan_hits_step(
        jnp.asarray(jdev.pad_pow2_rows(words, _SENT)), jnp.asarray(codes),
        jnp.asarray(lengths), k, 2, 2048))
    tidx = teng.KmerIndex(words, k, device=CPU)
    got = teng.scan_reads_for_hits(tidx, codes, lengths)
    assert got.shape == (80, 70 - k + 1)
    assert np.array_equal(_expected_hits(got), ref)
    assert np.array_equal(
        tdev.small_scan_hits_step(tidx.table, torch.from_numpy(codes),
                                  torch.from_numpy(lengths), k).numpy(),
        ref)


@pytest.mark.parametrize("k", [17, 31])
def test_scan_matches_pallas_join_member_interpret(k):
    """Kernel 6, one batch, plain and dedup-first forms."""
    codes, lengths = _batch(20 + k, 64, 64, k)
    codes = np.concatenate([codes, codes[:24]])  # duplicate runs
    lengths = np.concatenate([lengths, lengths[:24]])
    words = _table(k, [(codes, lengths)], 2)
    t0, t1, _perm, p = pj.build_tile_partitions(words)
    codes_p, lens_p = jeng.pad_read_batch(codes, lengths)
    s = codes.shape[1] - k + 1
    ref, ovf = pj.join_member_step(
        jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(codes_p),
        jnp.asarray(lens_p), k, p, interpret=True)
    assert not bool(ovf)
    ref = np.asarray(ref)[:codes.shape[0], :s]
    ref_dd, ovf_s, ovf_u = pj.join_member_step_dedup(
        jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(codes_p),
        jnp.asarray(lens_p), k, p, interpret=True)
    assert not bool(ovf_s) and not bool(ovf_u)
    assert np.array_equal(np.asarray(ref_dd)[:codes.shape[0], :s], ref)
    got = teng.scan_reads_for_hits(teng.KmerIndex(words, k, device=CPU),
                                   codes, lengths)
    assert np.array_equal(_expected_hits(got), ref)


def test_scan_many_matches_pallas_superbatch_interpret():
    """Kernel 5: a group whose batches differ in L, joined once."""
    k = 31
    batches = [_batch(40 + i, 64, length, k)
               for i, length in enumerate((40, 70, 90))]
    words = _table(k, batches, 3)
    t0, t1, _perm, p = pj.build_tile_partitions(words)
    padded = [jeng.pad_read_batch(c, l) for c, l in batches]
    lmax = max(cp.shape[1] for cp, _ in padded)
    codes_nb = np.stack([np.pad(cp, ((0, 0), (0, lmax - cp.shape[1])),
                                constant_values=4) for cp, _ in padded])
    lens_nb = np.stack([lp for _, lp in padded])
    ref_nb, ovf_s, ovf_u = pj.join_member_superbatch_dedup(
        jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(codes_nb),
        jnp.asarray(lens_nb), k, p, interpret=True)
    assert not bool(ovf_s) and not bool(ovf_u)
    tidx = teng.KmerIndex(words, k, device=CPU)
    got = teng.make_scanner_many(tidx)(batches)
    for i, (c, _l) in enumerate(batches):
        ref = np.asarray(ref_nb[i])[:c.shape[0], :c.shape[1] - k + 1]
        assert got[i].shape == ref.shape
        assert np.array_equal(_expected_hits(got[i]), ref), i


def test_scan_many_equals_per_batch_scans():
    """Groups with differing B and L, a batch narrower than k, and an
    empty batch split back exactly as per-batch scans."""
    k = 31
    batches = [_batch(50, 30, 80, k), _batch(51, 7, 45, k),
               _batch(52, 12, 20, 15), _batch(53, 0, 60, k)]
    words = _table(k, batches[:2], 4)
    tidx = teng.KmerIndex(words, k, device=CPU)
    got = teng.scan_reads_for_hits_many(tidx, batches)
    scan = teng.make_scanner(tidx)
    for (c, l), g in zip(batches, got):
        assert g.shape == (c.shape[0], max(0, c.shape[1] - k + 1))
        assert np.array_equal(g, scan(c, l))
    assert got[0].any() and not got[2].size


def test_member_edges():
    table = torch.tensor([2, 5, 9, keys64.SENTINEL])
    q = torch.tensor([9, 5, 1, 10, keys64.SENTINEL, 2, 3])
    assert tdev.member(table, q).tolist() == [True, True, False, False,
                                              False, True, False]
    empty = torch.zeros(0, dtype=torch.int64)
    assert not tdev.member(empty, q).any()
    assert probe_member(empty, table).shape == (0,)
    assert probe_rows(q, table).tolist() == [2, 1, -1, -1, -1, 0, -1]
    assert probe_rows(q, empty).tolist() == [-1] * 7
    words = jenc.kmers_to_keys(["A" * 31], 31)
    tidx = teng.KmerIndex(words, 31, device=CPU)
    assert tidx.membership(words[:0]).shape == (0,)


def test_member_wrapper_rejects_bad_inputs():
    table = torch.arange(8, dtype=torch.int64)
    with pytest.raises(TypeError):
        probe_member(torch.arange(4, dtype=torch.int32), table)
    with pytest.raises(ValueError):
        probe_member(torch.arange(4).reshape(2, 2), table)
    with pytest.raises(ValueError, match="unsupported device"):
        probe_member(torch.arange(4).to("meta"), table.to("meta"))
