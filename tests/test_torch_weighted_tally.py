"""Port dedup-first tally (``dedup_windows`` + K3's plain path) vs the JAX
package's tile-join tallies in Pallas interpret mode: the weighted
``join_tally_step_dedup`` (kernel 3) and the unweighted
``join_tally_step`` (kernel 4), both mapped back to table order through
the tile permutation; and vs the port's own K2 plain path on the same
batch.  Integer outputs, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu.ops import pallas_join as pj
from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical
from kmer_denovo_filter_tpu_torch.ops.probe import probe_tally_weighted


def _case(seed, k, n_reads=96, length=64):
    """Reads with N bases and ragged lengths, 32 of them duplicated (so
    dedup weights exceed 1), and a table of half the batch's live keys
    plus random misses as (M, 2) words."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n_reads, length), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    lengths = rng.integers(k - 4, length + 1, n_reads).astype(np.int32)
    codes = np.concatenate([codes, codes[:32]])
    lengths = np.concatenate([lengths, lengths[:32]])
    win = extract_canonical(torch.from_numpy(codes),
                            torch.from_numpy(lengths), k).reshape(-1)
    live = torch.unique(win[win != keys64.SENTINEL])[::2]
    rand = torch.from_numpy(rng.integers(0, 4 ** k, 100, dtype=np.int64))
    words = keys64.keys64_to_words(torch.unique(torch.cat([live, rand])), k)
    return codes, lengths, win, words


def _from_tiles(acc, perm, m):
    out = np.zeros(m, dtype=np.int64)
    cells = np.asarray(acc)[:perm.shape[0]]
    ok = perm >= 0
    out[perm[ok]] = cells[ok]
    return out


def _port_dedup_tally(win, words, k):
    table = keys64.words_to_keys64(words, k)
    keys, weights = tdev.dedup_windows(win)
    acc = torch.zeros(table.shape[0], dtype=torch.int64)
    return probe_tally_weighted(keys, weights, table, acc).numpy()


@pytest.mark.parametrize("k", [17, 31])
def test_matches_pallas_weighted_join_interpret(k):
    """Kernel 3: the JAX dedup-first step's weighted tile join."""
    codes, lengths, win, words = _case(k, k)
    t0, t1, perm, p = pj.build_tile_partitions(words)
    ref, ovf_s, ovf_u = pj.join_tally_step_dedup(
        jnp.asarray(t0), jnp.asarray(t1), jnp.zeros(t0.shape, jnp.int32),
        jnp.asarray(codes), jnp.asarray(lengths), k, p, interpret=True)
    assert not bool(ovf_s) and not bool(ovf_u)
    got = _port_dedup_tally(win, words, k)
    assert (got > 1).any() and (got == 0).any()
    assert np.array_equal(got, _from_tiles(ref, perm, words.shape[0]))


def test_matches_pallas_unweighted_join_interpret_and_k2_plain():
    """Kernel 4 (the unweighted tile join, whose port is K2's global
    branch) and the port's K2 plain path give the dedup-first tally."""
    k = 31
    codes, lengths, win, words = _case(3, k)
    t0, t1, perm, p = pj.build_tile_partitions(words)
    ref, ovf = pj.join_tally_step(
        jnp.asarray(t0), jnp.asarray(t1), jnp.zeros(t0.shape, jnp.int32),
        jnp.asarray(codes), jnp.asarray(lengths), k, p, interpret=True)
    assert not bool(ovf)
    ref = _from_tiles(ref, perm, words.shape[0])
    got = _port_dedup_tally(win, words, k)
    assert (got > 1).any()
    assert np.array_equal(got, ref)
    plain = tdev.small_table_tally(keys64.words_to_keys64(words, k), win)
    assert np.array_equal(got, plain.numpy())


def test_dedup_windows_and_sort_count():
    k = 31
    _codes, _lengths, win, _words = _case(5, k)
    keys, weights = tdev.dedup_windows(win)
    assert keys.dtype == weights.dtype == torch.int64
    assert (keys[1:] > keys[:-1]).all()
    assert int(weights.sum()) == win.numel()
    assert int(keys[-1]) == keys64.SENTINEL  # sentinel row sorts last
    live, counts = tdev.sort_count(win)
    assert torch.equal(live, keys[:-1]) and torch.equal(counts, weights[:-1])
    assert int(counts.sum()) == int((win != keys64.SENTINEL).sum())
    no_sent = win[win != keys64.SENTINEL]
    assert torch.equal(tdev.sort_count(no_sent)[0], live)
    empty = torch.zeros(0, dtype=torch.int64)
    assert tdev.sort_count(empty)[0].numel() == 0


def test_weighted_tally_edges():
    table = torch.tensor([2, 5, 9, keys64.SENTINEL, keys64.SENTINEL])
    keys = torch.tensor([1, 2, 5, 9, 10, keys64.SENTINEL])
    weights = torch.tensor([7, 3, 4, 1, 6, 100])
    acc = torch.full((5,), 10, dtype=torch.int64)
    out = probe_tally_weighted(keys, weights, table, acc)
    assert out is acc
    assert acc.tolist() == [13, 14, 11, 10, 10]
    empty = torch.zeros(0, dtype=torch.int64)
    assert probe_tally_weighted(keys, weights, empty, empty).numel() == 0
    with pytest.raises(ValueError, match="weights"):
        probe_tally_weighted(keys, weights[:3], table, acc)
    with pytest.raises(TypeError):
        probe_tally_weighted(keys, weights.to(torch.int32), table, acc)
