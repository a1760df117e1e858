"""The port's segment-local sort and dedup (``ops/segsort.py``, the plain
paths of kernels K9 and K9d) on the CPU: their invariants, and the dedup
against the JAX front half ``pallas_join._dedup_compact`` on the same
window stream, weights summed by key per 8,192-row segment.  Integer
outputs, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu.ops import pallas_join as pj
from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops import segsort
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical

SEG = segsort.SEGMENT
K = 31


def _windows(seed, n_reads, length=94, dup=0):
    """Flat K1 keys of reads with N bases, ragged lengths (some shorter
    than k), an all-N last read, and each of the first *dup* even reads
    repeated in the next row."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n_reads, length), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[-1] = 4
    lengths = np.full(n_reads, length, np.int32)
    lengths[::3] = rng.integers(0, length + 1, len(lengths[::3]))
    codes[1:2 * dup:2] = codes[0:2 * dup:2]
    lengths[1:2 * dup:2] = lengths[0:2 * dup:2]
    return extract_canonical(torch.from_numpy(codes),
                             torch.from_numpy(lengths), K).reshape(-1)


def _mixed(keys):
    """The JAX package's mixed (hi, lo) uint32 words of int64 keys, the
    sentinel pinned to the all-ones pair."""
    words = keys64.keys64_to_words(keys, K)
    hi, lo = pj.mix_keys_np(words[:, 0], words[:, 1])
    sent = keys.numpy() == keys64.SENTINEL
    hi[sent] = lo[sent] = 0xFFFFFFFF
    return hi, lo


def _by_key(hi, lo, weights):
    """{(hi, lo): summed weight} over live rows of positive weight."""
    out = {}
    for h, l, w in zip(hi.tolist(), lo.tolist(), weights.tolist()):
        if w and (h, l) != (0xFFFFFFFF, 0xFFFFFFFF):
            out[(h, l)] = out.get((h, l), 0) + w
    return out


# 128 reads of 64 windows: exactly one segment; 200 reads: a ragged
# second segment; 300 reads, 100 repeated: three segments, weights > 1
@pytest.mark.parametrize("n_reads,dup", [(128, 0), (200, 0), (300, 100)])
def test_dedup_matches_jax_dedup_compact_per_segment(n_reads, dup):
    flat = _windows(n_reads, n_reads, dup=dup)
    assert (flat.numel() % SEG == 0) == (n_reads == 128)
    keys, weights, counts = segsort.seg_dedup(flat)
    n_seg = keys.shape[0]
    hi, lo = _mixed(segsort.segments(flat, keys64.SENTINEL).reshape(-1))
    hc, lc, wc, overflow = pj._dedup_compact(jnp.asarray(hi),
                                             jnp.asarray(lo), SEG)
    assert not bool(overflow)
    hc, lc, wc = (np.asarray(a).reshape(n_seg, SEG) for a in (hc, lc, wc))
    for s in range(n_seg):
        c = int(counts[s])
        got_hi, got_lo = _mixed(keys[s, :c])
        want = _by_key(hc[s], lc[s], wc[s])
        assert _by_key(got_hi, got_lo, weights[s, :c].numpy()) == want
        assert c == len(want)
    if dup:
        assert int(weights.max()) > 1


def test_dedup_segments_matches_the_whole_batch_dedup():
    """K9d's slots, compacted, summed by key: the whole-batch dedup."""
    flat = torch.cat([_windows(7, 300, dup=100)] * 2)  # repeats far apart
    keys, weights = tdev.segment_compact(*segsort.seg_dedup(flat))
    assert not (keys == keys64.SENTINEL).any()
    live = flat[flat != keys64.SENTINEL]
    assert int(weights.sum()) == live.numel()
    assert keys.numel() > torch.unique(live).numel()  # runs split at segments
    uniq, inverse = torch.unique(keys, return_inverse=True)
    summed = torch.zeros_like(uniq).index_add_(0, inverse, weights)
    ref_keys, ref_counts = torch.unique(live, return_counts=True)
    assert torch.equal(uniq, ref_keys) and torch.equal(summed, ref_counts)


@pytest.mark.parametrize("n", [0, 1, SEG - 1, SEG, 2 * SEG + 5])
def test_seg_sort_invariants(n):
    rng = np.random.default_rng(n)
    flat = torch.from_numpy(rng.integers(0, 50, n).astype(np.int64))
    flat[torch.from_numpy(rng.random(n) < 0.1)] = keys64.SENTINEL
    payload = torch.arange(n, dtype=torch.int32)
    keys, pay = segsort.seg_sort(flat, payload)
    n_seg = -(-n // SEG)
    assert keys.shape == pay.shape == (n_seg, SEG)
    assert keys.dtype == torch.int64 and pay.dtype == torch.int32
    assert (keys[:, 1:] >= keys[:, :-1]).all()
    padded = segsort.segments(flat, keys64.SENTINEL)
    assert torch.equal(keys, torch.sort(padded, dim=1).values)
    # every payload lands once, beside its own key; padding carries -1
    real = pay >= 0
    assert torch.equal(torch.sort(pay[real]).values, payload)
    assert torch.equal(keys[real], flat[pay[real].long()])
    assert (keys[~real] == keys64.SENTINEL).all()
    assert int((~real).sum()) == n_seg * SEG - n
    only_keys, none = segsort.seg_sort(flat)
    assert none is None and torch.equal(only_keys, keys)


def test_seg_dedup_invariants_and_edge_segments():
    """Four segments: random keys with sentinels, one key repeated, all
    sentinel, a few distinct keys; then a partial fifth."""
    rng = np.random.default_rng(1)
    parts = [rng.integers(0, 4 ** 31, SEG), np.full(SEG, 12345),
             np.full(SEG, keys64.SENTINEL), rng.integers(0, 40, SEG),
             rng.integers(0, 40, 100)]
    flat = torch.from_numpy(np.concatenate(parts).astype(np.int64))
    flat[:100] = keys64.SENTINEL
    keys, weights, counts = segsort.seg_dedup(flat)
    assert keys.shape == weights.shape == (5, SEG)
    assert counts.dtype == torch.int32
    assert counts.tolist()[1:3] == [1, 0] and counts[3] <= 40
    assert int(weights[1, 0]) == SEG and int(keys[1, 0]) == 12345
    padded = segsort.segments(flat, keys64.SENTINEL)
    for s in range(5):
        c = int(counts[s])
        live = padded[s][padded[s] != keys64.SENTINEL]
        uniq, n = torch.unique(live, return_counts=True)
        assert torch.equal(keys[s, :c], uniq)
        assert torch.equal(weights[s, :c], n)
        assert (keys[s, c:] == keys64.SENTINEL).all()
        assert (weights[s, c:] == 0).all()
    dense_keys, dense_weights = tdev.segment_compact(keys, weights, counts)
    assert dense_keys.numel() == int(counts.sum())
    assert int(dense_weights.sum()) == int((flat != keys64.SENTINEL).sum())


def test_all_sentinel_and_empty_streams():
    for flat in (torch.full((SEG + 3,), keys64.SENTINEL),
                 torch.zeros(0, dtype=torch.int64)):
        keys, weights = tdev.segment_compact(*segsort.seg_dedup(flat))
        assert keys.numel() == weights.numel() == 0
        assert int(segsort.seg_dedup(flat)[2].sum()) == 0


def test_wrappers_reject_bad_arguments():
    flat = torch.arange(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        segsort.seg_sort(flat.to(torch.int32))
    with pytest.raises(ValueError, match="int64"):
        segsort.seg_dedup(flat.reshape(2, 5))
    with pytest.raises(ValueError, match="payload"):
        segsort.seg_sort(flat, torch.arange(10, dtype=torch.int64))
    with pytest.raises(ValueError, match="payload"):
        segsort.seg_sort(flat, torch.arange(9, dtype=torch.int32))
