"""The port's wide segment dedup (``segsort.seg_dedup_wide``, the plain
path of kernel K9dw) on the CPU: against the JAX front half
``pallas_join._dedup_compact_wide`` on the same rows, weights summed by
row per 8,192-row chunk (the JAX chunk is in route-hash order, and a
hash collision may split a row's run in two, pallas_join.py:1497-1499);
K7 weighted on its slots against K7's flat form; and the engine's wide
dedup form (K1w -> K9dw -> K7 on the slots) against the JAX
FilteredCounter and ``join_tally_flat_wide_dedup`` in Pallas interpret
mode.  Integer outputs, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu import engine as jeng
from kmer_denovo_filter_tpu.ops import pallas_join as pj
from kmer_denovo_filter_tpu_torch import engine as teng
from kmer_denovo_filter_tpu_torch import tracing
from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops import segsort
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical_wide
from kmer_denovo_filter_tpu_torch.ops.probe import probe_tally_wide

SEG = segsort.SEGMENT
CPU = torch.device("cpu")
ALL_ONES = 0xFFFFFFFF


def _windows(k, seed, n_reads, dup):
    """Flat K1w rows of reads of k + 60 bp with N bases and ragged
    lengths (some shorter than k); each of the first *dup* even reads
    repeated in the next row, so a segment holds rows more than once."""
    rng = np.random.default_rng(seed)
    length = k + 60
    codes = rng.integers(0, 4, (n_reads, length), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    lengths = np.full(n_reads, length, np.int32)
    lengths[::3] = rng.integers(0, length + 1, len(lengths[::3]))
    codes[1:2 * dup:2] = codes[0:2 * dup:2]
    lengths[1:2 * dup:2] = lengths[0:2 * dup:2]
    return extract_canonical_wide(torch.from_numpy(codes),
                                  torch.from_numpy(lengths), k).flatten(0, 1)


def _by_row(words, weights):
    """{row of words: summed weight} over live rows of positive weight."""
    out = {}
    for row, w in zip(map(tuple, np.asarray(words).tolist()),
                      np.asarray(weights).tolist()):
        if w and not all(x == ALL_ONES for x in row):
            out[row] = out.get(row, 0) + w
    return out


# 400 reads of k + 60 bp, 100 of them repeated: three segments, the
# last ragged, weights above 1
@pytest.mark.parametrize("k", [33, 63, 127, 201])
def test_matches_jax_dedup_compact_wide_per_chunk(k):
    flat = _windows(k, k, 400, dup=100)
    keys, weights, counts = segsort.seg_dedup_wide(flat)
    n_seg, q = keys.shape[0], flat.shape[1]
    assert n_seg == 3 and flat.shape[0] % SEG
    padded = segsort.segments(flat, keys64.SENTINEL).reshape(-1, q)
    cols, wgt, overflow = pj._dedup_compact_wide(
        jnp.asarray(keys64.limbs_to_words(padded, k)), pj.LCHUNK_DD)
    assert not bool(overflow)
    cols = np.stack([np.asarray(c).reshape(n_seg, SEG) for c in cols], -1)
    wgt = np.asarray(wgt).reshape(n_seg, SEG)
    for s in range(n_seg):
        c = int(counts[s])
        rows = keys[s, :c]
        # distinct live rows, ascending
        assert (rows[:, 0] != keys64.SENTINEL).all()
        assert torch.equal(tdev.unique_rows(rows)[0], rows)
        want = _by_row(cols[s], wgt[s])
        got = _by_row(keys64.limbs_to_words(rows, k), weights[s, :c])
        assert got == want and c == len(want)
    assert int(weights.max()) > 1


def test_slots_sum_to_the_whole_batch_dedup():
    """K9dw's slots, compacted and summed by row, are the whole-batch
    dedup; runs split only at segment edges."""
    flat = torch.cat([_windows(63, 7, 200, dup=60)] * 2)  # repeats far apart
    rows, weights = tdev.segment_compact(*segsort.seg_dedup_wide(flat))
    assert rows.shape[0] > tdev.unique_rows(rows)[0].shape[0]
    uniq, inverse, _counts = tdev.unique_rows(rows)
    summed = torch.zeros(uniq.shape[0], dtype=torch.int64).index_add_(
        0, inverse, weights)
    live = flat[flat[:, 0] != keys64.SENTINEL]
    ref_rows, ref_counts = tdev.dedup_windows_wide(live)
    assert torch.equal(uniq, ref_rows) and torch.equal(summed, ref_counts)


def test_edge_segments():
    """All sentinel, one row 8,192 times, all distinct, rows tied on limb
    0 that differ only in their last limb, and a ragged tail."""
    rng = np.random.default_rng(4)
    q = 3
    tied = rng.integers(0, 1 << 62, (SEG, q))
    tied[:, :-1] = 7
    parts = [np.full((SEG, q), keys64.SENTINEL),
             np.repeat(rng.integers(0, 1 << 62, (1, q)), SEG, axis=0),
             rng.integers(0, 1 << 62, (SEG, q)), tied,
             rng.integers(0, 5, (100, q))]
    flat = torch.from_numpy(np.concatenate(parts).astype(np.int64))
    keys, weights, counts = segsort.seg_dedup_wide(flat)
    assert keys.shape == (5, SEG, q) and weights.shape == (5, SEG)
    assert counts.dtype == torch.int32
    assert counts.tolist()[:4] == [0, 1, SEG, SEG]
    assert int(weights[1, 0]) == SEG
    padded = segsort.segments(flat, keys64.SENTINEL)
    for s in range(5):
        c = int(counts[s])
        live = padded[s][padded[s][:, 0] != keys64.SENTINEL]
        uniq, n = torch.unique(live, dim=0, return_counts=True)
        assert torch.equal(keys[s, :c], uniq)
        assert torch.equal(weights[s, :c], n)
        assert (keys[s, c:] == keys64.SENTINEL).all()
        assert (weights[s, c:] == 0).all()
    assert torch.equal(keys[3, :SEG, -1], torch.sort(flat[3 * SEG:4 * SEG,
                                                          -1]).values)


def test_empty_and_all_sentinel_streams():
    for flat in (torch.full((SEG + 3, 2), keys64.SENTINEL),
                 torch.zeros((0, 2), dtype=torch.int64)):
        keys, weights, counts = segsort.seg_dedup_wide(flat)
        assert int(counts.sum()) == 0
        assert tdev.segment_compact(keys, weights, counts)[0].shape == (0, 2)


def test_wrappers_reject_bad_arguments():
    rows = torch.zeros((10, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        segsort.seg_dedup_wide(rows.to(torch.int32))
    with pytest.raises(ValueError, match="Q in"):
        segsort.seg_dedup_wide(torch.zeros((10, 1), dtype=torch.int64))
    with pytest.raises(ValueError, match="Q in"):
        segsort.seg_dedup_wide(torch.zeros(10, dtype=torch.int64))
    keys, weights, counts = segsort.seg_dedup_wide(rows)
    table = torch.zeros((1, 3), dtype=torch.int64)
    acc = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="slots"):
        probe_tally_wide(keys, table, acc, None, counts=counts)
    with pytest.raises(ValueError, match="slots"):
        probe_tally_wide(keys, table, acc, weights, counts=counts.long())
    with pytest.raises(ValueError, match="slots"):
        probe_tally_wide(keys[:, :100], table, acc, weights[:, :100],
                         counts=counts)


def test_k7_on_slots_equals_its_flat_form_and_skips_stale_rows():
    """K7 weighted on K9dw's slots equals K7 on the whole-batch dedup and
    the plain tally; table rows planted past each count, with large
    weights, are never counted."""
    k = 63
    flat = _windows(k, 5, 400, dup=100)
    keys, weights, counts = segsort.seg_dedup_wide(flat)
    live = flat[flat[:, 0] != keys64.SENTINEL]
    table = tdev.unique_rows(live)[0][::3].contiguous()
    keys, weights = keys.clone(), weights.clone()
    for s, c in enumerate(counts.tolist()):
        keys[s, c:c + 50] = table[:50]
        weights[s, c:c + 50] = 1000
    acc = torch.full((table.shape[0],), 2, dtype=torch.int64)
    assert probe_tally_wide(keys, table, acc, weights, counts=counts) is acc
    uniq, uniq_weights = tdev.dedup_windows_wide(flat)
    flat_acc = probe_tally_wide(uniq, table, torch.full_like(acc, 2),
                                uniq_weights)
    plain = tdev.small_table_tally_wide(table, flat)
    assert torch.equal(acc, flat_acc) and torch.equal(acc - 2, plain)
    assert int(plain.max()) > 1


def _synth(rng, genome, n_reads, length, k):
    """Position-local reads of a short genome (coverage ~20x), 0.2 %
    substitutions and a few N bases; codes and lengths."""
    starts = np.sort(rng.integers(0, genome.size - length, n_reads))
    codes = genome[starts[:, None] + np.arange(length)[None, :]]
    err = rng.random(codes.shape) < 0.002
    codes = np.where(err, (codes + 1) % 4, codes).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.002] = 4
    lengths = np.full(n_reads, length, np.int32)
    lengths[::7] = rng.integers(k - 3, length + 1, len(lengths[::7]))
    return codes, lengths


def test_engine_wide_dedup_form_matches_jax_counter_and_kernel7():
    """k = 63: the engine's dedup form over three batches of two segments
    each equals the JAX FilteredCounter, one ``join_tally_flat_wide_dedup``
    over the whole stream in Pallas interpret mode (tile order mapped back
    to table order) and the plain tally."""
    k = 63
    rng = np.random.default_rng(63)
    genome = rng.integers(0, 4, 700).astype(np.uint8)
    batches = [_synth(rng, genome, 100, k + 89, k) for _ in range(3)]
    flat = torch.cat([extract_canonical_wide(
        torch.from_numpy(c), torch.from_numpy(l), k).flatten(0, 1)
        for c, l in batches])
    live = tdev.unique_rows(flat[flat[:, 0] != keys64.SENTINEL])[0]
    rand = torch.stack([torch.from_numpy(rng.integers(0, 4 ** nb, 80))
                        for nb in keys64.limb_bases(k)], 1)
    table = tdev.unique_rows(torch.cat([live[::2], rand]))[0]
    words = keys64.limbs_to_words(table, k)

    fc = teng.make_parent_filter_counter(words, k, device=CPU)
    assert fc.dedup
    launches = tracing.counter("launches.seg_dedup_wide")
    jfc = jeng.FilteredCounter(jeng.KmerIndex(words, k))
    for codes, lengths in batches:
        assert codes.shape[0] * (codes.shape[1] - k + 1) > SEG
        fc.feed(codes, lengths)
        jfc.feed(codes, lengths)
    got = fc.result()
    # the CPU: plain path
    assert tracing.counter("launches.seg_dedup_wide") == launches
    assert np.array_equal(got, jfc.result()[:words.shape[0]])
    plain = tdev.small_table_tally_wide(table, flat).numpy()
    assert np.array_equal(got, plain) and plain.max() > 1

    planes, perm, p = pj.build_tile_partitions_wide(words)
    planes = tuple(jnp.asarray(x) for x in planes)
    w = words.shape[1]
    ref, ovf_span, ovf_u = pj.join_tally_flat_wide_dedup(
        planes, jnp.zeros(planes[0].shape, jnp.int32),
        jnp.asarray(keys64.limbs_to_words(flat, k)), p,
        w_part=min(pj.W_PART_TALLY, pj.wide_dd_w_part_cap(w)),
        u_chunk=pj.LCHUNK_DD // 2, interpret=True)
    assert not bool(ovf_span) and not bool(ovf_u)
    cells = np.asarray(ref)[:perm.shape[0]]
    from_tiles = np.zeros(table.shape[0], dtype=np.int64)
    from_tiles[perm[perm >= 0]] = cells[perm >= 0]
    assert np.array_equal(got, from_tiles)
