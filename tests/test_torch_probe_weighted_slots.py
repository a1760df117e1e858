"""Kernel K3 through the prefix directory, on K9d's slots and on a flat
stream: a numpy model of ``probe_tally_weighted_kernel``
(``csrc/probe_tally.cu``) held against the plain version, the wrapper's
slots form on the CPU, and the engine's dedup form (K1 -> K9d -> K3 on
the slots, here through the plain versions) against the JAX package's
``FilteredCounter`` and its dedup-first Pallas step
``join_tally_step_dedup`` in interpret mode.  Integer outputs, exact
equality.

The model: groups of four consecutive keys; in the slots form a group at
or past its row's count is skipped and the keys of a group are read only
below the count (sentinel after), so stale keys past a count never count
even where they are table keys; each key searches its bucket of the
table's directory (``find_rows_dir`` of ``test_torch_directory``) and a
found key adds its weight.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu import engine as jeng
from kmer_denovo_filter_tpu.ops import pallas_join as pj
from kmer_denovo_filter_tpu_torch import engine as teng
from kmer_denovo_filter_tpu_torch import steps
from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops import segsort
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical
from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL
from kmer_denovo_filter_tpu_torch.ops.probe import probe_tally_weighted
from tests.test_torch_directory import (
    KEYS,
    _global,
    find_rows_dir,
    make_table,
)
from tests.test_engine import pack_reads

SEG = segsort.SEGMENT
ROW_BITS = 13
TABLE_KINDS = ("1", "2", "4096", "6145", "all-sentinel",
               "trailing-sentinels", "poly-A")


def k3_model(table, keys, weights, counts=None):
    """``probe_tally_weighted_kernel``: the (M,) tally of *keys* (flat, or
    (S, 8192) slots with *counts*) weighted by *weights*."""
    live, bits, shift, d = _global(table)
    flat, w = keys.reshape(-1), weights.reshape(-1)
    n = flat.size
    i = np.arange(-(-n // KEYS)) * KEYS
    if counts is None:
        end = np.full(i.size, n)
    else:
        assert n % SEG == 0 and SEG % KEYS == 0  # no group straddles a row
        row = i >> ROW_BITS
        end = (row << ROW_BITS) + counts[row]
    act = i < end  # a group at or past its row's count is skipped
    idx = i[:, None] + np.arange(KEYS)[None, :]
    read = act[:, None] & (idx < end[:, None])
    q = np.where(read, flat[np.minimum(idx, n - 1)], SENTINEL)
    found = find_rows_dir(table, d, shift, bits, q.reshape(-1))
    hit = found >= 0
    acc = np.zeros(table.size, dtype=np.int64)
    np.add.at(acc, found[hit], w[idx.reshape(-1)[hit]])
    return acc


def slots_case(table, seed):
    """K9d-shaped slots over *table*: rows whose counts are 0, 8,192 and
    in between, each row's live keys distinct and ascending (table keys
    and misses), the table's first key in every row that has a live slot
    (a key repeated across segments), and stale slots past each count
    filled with table keys."""
    rng = np.random.default_rng(seed)
    live = table[table != SENTINEL]
    pool = np.setdiff1d(rng.integers(0, 1 << 62, 9000, dtype=np.int64),
                        live)
    pool = np.concatenate([live[1:], pool])
    first = live[:1] if live.size else pool[:1]
    counts = np.array([0, SEG, 1, 4095, 4097, 3, 0], dtype=np.int32)
    keys = np.empty((counts.size, SEG), dtype=np.int64)
    weights = rng.integers(1, 50, keys.shape).astype(np.int64)
    stale = live if live.size else pool
    for s, c in enumerate(counts):
        keys[s] = rng.choice(stale, SEG)  # would count if read
        if c:
            keys[s, :c] = np.sort(np.concatenate([
                first, rng.choice(pool, c - 1, replace=False)]))
    return keys, weights, counts


def plain(table, keys, weights, counts=None):
    acc = torch.zeros(table.size, dtype=torch.int64)
    return probe_tally_weighted(
        torch.from_numpy(keys), torch.from_numpy(weights),
        torch.from_numpy(table), acc,
        counts=None if counts is None else torch.from_numpy(counts)).numpy()


@pytest.mark.parametrize("kind", TABLE_KINDS)
def test_slots_model_matches_plain(kind):
    table = make_table(kind, 31)
    keys, weights, counts = slots_case(table, len(kind))
    want = plain(table, keys, weights, counts)
    assert np.array_equal(k3_model(table, keys, weights, counts), want)
    # the plain version reads only below the counts
    live = np.arange(SEG)[None, :] < counts[:, None]
    oracle = np.zeros(table.size, dtype=np.int64)
    rows = {int(k): j for j, k in enumerate(table) if k != SENTINEL}
    for k, w in zip(keys[live].tolist(), weights[live].tolist()):
        if k in rows:
            oracle[rows[k]] += w
    assert np.array_equal(want, oracle)
    if (table != SENTINEL).any():
        assert want.sum() > 0


@pytest.mark.parametrize("kind", TABLE_KINDS)
def test_flat_model_matches_plain(kind):
    """The flat form: the whole-batch dedup of a stream, its last group
    padded with the sentinel."""
    table = make_table(kind, 31)
    rng = np.random.default_rng(7)
    live = table[table != SENTINEL]
    stream = np.concatenate([
        rng.choice(live, 3000) if live.size else np.zeros(0, np.int64),
        rng.integers(0, 1 << 62, 1001, dtype=np.int64),
        np.full(5, SENTINEL, dtype=np.int64)])
    keys, weights = tdev.dedup_windows(torch.from_numpy(stream))
    keys, weights = keys.numpy(), weights.numpy()
    assert keys.size % KEYS != 0 or kind != "1"
    assert np.array_equal(k3_model(table, keys, weights),
                          plain(table, keys, weights))


def test_slots_and_flat_forms_agree_on_k9d_output():
    """K9d's slots (plain version) straight into K3 equal K3 on the
    whole-batch dedup of the same stream, and the unweighted K2."""
    rng = np.random.default_rng(11)
    table = make_table("6145", 31)
    stream = np.concatenate([rng.choice(table, 20000),
                             rng.integers(0, 1 << 62, 7000, dtype=np.int64),
                             np.full(900, SENTINEL, dtype=np.int64)])
    stream = torch.from_numpy(rng.permutation(stream))
    t = torch.from_numpy(table)
    keys, weights, counts = segsort.seg_dedup(stream)
    assert keys.shape[0] == 4 and int(counts.min()) > 0
    slots = probe_tally_weighted(keys, weights, t, torch.zeros_like(t),
                                 counts=counts)
    flat = probe_tally_weighted(*tdev.dedup_windows(stream), t,
                                torch.zeros_like(t))
    assert torch.equal(slots, flat)
    assert torch.equal(slots, tdev.small_table_tally(t, stream))
    assert np.array_equal(slots.numpy(), k3_model(
        table, keys.numpy(), weights.numpy(), counts.numpy()))


def test_slots_form_rejects_bad_arguments():
    t = torch.arange(10, dtype=torch.int64)
    acc = torch.zeros_like(t)
    keys = torch.zeros((2, SEG), dtype=torch.int64)
    counts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="slots"):
        probe_tally_weighted(keys[:, :100], keys[:, :100], t, acc,
                             counts=counts)
    with pytest.raises(ValueError, match="slots"):
        probe_tally_weighted(keys, keys, t, acc, counts=counts[:1])
    with pytest.raises(ValueError, match="slots"):
        probe_tally_weighted(keys, keys, t, acc, counts=counts.long())
    with pytest.raises(ValueError, match="weights"):
        probe_tally_weighted(keys, keys[:1], t, acc, counts=counts)
    assert torch.equal(probe_tally_weighted(keys, keys, t, acc,
                                            counts=counts), acc)


def _batches(seed, k, n_reads, length=64, n_batches=2):
    """Seeded batches of reads with N bases, ragged lengths and duplicated
    reads (weights > 1); each holds more than one 8,192-window segment."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        codes = rng.integers(0, 4, (n_reads, length), dtype=np.uint8)
        codes[rng.random(codes.shape) < 0.02] = 4
        lengths = rng.integers(k - 4, length + 1, n_reads).astype(np.int32)
        codes[1::3] = codes[0:-1:3][:codes[1::3].shape[0]]
        lengths[1::3] = lengths[0:-1:3][:lengths[1::3].shape[0]]
        out.append((codes, lengths))
    return out


def _table_words(batches, k, seed):
    """Half the batches' distinct live keys plus random misses, as the
    JAX package's (M, 2) words."""
    rng = np.random.default_rng(seed)
    win = torch.cat([extract_canonical(torch.from_numpy(c),
                                       torch.from_numpy(l), k).reshape(-1)
                     for c, l in batches])
    live = torch.unique(win[win != SENTINEL])[::2]
    rand = torch.from_numpy(rng.integers(0, 4 ** k, 500, dtype=np.int64))
    return keys64.keys64_to_words(torch.unique(torch.cat([live, rand])), k)


@pytest.mark.parametrize("k", [21, 31])
def test_engine_dedup_form_matches_jax_filtered_counter(k):
    batches = _batches(k, k, 300)
    words = _table_words(batches, k, k)
    tfc = teng.FilteredCounter(teng.KmerIndex(words, k, device="cpu"),
                               dedup=True)
    jfc = jeng.FilteredCounter(jeng.KmerIndex(words, k))
    for codes, lengths in batches:
        n_windows = codes.shape[0] * (codes.shape[1] - k + 1)
        assert n_windows > SEG  # more than one segment
        tfc.feed(codes, lengths)
        jfc.feed(codes, lengths)
    got = tfc.result()
    assert got.max() > 1 and (got == 0).any()
    assert np.array_equal(got, np.asarray(jfc.result()))


def test_engine_dedup_form_matches_join_tally_step_dedup_interpret():
    """Per batch, the engine's dedup form adds what the JAX dedup-first
    step (``_dedup_compact`` over 8,192-row local chunks, then the
    weighted Pallas tally ``_tally_kernel_w``) adds."""
    k = 31
    batches = _batches(5, k, 300, n_batches=1)
    words = _table_words(batches, k, 5)
    t0, t1, perm, p = pj.build_tile_partitions(words)
    tfc = teng.FilteredCounter(teng.KmerIndex(words, k, device="cpu"),
                               dedup=True)
    for codes, lengths in batches:
        ref, ovf_s, ovf_u = pj.join_tally_step_dedup(
            jnp.asarray(t0), jnp.asarray(t1),
            jnp.zeros(t0.shape, jnp.int32), jnp.asarray(codes),
            jnp.asarray(lengths), k, p, interpret=True)
        assert not bool(ovf_s) and not bool(ovf_u)
        tfc.feed(codes, lengths)
    want = np.zeros(words.shape[0], dtype=np.int64)
    cells = np.asarray(ref)[:perm.shape[0]]
    want[perm[perm >= 0]] = cells[perm >= 0]
    got = tfc.result()
    assert got.max() > 1
    assert np.array_equal(got, want)


def test_engine_dedup_form_runs_k9d_then_k3_on_the_slots(monkeypatch):
    """The narrow dedup form hands K9d's slots and counts to K3 as they
    stand: no compaction, no whole-batch dedup in between; K9d in its
    unordered form, since K3 reads no order."""
    calls = []
    real_dedup, real_tally = steps.seg_dedup, steps.probe_tally_weighted

    def dedup(flat, ordered=True):
        assert not ordered
        out = real_dedup(flat, ordered)
        calls.append(("K9d", out))
        return out

    def tally(keys, weights, table, acc, directory=None, counts=None):
        calls.append(("K3", (keys, weights, counts)))
        return real_tally(keys, weights, table, acc, directory, counts)

    monkeypatch.setattr(steps, "seg_dedup", dedup)
    monkeypatch.setattr(steps, "probe_tally_weighted", tally)
    monkeypatch.setattr(tdev, "dedup_windows", None)
    k = 31
    (codes, lengths), = _batches(2, k, 300, n_batches=1)
    words = _table_words([(codes, lengths)], k, 2)
    fc = teng.FilteredCounter(teng.KmerIndex(words, k, device="cpu"),
                              dedup=True)
    fc.feed(codes, lengths)
    assert [name for name, _ in calls] == ["K9d", "K3"]
    assert all(a is b for a, b in zip(calls[0][1], calls[1][1]))
    flat = extract_canonical(torch.from_numpy(codes),
                             torch.from_numpy(lengths), k).reshape(-1)
    assert torch.equal(fc.acc, tdev.small_table_tally(
        fc.index.table, flat))


@pytest.mark.parametrize("k", [31])
def test_engine_dedup_form_matches_oracle_on_reads(k):
    """The packed-read path of the engine tests: the dedup form's counts
    equal a k-mer count of the reads against the table."""
    from kmer_denovo_filter_tpu import kmer as K
    rng = np.random.default_rng(13)
    reads = ["".join(rng.choice(list("ACGTN"), int(m), p=[.24] * 4 + [.04]))
             for m in rng.integers(k, k + 120, 400)]
    batch, lens = pack_reads(reads + reads[:100])
    table_set = set()
    for s in reads[::3]:
        table_set.update(K.extract_read_kmers(s, k)[0].values())
    idx = teng.KmerIndex.from_strings(table_set, k, device="cpu")
    fc = teng.FilteredCounter(idx, dedup=True)
    fc.feed(batch, lens)
    counts = {}
    for s in reads + reads[:100]:
        for c in K.extract_read_kmers(s, k)[0].values():
            if c in table_set:
                counts[c] = counts.get(c, 0) + 1
    got = dict(zip(idx.to_strings(), fc.result().tolist()))
    assert {s: c for s, c in got.items() if c} == counts
