"""The key form's one seam (``kmer_denovo_filter_tpu_torch/steps.py``).

For k = 31 (one int64 a key), 63 and 201 (rows of 3 and 7 limbs), on
the CPU: :func:`steps.dedup` then :func:`steps.tally` equals the ops
pair it stands for (K9d -> K3, or K9dw -> K7, on the slots), the plain
tally of every window and the engine's dedup-first ``FilteredCounter``;
:func:`steps.sort_count` then :func:`steps.to_words` equals the plain
sort-count and ``StreamCounter.result()``.  And the engine and the
sharded and multi-host engines reach no private name of one another and
no form's kernel wrapper: ``steps`` picks those.
"""

import ast
import os

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch import steps
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.probe import (
    probe_tally_weighted,
    probe_tally_wide,
)
from kmer_denovo_filter_tpu_torch.ops.segsort import (
    SEGMENT,
    seg_dedup,
    seg_dedup_wide,
)

CPU = torch.device("cpu")
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "kmer_denovo_filter_tpu_torch")
SEAM = {"kmer_denovo_filter_tpu_torch.engine": "engine.py",
        "kmer_denovo_filter_tpu_torch.parallel.sharded":
            os.path.join("parallel", "sharded.py"),
        "kmer_denovo_filter_tpu_torch.parallel.multihost":
            os.path.join("parallel", "multihost.py")}
PARALLEL = "kmer_denovo_filter_tpu_torch.parallel"


def _batch(k, n_reads=200):
    """Reads with N bases, ragged lengths and every third read repeated
    (keys of weight > 1), over more than one 8,192-window segment."""
    rng = np.random.default_rng(k)
    length = k + 60
    codes = rng.integers(0, 4, (n_reads, length), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    lengths = rng.integers(k - 4, length + 1, n_reads).astype(np.int32)
    codes[1::3] = codes[0:-1:3][:codes[1::3].shape[0]]
    lengths[1::3] = lengths[0:-1:3][:lengths[1::3].shape[0]]
    return codes, lengths


def _words(rows, k):
    """(N, Q) limb rows as the JAX package's (N, W) words."""
    if k <= keys64.NARROW_K:
        return keys64.keys64_to_words(rows[:, 0], k)
    return keys64.limbs_to_words(rows, k)


@pytest.mark.parametrize("k", [31, 63, 201])
def test_dedup_then_tally_is_the_ops_pair_and_the_plain_tally(k):
    codes, lengths = _batch(k)
    flat = steps.window_keys(codes, lengths, k, CPU).flatten(0, 1)
    assert flat.shape[0] > SEGMENT
    rows = flat.reshape(flat.shape[0], -1)
    live = dev.unique_rows(rows[rows[:, 0] != keys64.SENTINEL])[0]
    index = eng.KmerIndex(_words(live[::2], k), k, device=CPU)
    got = torch.zeros(index.n, dtype=torch.int64)
    keys, weights, counts, passed = steps.dedup(flat)
    steps.tally(keys, index, got, weights, counts)
    pair = torch.zeros_like(got)
    if k <= keys64.NARROW_K:
        slots = seg_dedup(flat, ordered=False)
        probe_tally_weighted(slots[0], slots[1], index.table, pair, None,
                             slots[2])
        plain = dev.small_table_tally(index.table, flat)
    else:
        slots = seg_dedup_wide(flat, ordered=False)
        probe_tally_wide(slots[0], index.table, pair, slots[1], None,
                         slots[2])
        plain = dev.small_table_tally_wide(index.table, flat)
    assert int(counts.sum()) < flat.shape[0]  # the repeats merged
    assert passed.shape == counts.shape
    assert torch.equal(got, pair)
    assert torch.equal(got, plain)
    assert int(plain.sum()) > index.n
    fc = eng.FilteredCounter(index, dedup=True)
    fc.feed(codes, lengths)
    assert np.array_equal(fc.result(), got.numpy())


@pytest.mark.parametrize("k", [31, 63, 201])
def test_sort_count_then_words_is_the_plain_count_and_the_stream_count(k):
    codes, lengths = _batch(k)
    flat = steps.window_keys(codes, lengths, k, CPU).flatten(0, 1)
    rows, counts = steps.sort_count(flat, k)
    assert rows.shape == (counts.shape[0], keys64.limbs_per_kmer(k))
    words = steps.to_words(rows, k)
    plain = (dev.sort_count(flat) if k <= keys64.NARROW_K
             else dev.sort_count_wide(flat))
    assert np.array_equal(words, _words(plain[0].reshape(rows.shape), k))
    assert torch.equal(counts, plain[1])
    assert int(counts.sum()) == int(
        (flat.reshape(flat.shape[0], -1)[:, 0] != keys64.SENTINEL).sum())
    sc = eng.StreamCounter(k, device=CPU)
    sc.feed(codes, lengths)
    want_words, want_counts = sc.result()
    assert np.array_equal(words, want_words)
    assert np.array_equal(counts.numpy(), want_counts)


def _crossings(module, path):
    """The names *path* (the module *module*) takes from another module
    of :data:`SEAM` (or ``parallel``) that start with ``_``, and every
    name it uses that ends in ``_wide`` (a form's kernel wrapper)."""
    with open(os.path.join(PKG, path)) as fh:
        tree = ast.parse(fh.read())
    others = (set(SEAM) | {PARALLEL}) - {module}
    aliases, found = {}, []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                full = f"{node.module}.{alias.name}"
                if full in others:
                    aliases[alias.asname or alias.name] = full
                elif node.module in others and alias.name.startswith("_"):
                    found.append(full)
                if alias.name.endswith("_wide"):
                    found.append(full)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name in others:
                    aliases[alias.asname or alias.name] = alias.name
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in aliases
                and node.attr.startswith("_")
                and not node.attr.startswith("__")):
            found.append(f"{aliases[node.value.id]}.{node.attr}")
        name = (node.id if isinstance(node, ast.Name)
                else node.attr if isinstance(node, ast.Attribute) else "")
        if name.endswith("_wide"):
            found.append(name)
    return found


@pytest.mark.parametrize("module", sorted(SEAM))
def test_the_engines_reach_no_private_name_of_one_another(module):
    """engine, parallel.sharded and parallel.multihost call ``steps``
    for every kernel step: none uses a ``_``-prefixed name of another,
    nor a ``*_wide`` wrapper (the narrow/wide choice is ``steps``')."""
    assert _crossings(module, SEAM[module]) == []
