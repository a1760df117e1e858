"""The Pallas kernels of ``scripts/x_fused.py`` against their counterparts
in the port, on the CPU, and the port's ``experiments.x_fused`` commands
at a small size.

* 10a ``_sort_kernel`` (via ``seg_sort_pallas``) against K9's plain path
  (``segsort.seg_sort``) on the same two segments: sorted keys equal and
  each segment's (key, payload) pairs equal as multisets.
* 10b ``_tally_kernel_wT`` (via ``join_tally_step_dedup_T``) and 10c
  ``_tally_kernel_w2`` (patched into the v5 prototype's
  ``join_tally_step_v5``, whose four-part metadata it takes) against the
  port's segment-form tally, K1 -> K9d -> K3 on the slots (plain paths),
  through the tile permutation.
* ``super``'s stacked-group tally (one K1 -> K9d -> K3 pass over the
  group) against the JAX ``FilteredCounter`` (engine.py:473) fed the
  same batches one by one.

Pallas runs in interpret mode: a fixture forces ``interpret=True`` on
every ``pallas_call``, since the script wrappers take no such argument.
Integer outputs, exact equality.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kmer_denovo_filter_tpu import engine as jeng
from kmer_denovo_filter_tpu.ops import pallas_join as pj
from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch.experiments import _common as common
from kmer_denovo_filter_tpu_torch.experiments import x_fused as port_x_fused
from kmer_denovo_filter_tpu_torch.experiments.x_join_variants import (
    SegmentDedupCounter,
)
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops import segsort
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical
from tests.test_torch_weighted_tally import _case, _from_tiles

_SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
SMALL = ["--device", "cpu", "--reps", "1"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pallas_call`` in interpret mode (the scripts look the
    function up when they trace)."""
    real = pl.pallas_call

    def call(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", call)


def segment_tally(codes, lengths, words, k):
    """The port's segment-form tally on the CPU (plain paths)."""
    fc = SegmentDedupCounter(eng.KmerIndex(words, k, device="cpu"))
    fc.feed(codes, lengths)
    return fc.result()


def test_seg_sort_pallas_matches_k9_plain(interpret):
    """10a on two segments of mixed (hi, lo) words of the port's K1
    keys: hi is the key, lo the payload."""
    xf = _load("x_fused")
    _codes, _lengths, win, _words = _case(3, 31, n_reads=160, length=133)
    flat = win[:2 * segsort.SEGMENT]
    assert flat.numel() == 2 * segsort.SEGMENT
    words = keys64.keys64_to_words(flat, 31)
    hi, lo = pj.mix_keys_np(words[:, 0], words[:, 1])
    hp, lp = xf.seg_sort_pallas(jnp.asarray(hi.reshape(2, -1)),
                                jnp.asarray(lo.reshape(2, -1)))

    def unmap(a):  # lane-major order of the TPU kernel -> ascending
        return (np.asarray(a).reshape(-1, xf.ROWS, xf.LANES)
                .transpose(0, 2, 1).reshape(-1, xf.LC))

    keys, pay = segsort.seg_sort(torch.from_numpy(hi.astype(np.int64)),
                                 torch.from_numpy(lo.view(np.int32)))
    assert np.array_equal(unmap(hp).astype(np.int64), keys.numpy())
    got = np.sort(keys.numpy().astype(np.uint64) << np.uint64(32)
                  | pay.numpy().view(np.uint32), axis=1)
    want = np.sort(unmap(hp).astype(np.uint64) << np.uint64(32)
                   | unmap(lp), axis=1)
    assert np.array_equal(got, want)


def test_transposed_tally_matches_segment_form(interpret):
    """10b: the dedup step with pre-transposed queries."""
    xf = _load("x_fused")
    k = 31
    codes, lengths, _win, words = _case(3, k)
    t0, t1, perm, p = pj.build_tile_partitions(words)
    ref, ovf_s, ovf_u = xf.join_tally_step_dedup_T(
        jnp.asarray(t0), jnp.asarray(t1), jnp.zeros(t0.shape, jnp.int32),
        jnp.asarray(codes), jnp.asarray(lengths), k, p,
        u_chunk=pj.LCHUNK_DD)
    assert not bool(ovf_s) and not bool(ovf_u)
    got = segment_tally(codes, lengths, words, k)
    assert (got > 1).any()
    assert np.array_equal(got, _from_tiles(ref, perm, words.shape[0]))


def test_unroll2_tally_matches_segment_form(interpret, monkeypatch):
    """10c: ``_tally_kernel_w2`` in place of the v5 prototype's kernel."""
    xf = _load("x_fused")
    xjv = _load("x_join_variants")
    traced = []

    def unroll2(*args, **kwargs):
        traced.append(1)
        return xf._tally_kernel_w2(*args, **kwargs)

    monkeypatch.setattr(xjv, "_tally_kernel_w", unroll2)
    xjv.join_tally_step_v5.clear_cache()
    k = 31
    codes, lengths, _win, words = _case(3, k)
    t0, t1, perm, p = pj.build_tile_partitions(words)
    ref, overflow = xjv.join_tally_step_v5(
        jnp.asarray(t0), jnp.asarray(t1), jnp.zeros(t0.shape, jnp.int32),
        jnp.asarray(codes), jnp.asarray(lengths), k, p,
        u_chunk=pj.LCHUNK_DD)
    assert not bool(overflow) and traced
    got = segment_tally(codes, lengths, words, k)
    assert np.array_equal(got, _from_tiles(ref, perm, words.shape[0]))


@pytest.mark.parametrize("command", port_x_fused.COMMANDS)
def test_port_command_runs_on_the_cpu(command, capsys, monkeypatch):
    monkeypatch.setattr(common, "BATCH_READS", 256)
    monkeypatch.setattr(common, "WGS_TABLE_M", 4096)
    port_x_fused.main([command] + SMALL)
    out = capsys.readouterr().out
    assert "parity: True" in out and "parity: False" not in out
    assert "device: cpu" in out


def test_group_tally_matches_jax_filtered_counter():
    """One pass over a stacked group of three ragged batches with N
    bases counts what the JAX counter counts batch by batch, exactly."""
    k, nb, b, length = 31, 3, 120, 152
    rng = np.random.default_rng(31)
    codes = rng.integers(0, 4, (nb, b, length), dtype=np.uint8)
    codes[1, :40] = codes[0, :40]  # reads repeated across batches
    codes[rng.random(codes.shape) < 0.01] = 4
    lengths = np.full((nb, b), length, np.int32)
    lengths[:, ::5] = 90
    lengths[2, 3] = 10
    flat = extract_canonical(torch.from_numpy(codes.reshape(nb * b, -1)),
                             torch.from_numpy(lengths.reshape(-1)),
                             k).reshape(-1)
    live = torch.unique(flat[flat != keys64.SENTINEL])
    rand = torch.from_numpy(np.random.default_rng(6).integers(
        0, 4 ** k, 3000, dtype=np.int64))
    table = torch.unique(torch.cat([live[::3], rand]))
    jfc = jeng.FilteredCounter(jeng.KmerIndex(
        keys64.keys64_to_words(table, k), k))
    for i in range(nb):
        jfc.feed(codes[i], lengths[i])
    want = np.asarray(jfc.result()).astype(np.int64)
    acc = torch.zeros(table.shape[0], dtype=torch.int64)
    port_x_fused.group_tally(torch.from_numpy(codes),
                             torch.from_numpy(lengths), table, acc)
    assert (want > 1).any()
    assert np.array_equal(acc.numpy(), want)
