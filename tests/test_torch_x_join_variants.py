"""The Pallas kernels of ``scripts/x_join_variants.py`` against their
counterparts in the port, on the CPU, and the port's
``experiments.x_join_variants`` commands at a small size.

* 9a ``_tally_kernel_v3`` (via ``join_tally_step_v3``) and 9b
  ``_tally_kernel_v4`` (via ``join_tally_step_v4``, also fed by
  ``extract_mixed``) against K1 -> ``torch.sort`` -> K2 on the plain
  paths, through the tile permutation.
* 9c ``_tally_kernel_w`` (via ``join_tally_step_v5``) against the
  port's segment form, K1 -> K9d -> K3 on the slots.
* 9d ``extract_v2p``, 9e ``extract_v3`` and 9f the stage-5 kernel of
  ``_make_extract_stage`` against the mixed words (``mix_keys_np``) of
  the port's K1 keys, the sentinel pinned to the all-ones pair.  The
  stage cuts 0-4 are timing probes and are not compared.
* ``v5m``'s two member scans behind a dedup (K9 -> heads -> K4 -> spread
  and scatter; ``torch.unique`` -> K4 -> gather) against the JAX
  ``engine.scan_reads_for_hits`` (engine.py:1065), on a batch with
  duplicated reads, N bases and sentinel windows.

Pallas runs in interpret mode: a fixture forces ``interpret=True`` on
every ``pallas_call``, since several script wrappers take no such
argument.  Integer outputs, exact equality.
"""

import functools
import importlib.util
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kmer_denovo_filter_tpu import engine as jeng
from kmer_denovo_filter_tpu.ops import pallas_join as pj
from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch.experiments import _common as common
from kmer_denovo_filter_tpu_torch.experiments import (
    x_join_variants as port_xjv,
)
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.extract import (
    extract_canonical,
    extract_canonical_stage,
)
from kmer_denovo_filter_tpu_torch.ops.probe import probe_tally
from tests.test_torch_weighted_tally import _case, _from_tiles

_SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
SMALL = ["--device", "cpu", "--reps", "1"]
K = 31


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def xjv():
    return _load("x_join_variants")


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pallas_call`` in interpret mode (the scripts look the
    function up when they trace)."""
    real = pl.pallas_call

    def call(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", call)


def _tile_case():
    codes, lengths, win, words = _case(3, K)
    t0, t1, perm, p = pj.build_tile_partitions(words)
    jax_args = (jnp.asarray(t0), jnp.asarray(t1),
                jnp.zeros(t0.shape, jnp.int32), jnp.asarray(codes),
                jnp.asarray(lengths), K, p)
    return codes, lengths, win, words, perm, jax_args


def _sorted_query_tally(win, words):
    """K1 -> sort -> K2 on the plain paths."""
    table = keys64.words_to_keys64(words, K)
    acc = torch.zeros(table.shape[0], dtype=torch.int64)
    return probe_tally(torch.sort(win).values, table, acc).numpy()


def test_tally_v3_matches_sorted_query_k2(xjv, interpret):
    """9a."""
    _codes, _lengths, win, words, perm, args = _tile_case()
    ref, overflow = xjv.join_tally_step_v3(*args)
    assert not bool(overflow)
    got = _sorted_query_tally(win, words)
    assert (got > 1).any()
    assert np.array_equal(got, _from_tiles(ref, perm, words.shape[0]))


@pytest.mark.parametrize("fused_extract", [False, True])
def test_tally_v4_matches_sorted_query_k2(xjv, interpret, fused_extract):
    """9b, fed by the XLA extract or by ``extract_mixed``."""
    _codes, _lengths, win, words, perm, args = _tile_case()
    ref, overflow = xjv.join_tally_step_v4(*args,
                                           fused_extract=fused_extract)
    assert not bool(overflow)
    got = _sorted_query_tally(win, words)
    assert np.array_equal(got, _from_tiles(ref, perm, words.shape[0]))


def test_tally_v5_matches_segment_form(xjv, interpret):
    """9c: the weighted tally of the segment-deduped stream."""
    codes, lengths, _win, words, perm, args = _tile_case()
    ref, overflow = xjv.join_tally_step_v5(*args, u_chunk=pj.LCHUNK_DD)
    assert not bool(overflow)
    fc = port_xjv.SegmentDedupCounter(eng.KmerIndex(words, K, device="cpu"))
    fc.feed(codes, lengths)
    got = fc.result()
    assert (got > 1).any()
    assert np.array_equal(got, _from_tiles(ref, perm, words.shape[0]))


def _extract_case():
    """Reads with N bases and ragged lengths (the ``run_xextract3``
    recipe at a small size, with an all-N read)."""
    rng = np.random.default_rng(9)
    n, length = 96, 152
    codes = rng.integers(0, 4, (n, length), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[5] = 4
    lengths = np.full(n, length, np.int32)
    lengths[::7] = 100
    lengths[::11] = 63
    lengths[3] = 20
    return codes, lengths


def _port_mixed_planes(codes, lengths):
    """(B, S) mixed (hi, lo) words of the port's K1 keys."""
    keys = extract_canonical(torch.from_numpy(codes),
                             torch.from_numpy(lengths), K)
    words = keys64.keys64_to_words(keys.reshape(-1), K)
    hi, lo = pj.mix_keys_np(words[:, 0], words[:, 1])
    sent = keys.reshape(-1).numpy() == keys64.SENTINEL
    hi[sent] = lo[sent] = 0xFFFFFFFF
    assert sent.any() and not sent.all()
    return hi.reshape(keys.shape), lo.reshape(keys.shape)


def _assert_planes_equal(got_hi, got_lo, codes, lengths):
    """The first S columns equal the port's mixed keys; padding columns
    hold the sentinel pair."""
    hi, lo = _port_mixed_planes(codes, lengths)
    s = hi.shape[1]
    got_hi, got_lo = np.asarray(got_hi), np.asarray(got_lo)
    assert got_hi.shape[0] == hi.shape[0] and got_hi.shape[1] >= s
    assert np.array_equal(got_hi[:, :s], hi)
    assert np.array_equal(got_lo[:, :s], lo)
    assert (got_hi[:, s:] == 0xFFFFFFFF).all()
    assert (got_lo[:, s:] == 0xFFFFFFFF).all()


def test_extract_v2p_matches_k1(xjv, interpret):
    """9d: lanes padded to 256."""
    codes, lengths = _extract_case()
    hi, lo = xjv._make_extract_v2(256)(jnp.asarray(codes),
                                       jnp.asarray(lengths), K)
    _assert_planes_equal(hi, lo, codes, lengths)


def test_extract_v3_matches_k1(xjv, interpret):
    """9e: the swizzle reverse complement."""
    codes, lengths = _extract_case()
    hi, lo = xjv._make_extract_v3()(jnp.asarray(codes),
                                    jnp.asarray(lengths), K)
    _assert_planes_equal(hi, lo, codes, lengths)


def test_extract_stage5_kernel_matches_k1(xjv, interpret):
    """9f at stage 5 (the production chain): the kernel of the jitted
    ``run`` (which returns only ``[:1, :1]``), called with ``run``'s
    own specs."""
    run = xjv._make_extract_stage(5)
    kernel = inspect.getclosurevars(run.__wrapped__).nonlocals["kernel"]
    codes, lengths = _extract_case()
    b, length = codes.shape
    s_pad = -(-(length - K + 1) // 128) * 128
    block_reads = 256
    pad_b = (-b) % block_reads
    codes_p = jnp.pad(jnp.asarray(codes, jnp.int32), ((0, pad_b), (0, 15)),
                      constant_values=4)
    lens_p = jnp.pad(jnp.asarray(lengths), (0, pad_b))
    bp = b + pad_b
    hi, lo = pl.pallas_call(
        functools.partial(kernel, k=K, length=length, s_pad=s_pad),
        grid=(bp // block_reads,),
        in_specs=[
            pl.BlockSpec((block_reads, length + 15), lambda i: (i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((block_reads, 1), lambda i: (i, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=[
            pl.BlockSpec((block_reads, s_pad), lambda i: (i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((block_reads, s_pad), lambda i: (i, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_shape=[jax.ShapeDtypeStruct((bp, s_pad), jnp.uint32),
                   jax.ShapeDtypeStruct((bp, s_pad), jnp.uint32)],
    )(codes_p, lens_p.reshape(bp, 1))
    _assert_planes_equal(hi[:b], lo[:b], codes, lengths)
    head = run(jnp.asarray(codes), jnp.asarray(lengths), K)
    assert int(head[0][0, 0]) == int(hi[0, 0])


@pytest.mark.parametrize("stage", range(6))
def test_stage_probe_on_the_cpu_is_stage_5_only(stage):
    """On a CPU tensor the 9f probe runs stage 5 (= K1) and refuses the
    timing cuts 0-4, which exist in the CUDA kernel only."""
    codes, lengths = (torch.from_numpy(a) for a in _extract_case())
    if stage == 5:
        assert torch.equal(extract_canonical_stage(codes, lengths, K, 5),
                           extract_canonical(codes, lengths, K))
    else:
        with pytest.raises(ValueError, match="timing probe"):
            extract_canonical_stage(codes, lengths, K, stage)


@pytest.mark.parametrize("command", port_xjv.COMMANDS)
def test_port_command_runs_on_the_cpu(command, capsys, monkeypatch):
    monkeypatch.setattr(common, "BATCH_READS", 256)
    monkeypatch.setattr(common, "WGS_TABLE_M", 4096)
    port_xjv.main([command] + SMALL)
    out = capsys.readouterr().out
    assert "parity: True" in out and "parity: False" not in out
    assert "device: cpu" in out


def test_v5m_member_scans_match_jax_scan():
    """Both expansions give the JAX scan's window mask, exactly."""
    rng = np.random.default_rng(21)
    n, length = 300, 152
    codes = rng.integers(0, 4, (n, length), dtype=np.uint8)
    codes[100:200] = codes[:100]  # duplicated reads
    codes[rng.random(codes.shape) < 0.01] = 4
    lengths = np.full(n, length, np.int32)
    lengths[::7] = 100
    lengths[5] = 20  # shorter than k: every window a sentinel
    flat = extract_canonical(torch.from_numpy(codes),
                             torch.from_numpy(lengths), K).reshape(-1)
    assert flat.numel() % 8192 and (flat == keys64.SENTINEL).any()
    live = torch.unique(flat[flat != keys64.SENTINEL])
    rand = torch.from_numpy(np.random.default_rng(5).integers(
        0, 4 ** K, 2000, dtype=np.int64))
    table = torch.unique(torch.cat([live[::3], rand]))
    want = jeng.scan_reads_for_hits(
        jeng.KmerIndex(keys64.keys64_to_words(table, K), K), codes, lengths)
    assert want.any() and not want.all()
    for expand in (port_xjv.member_behind_seg_sort,
                   port_xjv.member_behind_unique):
        got = expand(flat, table).reshape(n, -1).numpy()
        assert np.array_equal(got, want), expand.__name__
