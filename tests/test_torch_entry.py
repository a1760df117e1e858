"""The port's entry points (``kmer_denovo_filter_tpu_torch/entry.py``)
against ``__graft_entry__.py``, on the CPU.

* ``entry(device="cpu")``'s step against the JAX step, jitted on the JAX
  CPU backend, on the same example arguments and on a table holding a
  third of the batch's window keys: the accumulators equal as int64 and
  the valid-window counts equal.  Exact.
* ``dryrun_multichip`` on the CPU meshes ``[cpu] * 2`` and ``[cpu] * 4``,
  and its refusal to make a mesh on a host with no card.

The root module is loaded by path.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch import entry as tentry
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def graft():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _third_of_the_windows(codes, lengths):
    """Sorted int64 keys: every third distinct live window key of the
    batch."""
    keys = extract_canonical(codes, lengths, tentry.K).reshape(-1)
    return torch.unique(keys[keys != keys64.SENTINEL])[::3].contiguous()


@pytest.mark.parametrize("table", ["example", "a third of the windows"])
def test_step_equals_the_jax_step(graft, table):
    jstep, (jtable, jacc, jcodes, jlengths) = graft.entry()
    step, (ttable, tacc, codes, lengths) = tentry.entry(device="cpu")
    assert torch.equal(ttable, keys64.words_to_keys64(np.asarray(jtable),
                                                      tentry.K))
    assert np.array_equal(np.asarray(jcodes), codes.numpy())
    assert np.array_equal(np.asarray(jlengths), lengths.numpy())
    if table != "example":
        ttable = _third_of_the_windows(codes, lengths)
        jtable = jnp.asarray(keys64.keys64_to_words(ttable, tentry.K))
        jacc = jnp.zeros(ttable.shape[0], jnp.int32)
        tacc = torch.zeros(ttable.shape[0], dtype=torch.int64)
    want_acc, want_n = jax.jit(jstep)(jtable, jacc, jcodes, jlengths)
    got_acc, got_n = step(ttable, tacc, codes, lengths)
    assert got_acc is tacc and got_acc.dtype == torch.int64
    assert np.array_equal(got_acc.numpy(),
                          np.asarray(want_acc).astype(np.int64))
    assert int(got_n) == int(want_n) > 0
    if table != "example":
        assert int(got_acc.sum()) >= ttable.shape[0]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_a_cpu_mesh(n):
    tentry.dryrun_multichip(n, mesh=[CPU] * n)


def test_dryrun_multichip_without_a_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(2)


def test_dryrun_multichip_refuses_a_short_mesh():
    with pytest.raises(ValueError, match="need 4 devices"):
        tentry.dryrun_multichip(4, mesh=[CPU] * 2)
