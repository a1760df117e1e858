"""Port wide probes (K7's and K8's plain paths) vs the JAX package's wide
tile joins in Pallas interpret mode, at W = 3 (k = 33) and W = 13
(k = 201): the unweighted ``join_tally_flat_wide`` and the weighted
``join_tally_flat_wide_dedup`` (kernel 7), mapped back to table order
through the tile permutation, and ``join_member_step_wide`` (kernel 8).
Every JAX overflow flag must be false, so the compared result is the
JAX contract.  Integer outputs, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu.ops import pallas_join as pj
from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical_wide
from kmer_denovo_filter_tpu_torch.ops.member import (
    probe_member_wide,
    probe_rows_wide,
)
from kmer_denovo_filter_tpu_torch.ops.probe import probe_tally_wide


class Case:
    """Reads with N bases and ragged lengths, 16 of them duplicated (so
    dedup weights exceed 1); a table of half the batch's distinct live
    keys plus random misses, as limb rows and as JAX tile planes."""

    def __init__(self, k, n_reads=48):
        rng = np.random.default_rng(k)
        length = k + 40
        codes = rng.integers(0, 4, (n_reads, length), dtype=np.uint8)
        codes[rng.random(codes.shape) < 0.01] = 4
        lengths = rng.integers(k - 4, length + 1, n_reads).astype(np.int32)
        self.k = k
        self.codes = np.concatenate([codes, codes[:16]])
        self.lengths = np.concatenate([lengths, lengths[:16]])
        self.win = extract_canonical_wide(torch.from_numpy(self.codes),
                                          torch.from_numpy(self.lengths), k)
        self.flat = self.win.flatten(0, 1)
        live = self.flat[self.flat[:, 0] != keys64.SENTINEL]
        q = live.shape[1]
        bases = keys64.limb_bases(k)
        rand = torch.stack([torch.from_numpy(
            rng.integers(0, 4 ** nb, 60, dtype=np.int64)) for nb in bases], 1)
        self.table = tdev.unique_rows(
            torch.cat([tdev.unique_rows(live)[0][::2], rand]))[0]
        assert self.table.shape[1] == q
        self.words = keys64.limbs_to_words(self.table, k)
        planes, self.perm, self.p = pj.build_tile_partitions_wide(self.words)
        self.planes = tuple(jnp.asarray(x) for x in planes)
        self.jflat = jnp.asarray(keys64.limbs_to_words(self.flat, k))
        self.w = self.words.shape[1]

    def from_tiles(self, acc):
        out = np.zeros(self.table.shape[0], dtype=np.int64)
        cells = np.asarray(acc)[:self.perm.shape[0]]
        ok = self.perm >= 0
        out[self.perm[ok]] = cells[ok]
        return out

    def acc0(self):
        return jnp.zeros(self.planes[0].shape, jnp.int32)


@pytest.fixture(scope="module", params=[33, 201], ids=["W3", "W13"])
def case(request):
    return Case(request.param)


def test_unweighted_tally_matches_kernel7_interpret(case):
    w_part = min(pj.W_PART_TALLY, pj.max_wide_w_part_tally(case.w))
    ref, ovf = pj.join_tally_flat_wide(
        case.planes, case.acc0(), case.jflat, case.p, w_part=w_part,
        interpret=True)
    assert not bool(ovf)
    acc = torch.zeros(case.table.shape[0], dtype=torch.int64)
    got = probe_tally_wide(case.flat, case.table, acc)
    assert got is acc
    assert (got > 1).any() and (got == 0).any()
    assert np.array_equal(got.numpy(), case.from_tiles(ref))


def test_weighted_tally_on_dedup_matches_kernel7_interpret(case):
    w_part = min(pj.W_PART_TALLY, pj.wide_dd_w_part_cap(case.w))
    ref, ovf_span, ovf_u = pj.join_tally_flat_wide_dedup(
        case.planes, case.acc0(), case.jflat, case.p, w_part=w_part,
        interpret=True)
    assert not bool(ovf_span) and not bool(ovf_u)
    keys, weights = tdev.dedup_windows_wide(case.flat)
    assert (weights > 1).any() and keys.shape[0] < case.flat.shape[0]
    acc = torch.full((case.table.shape[0],), 3, dtype=torch.int64)
    probe_tally_wide(keys, case.table, acc, weights)
    assert np.array_equal(acc.numpy() - 3, case.from_tiles(ref))
    plain = tdev.small_table_tally_wide(case.table, case.flat)
    assert torch.equal(acc - 3, plain)


def test_member_matches_kernel8_interpret(case):
    w_part = min(pj.W_PART, pj.max_wide_w_part_member(case.w))
    ref, ovf = pj.join_member_step_wide(
        case.planes, jnp.asarray(case.codes), jnp.asarray(case.lengths),
        case.k, case.p, w_part=w_part, interpret=True)
    assert not bool(ovf)
    got = probe_member_wide(case.flat, case.table).reshape(case.win.shape[:2])
    ref = np.asarray(ref)
    assert got.any() and not got.all()
    assert np.array_equal(got.numpy(), ref)
    rows = probe_rows_wide(case.flat, case.table)
    hit = rows >= 0
    assert torch.equal(hit.reshape(got.shape), got)
    assert torch.equal(case.table[rows[hit]], case.flat[hit])
