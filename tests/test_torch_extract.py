"""Port window extraction (K1's plain path) vs the JAX package: the XLA
``extract_canonical_windows`` and the Pallas ``extract_mixed`` kernel in
interpret mode.  Integer outputs, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu.ops import device as jdev
from kmer_denovo_filter_tpu.ops import encode as enc
from kmer_denovo_filter_tpu.ops import pallas_join as pj
from kmer_denovo_filter_tpu.ops.pallas_extract import extract_mixed
from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.extract import (
    extract_canonical,
    extract_canonical_wide,
)


def _batch(seed, k, n=48, length=72):
    """Random codes with N bases and ragged lengths, some rows shorter
    than k; codes past a row's length are left random."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, length), dtype=np.uint8)
    codes[rng.random((n, length)) < 0.02] = 4
    lengths = rng.integers(max(0, k - 4), length + 1, n).astype(np.int32)
    lengths[:3] = [0, k - 1, length]
    return codes, lengths


def _port(codes, lengths, k):
    return extract_canonical(torch.from_numpy(codes),
                             torch.from_numpy(lengths), k)


@pytest.mark.parametrize("k", [5, 15, 17, 31])
def test_matches_xla_extract(k):
    codes, lengths = _batch(k, k)
    jkeys, jvalid = jdev.extract_canonical_windows(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    w = enc.words_per_kmer(k)
    expect = keys64.words_to_keys64(
        np.asarray(jkeys).reshape(-1, w), k).reshape(codes.shape[0], -1)
    got = _port(codes, lengths, k)
    assert torch.equal(got, expect)
    _keys, valid = tdev.extract_canonical_windows(
        torch.from_numpy(codes), torch.from_numpy(lengths), k)
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.any() and (~valid).any()


@pytest.mark.parametrize("k", [17, 21, 31])
def test_matches_pallas_extract_interpret(k):
    codes, lengths = _batch(100 + k, k)
    b, length = codes.shape
    s = length - k + 1
    hi, lo = extract_mixed(jnp.asarray(codes), jnp.asarray(lengths), k,
                           block_reads=b, interpret=True)
    hi = np.asarray(hi)[:, :s].reshape(-1)
    lo = np.asarray(lo)[:, :s].reshape(-1)
    sent = (hi == pj.SENTINEL) & (lo == pj.SENTINEL)
    w0, w1 = pj._unmix_pair_np(hi, lo)
    words = np.stack([w0, w1], axis=1)
    words[sent] = pj.SENTINEL
    expect = keys64.words_to_keys64(words, k).reshape(b, s)
    assert torch.equal(_port(codes, lengths, k), expect)


def test_wrapper_rejects_bad_inputs():
    codes = torch.zeros((4, 40), dtype=torch.uint8)
    lengths = torch.full((4,), 40, dtype=torch.int32)
    with pytest.raises(TypeError):
        extract_canonical(codes.to(torch.int32), lengths, 31)
    with pytest.raises(ValueError):
        extract_canonical(codes[:, :20], lengths, 31)
    with pytest.raises(ValueError):
        extract_canonical(codes, lengths[:3], 31)
    with pytest.raises(ValueError, match="extract_canonical_wide"):
        extract_canonical(codes, lengths, 33)  # K1 is k <= 31
    wide = torch.zeros((4, 220), dtype=torch.uint8)
    with pytest.raises(ValueError, match="W <= 13"):
        extract_canonical_wide(wide, lengths, 209)
    # a non-CPU tensor never takes the plain path
    with pytest.raises(ValueError, match="unsupported device"):
        extract_canonical(codes.to("meta"), lengths.to("meta"), 31)
