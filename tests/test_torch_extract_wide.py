"""Port wide window extraction (K1w's plain path) vs the JAX package's XLA
``extract_canonical_windows`` (its W >= 3 branch; the JAX wide path has
no Pallas extraction kernel).  Integer outputs, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu.ops import device as jdev
from kmer_denovo_filter_tpu.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical_wide


def _batch(seed, k, n=40, extra=40):
    """Ragged reads with N bases: row 0 empty, row 1 shorter than k,
    row 2 all N, row 3 full length; codes past a row's length left
    random."""
    rng = np.random.default_rng(seed)
    length = k + extra
    codes = rng.integers(0, 4, (n, length), dtype=np.uint8)
    codes[rng.random((n, length)) < 0.004] = 4
    lengths = rng.integers(k - 4, length + 1, n).astype(np.int32)
    lengths[:4] = [0, k - 1, length, length]
    codes[2] = 4
    codes[3] %= 4
    return codes, lengths


@pytest.mark.parametrize("k", [33, 63, 151, 201])
def test_matches_xla_extract(k):
    codes, lengths = _batch(k, k)
    jkeys, jvalid = jdev.extract_canonical_windows(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    b, s = codes.shape[0], codes.shape[1] - k + 1
    w, q = enc.words_per_kmer(k), keys64.limbs_per_kmer(k)
    expect = keys64.words_to_limbs(
        np.asarray(jkeys).reshape(-1, w), k).reshape(b, s, q)
    got = extract_canonical_wide(torch.from_numpy(codes),
                                 torch.from_numpy(lengths), k)
    assert got.shape == (b, s, q) and got.dtype == torch.int64
    assert torch.equal(got, expect)
    _keys, valid = tdev.extract_canonical_windows_wide(
        torch.from_numpy(codes), torch.from_numpy(lengths), k)
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid[3].any() and (~valid).any() and not valid[:3].any()
    # an invalid window is a whole row of sentinels, a valid one none
    assert ((got == keys64.SENTINEL).all(-1) == ~valid).all()
    assert not (got[valid] == keys64.SENTINEL).any()


def test_window_sparse_batch():
    """k = 151 on 152 bp reads: two windows a read."""
    k = 151
    codes, lengths = _batch(3, k, n=12, extra=1)
    lengths[4:] = k + 1
    got = extract_canonical_wide(torch.from_numpy(codes),
                                 torch.from_numpy(lengths), k)
    assert got.shape == (12, 2, 5)
    jkeys, _ = jdev.extract_canonical_windows(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    expect = keys64.words_to_limbs(np.asarray(jkeys).reshape(-1, 10), k)
    assert torch.equal(got.reshape(-1, 5), expect)


def test_wrapper_rejects_bad_inputs():
    codes = torch.zeros((4, 80), dtype=torch.uint8)
    lengths = torch.full((4,), 80, dtype=torch.int32)
    with pytest.raises(ValueError, match="extract_canonical"):
        extract_canonical_wide(codes, lengths, 31)  # K1w is k > 31
    with pytest.raises(ValueError, match="shorter"):
        extract_canonical_wide(codes[:, :40], lengths, 63)
    with pytest.raises(TypeError):
        extract_canonical_wide(codes, lengths.to(torch.int64), 63)
    # a non-CPU tensor never takes the plain path
    with pytest.raises(ValueError, match="unsupported device"):
        extract_canonical_wide(codes.to("meta"), lengths.to("meta"), 63)
