"""Port wide keys (kmer_denovo_filter_tpu_torch.ops.keys limb rows) vs the
JAX package's packed uint32 words: exact round trip, order, the Q = 1
case and the sentinel, at k = 33..207."""

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu import kmer as K
from kmer_denovo_filter_tpu.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops import keys as keys64

SENT = np.uint32(0xFFFFFFFF)


def _canonical_words(seed, k, n=200):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    raw = bases[rng.integers(0, 4, (n, k))]
    kmers = sorted({K.canonicalize(row.tobytes().decode()) for row in raw})
    return enc.kmers_to_keys(kmers, k), kmers


@pytest.mark.parametrize("k", [33, 63, 127, 151, 201, 207])
def test_round_trip(k):
    words, kmers = _canonical_words(k, k)
    words = np.concatenate([words, np.full((3, words.shape[1]), SENT)])
    limbs = keys64.words_to_limbs(words, k)
    q = keys64.limbs_per_kmer(k)
    assert limbs.dtype == torch.int64 and limbs.shape == (len(words), q)
    assert q == -(-k // 31) and 2 <= q <= 7
    assert (limbs[-3:] == keys64.SENTINEL).all()
    live = limbs[:-3]
    assert (live >= 0).all() and (live < 4 ** 31).all()
    # limb j is the 2-bit number of bases 31j .. 31j + 30 (or the rest)
    for row, kmer in zip(live[:5].tolist(), kmers[:5]):
        digits = "".join("0123"["ACGT".index(c)] for c in kmer)
        assert row == [int(digits[i:i + 31], 4) for i in range(0, k, 31)]
    assert np.array_equal(keys64.limbs_to_words(limbs, k), words)
    assert np.array_equal(keys64.limbs_to_words(limbs.numpy(), k), words)


@pytest.mark.parametrize("k", [33, 63, 151, 201])
def test_order_matches_lexsort(k):
    """Row-lexicographic order of the limbs is the JAX word order, with
    duplicates and sentinel rows among random keys."""
    rng = np.random.default_rng(200 + k)
    words, _ = _canonical_words(k + 1, k)
    # keys that share long prefixes, so later limbs decide the order
    near = words[:30].copy()
    near[:, -1] ^= np.uint32(1 << 31) >> np.uint32(2 * ((k - 1) % 16))
    words = np.concatenate([words, near, words[:20],
                            np.full((5, words.shape[1]), SENT)])
    words = words[rng.permutation(words.shape[0])]
    limbs = keys64.words_to_limbs(words, k).numpy()
    order = np.lexsort(limbs[:, ::-1].T)
    expect = enc.lexsort_keys(words)
    assert np.array_equal(words[order], words[expect])
    assert np.array_equal(order, expect)


@pytest.mark.parametrize("k", [3, 15, 17, 31])
def test_one_limb_is_the_int64_key(k):
    words, _ = _canonical_words(k + 2, k)
    words = np.concatenate([words, np.full((2, words.shape[1]), SENT)])
    limbs = keys64.words_to_limbs(words, k)
    assert limbs.shape == (words.shape[0], 1)
    assert torch.equal(limbs[:, 0], keys64.words_to_keys64(words, k))
    assert np.array_equal(keys64.limbs_to_words(limbs, k), words)


def test_sentinel_both_ways():
    k = 63
    words = np.full((4, enc.words_per_kmer(k)), SENT)
    words[1] = enc.kmers_to_keys(["A" * k], k)[0]
    limbs = keys64.words_to_limbs(words, k)
    assert limbs[1].tolist() == [0, 0, 0]
    assert (limbs[[0, 2, 3]] == keys64.SENTINEL).all()
    back = np.full((2, 3), keys64.SENTINEL, np.int64)
    back[1] = 0
    assert (keys64.limbs_to_words(back, k)[0] == SENT).all()
    assert not keys64.limbs_to_words(back, k)[1].any()


def test_limits_and_shapes():
    keys64.check_k(207)
    for k in (209, 255):
        with pytest.raises(ValueError, match="W <= 13"):
            keys64.check_k(k)
    with pytest.raises(ValueError, match="W <= 13"):
        keys64.limbs_to_words(np.zeros((1, 7), np.int64), 209)
    with pytest.raises(ValueError, match="odd"):
        keys64.check_k(64)
    with pytest.raises(ValueError, match=r"\(M, 4\)"):
        keys64.words_to_limbs(np.zeros((2, 3), np.uint32), 63)
    with pytest.raises(ValueError, match=r"\(M, 3\)"):
        keys64.limbs_to_words(np.zeros((2, 2), np.int64), 63)
    empty = keys64.words_to_limbs(np.zeros((0, 13), np.uint32), 201)
    assert empty.shape == (0, 7)
    assert keys64.limbs_to_words(empty, 201).shape == (0, 13)
