"""Port int64 keys (kmer_denovo_filter_tpu_torch.ops.keys) vs the JAX
package's packed uint32 words: exact round trip and order."""

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu import kmer as K
from kmer_denovo_filter_tpu.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops import keys as keys64


def _canonical_kmers(seed, k, n=300):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    raw = bases[rng.integers(0, 4, (n, k))]
    return sorted({K.canonicalize(row.tobytes().decode()) for row in raw})


@pytest.mark.parametrize("k", [3, 5, 15, 17, 21, 31])
def test_round_trip(k):
    words = enc.kmers_to_keys(_canonical_kmers(k, k), k)
    words = np.concatenate(
        [words, np.full((3, words.shape[1]), 0xFFFFFFFF, np.uint32)])
    k64 = keys64.words_to_keys64(words, k)
    assert k64.dtype == torch.int64
    assert (k64[-3:] == keys64.SENTINEL).all()
    live = k64[:-3]
    assert (live >= 0).all() and (live < 4 ** k).all()
    assert np.array_equal(keys64.keys64_to_words(k64, k), words)


@pytest.mark.parametrize("k", [5, 15, 17, 31])
def test_order_matches_lexsort(k):
    rng = np.random.default_rng(100 + k)
    words = enc.kmers_to_keys(_canonical_kmers(k + 1, k), k)
    # duplicates and sentinel rows, shuffled
    words = np.concatenate([words, words[:20],
                            np.full((5, words.shape[1]), 0xFFFFFFFF,
                                    np.uint32)])
    words = words[rng.permutation(words.shape[0])]
    k64 = keys64.words_to_keys64(words, k).numpy()
    assert np.array_equal(np.argsort(k64, kind="stable"),
                          enc.lexsort_keys(words))


def test_value_is_the_two_bit_kmer_number():
    k = 21
    kmer = K.canonicalize("ACGTTGCAACGTAGCTAGCTA")
    expect = int("".join("0123"["ACGT".index(c)] for c in kmer), 4)
    got = keys64.words_to_keys64(enc.kmers_to_keys([kmer], k), k)
    assert int(got[0]) == expect


def test_acc_to_int64_drops_padding():
    acc = np.array([3, 0, 7, 0, 0, 0, 0, 0], np.int32)
    got = keys64.acc_to_int64(acc, 3)
    assert got.dtype == torch.int64
    assert got.tolist() == [3, 0, 7]


@pytest.mark.parametrize("k", [33, 63])
def test_wide_k_not_ported(k):
    """The one-int64 form stays k <= 31: wide keys are limb rows, and
    k = 209 (W = 14) is past the JAX wide kernels' limit."""
    words = np.zeros((1, enc.words_per_kmer(k)), np.uint32)
    with pytest.raises(ValueError, match="words_to_limbs"):
        keys64.words_to_keys64(words, k)
    assert keys64.words_to_limbs(words, k).shape == (1, (k + 30) // 31)
    with pytest.raises(ValueError, match="W <= 13"):
        keys64.words_to_limbs(np.zeros((1, 14), np.uint32), 209)


def test_even_k_rejected():
    with pytest.raises(ValueError):
        keys64.check_k(30)
