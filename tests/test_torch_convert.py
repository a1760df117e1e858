"""Kernel K11 (``ops/convert.py``, ``csrc/words_to_keys.cu``): a table's
uint32 key words to the port's int64 keys, on the CPU.

K11's plain version (torch int64 arithmetic, each limb gathered field
by field) equals the numpy conversion of ``ops/keys.py``
(``words_to_keys64``, ``words_to_limbs``) for every odd k 3..207, with
sentinel rows and with no row; ``steps.key_tensor`` keeps the
numpy conversion on the CPU, and a table's live rows and last live key
come from its host words.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch import steps
from kmer_denovo_filter_tpu_torch import tracing
from kmer_denovo_filter_tpu_torch.ops import convert
from kmer_denovo_filter_tpu_torch.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops import keys as keys64

ODD_KS = list(range(3, keys64.MAX_K + 1, 2))


def random_words(n, k, seed):
    """(n, W) uint32 words of random k-mers (the trailing bits past 2k
    zero, as packed keys have them), every 5th row the JAX sentinel."""
    rng = np.random.default_rng(seed)
    w = enc.words_per_kmer(k)
    words = rng.integers(0, 1 << 32, (n, w), dtype=np.uint64).astype(
        np.uint32)
    spare = 32 * w - 2 * k
    words[:, -1] &= np.uint32((0xFFFFFFFF << spare) & 0xFFFFFFFF)
    words[::5] = keys64.SENTINEL32
    return words


def numpy_keys(words, k):
    if k <= keys64.NARROW_K:
        return keys64.words_to_keys64(words, k)
    return keys64.words_to_limbs(words, k)


@pytest.mark.parametrize("k", ODD_KS)
def test_plain_version_equals_the_numpy_conversion(k):
    words = random_words(1001, k, seed=k)
    words[3] = 0  # the all-A key
    got = convert.plain_words_to_keys(convert.words_tensor(words), k)
    want = numpy_keys(words, k)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)
    assert (got.reshape(got.shape[0], -1)[::5] == keys64.SENTINEL).all()
    empty = convert.plain_words_to_keys(convert.words_tensor(words[:0]), k)
    assert empty.shape == want[:0].shape and empty.dtype == torch.int64


@pytest.mark.parametrize("k", [15, 31, 63, 207])
def test_cpu_tensor_takes_the_plain_version(k):
    """On the CPU the wrapper runs the plain version and launches
    nothing; a view of the words at any word offset gives its rows'
    keys."""
    words = random_words(64, k, seed=k + 1)
    wide = np.zeros((65, words.shape[1] + 1), np.uint32)
    wide[1:, 1:] = words
    before = tracing.counter("launches.words_to_keys")
    got = convert.words_to_keys(convert.words_tensor(wide)[1:, 1:], k)
    assert tracing.counter("launches.words_to_keys") == before
    assert torch.equal(got, numpy_keys(words, k))


def test_words_tensor_holds_the_bits():
    words = np.array([[0xFFFFFFFF, 0x80000000], [1, 0]], np.uint32)
    t = convert.words_tensor(words)
    assert t.dtype == torch.int32
    assert t.tolist() == [[-1, -(1 << 31)], [1, 0]]
    assert np.array_equal(t.numpy().view(np.uint32), words)


def test_wrong_words_are_refused():
    with pytest.raises(ValueError, match="int32 key words"):
        convert.words_to_keys(torch.zeros((4, 3), dtype=torch.int32), 31)
    with pytest.raises(ValueError, match="int32 key words"):
        convert.words_to_keys(torch.zeros((4, 2), dtype=torch.int64), 31)
    with pytest.raises(ValueError, match="odd"):
        convert.words_to_keys(torch.zeros((4, 2), dtype=torch.int32), 32)


@pytest.mark.parametrize("k", ODD_KS)
def test_k11_windows_stay_in_the_row(k):
    """K11 funnels words i, i + 1 and i + 2 (i = 62 j / 32) of a row for
    limb j, from registers of W + 2 words: i < W for every limb, so the
    unrolled loop never reads past them."""
    w = enc.words_per_kmer(k)
    for j in range(keys64.limbs_per_kmer(k)):
        assert 62 * j // 32 < w


@pytest.mark.parametrize("k", [21, 63])
def test_key_tensor_on_the_cpu_is_the_numpy_conversion(k):
    words = random_words(100, k, seed=3)
    for got in (steps.key_tensor(words, k),
                steps.key_tensor(words, k, torch.device("cpu"))):
        assert torch.equal(got, numpy_keys(words, k))


@pytest.mark.parametrize("k", [31, 63])
def test_live_rows_come_from_the_host_words(k):
    """A sorted table's live rows stop at its trailing sentinel rows;
    the last live key is limb 0 of the last live row."""
    words = random_words(50, k, seed=4)
    words = words[~(words == keys64.SENTINEL32).all(axis=1)]
    words = words[enc.lexsort_keys(words)]
    padded = np.concatenate(
        [words, np.full((3, words.shape[1]), keys64.SENTINEL32)])
    first = numpy_keys(words, k).reshape(words.shape[0], -1)[:, 0]
    assert steps.live_rows(padded, k) == (words.shape[0], int(first[-1]))
    assert steps.live_rows(words, k) == (words.shape[0], int(first[-1]))
    assert steps.live_rows(padded[-3:], k) == (0, 0)
    assert steps.live_rows(words[:0], k) == (0, 0)
