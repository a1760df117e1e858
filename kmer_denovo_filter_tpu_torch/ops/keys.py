"""int64 k-mer keys: the port's key representation and the state carried
over from the JAX package.

The JAX package packs a canonical k-mer into W uint32 words, big-endian
by base (:mod:`kmer_denovo_filter_tpu.ops.encode`).  CPU PyTorch has
no ``>>``, ``+`` or ``<`` on uint32, so for W <= 2 (k <= 31) the port
carries each key as ONE int64, right-aligned::

    key = ((w0 << 32) | w1) >> (64 - 2k)        # < 2**62

The value is the 2-bit big-endian number of the k-mer, so its signed
order is the JAX package's word-lexicographic order, and counts aligned
with a ``KmerIndex``'s sorted keys mean the same thing in both
packages.  The invalid/padding sentinel is ``INT64_MAX``: it lies
outside the key space and sorts after every real key, like the JAX
all-ones word pair.  W == 1 (k <= 15) packs the same way with w1 = 0.

The Feistel route mix and lane-major tiles of the JAX small-table path
(``pallas_join._mix_keys``) are TPU routing workarounds and have no
counterpart here.
"""

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch.ops import encode as enc

SENTINEL = torch.iinfo(torch.int64).max
MAX_K = 31
_SENTINEL32 = np.uint32(0xFFFFFFFF)


def check_k(k):
    """Raise unless *k* is an odd k-mer size the port handles (<= 31)."""
    if k > MAX_K:
        raise NotImplementedError(
            f"k={k} needs W={enc.words_per_kmer(k)} key words; the port "
            "carries W <= 2 (k <= 31) only — wide keys are ROADMAP "
            "queue 1 item 8")
    if k < 1 or k % 2 == 0:
        raise ValueError(f"k must be odd and positive, got {k}")


def words_to_keys64(keys_np, k):
    """(M, W) uint32 packed keys → (M,) int64 CPU tensor.

    All-ones rows (the JAX sentinel/padding) map to :data:`SENTINEL`.
    """
    check_k(k)
    words = np.asarray(keys_np, dtype=np.uint32)
    w = enc.words_per_kmer(k)
    if words.ndim != 2 or words.shape[1] != w:
        raise ValueError(
            f"expected (M, {w}) key words for k={k}, got {words.shape}")
    packed = words[:, 0].astype(np.uint64) << np.uint64(32)
    if w == 2:
        packed |= words[:, 1].astype(np.uint64)
    out = (packed >> np.uint64(64 - 2 * k)).astype(np.int64)
    out[(words == _SENTINEL32).all(axis=1)] = SENTINEL
    return torch.from_numpy(out)


def keys64_to_words(keys, k):
    """(M,) int64 keys (tensor or array) → (M, W) uint32 packed keys."""
    check_k(k)
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    v = np.asarray(keys, dtype=np.int64)
    sent = v == SENTINEL
    left = v.astype(np.uint64) << np.uint64(64 - 2 * k)
    words = np.stack([(left >> np.uint64(32)).astype(np.uint32),
                      (left & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                     axis=1)[:, :enc.words_per_kmer(k)]
    words[sent] = _SENTINEL32
    return np.ascontiguousarray(words)


def acc_to_int64(acc_np, n):
    """A JAX ``FilteredCounter`` int32 accumulator (aligned with the
    sentinel-padded table) → the port's (n,) int64 accumulator aligned
    with the n sorted keys."""
    return torch.from_numpy(np.asarray(acc_np)[:n].astype(np.int64))
