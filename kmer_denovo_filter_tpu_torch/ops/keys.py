"""int64 k-mer keys: the port's key representation and the state carried
over from the JAX package.

The JAX package packs a canonical k-mer into W uint32 words, big-endian
by base (:mod:`kmer_denovo_filter_tpu.ops.encode`).  CPU PyTorch has
no ``>>``, ``+`` or ``<`` on uint32, so the port carries a key as
Q = ceil(k / 31) int64 **limbs** of up to 31 bases each: limb j holds
bases 31j .. min(31j + 31, k) - 1 as a right-aligned 2-bit big-endian
value, below 2**62.  Every key of one k has the same limb boundaries,
so comparing limb rows lexicographically compares the base strings,
which is the JAX package's word-lexicographic order: counts aligned
with a ``KmerIndex``'s sorted keys mean the same thing in both
packages.  The invalid/padding sentinel is :data:`SENTINEL`
(``INT64_MAX``) in every limb: it lies outside the key space and sorts
after every real key, like the JAX all-ones word row.

For k <= 31 (W <= 2) the form is Q = 1, and the port keeps that one limb
as a flat (M,) int64 key (:func:`words_to_keys64`)::

    key = ((w0 << 32) | w1) >> (64 - 2k)        # < 2**62

Wider keys (k = 33..207, Q = 2..7) are (M, Q) row-major int64 tensors
(:func:`words_to_limbs`), so one search step reads one contiguous row.
k stops at 207 (W = 13), the limit of the JAX package's wide TPU
kernels (``pallas_join.MAX_W_WIDE``).

The Feistel route mix and lane-major tiles of the JAX small-table path
(``pallas_join._mix_keys``) and the route hash of its wide path
(``route_hash_np``) are TPU routing workarounds and have no counterpart
here.
"""

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch.ops import encode as enc

SENTINEL = torch.iinfo(torch.int64).max
MAX_W = 13  # the JAX wide kernels' limit (pallas_join.MAX_W_WIDE)
MAX_K = 207  # the largest odd k with words_per_kmer(k) <= MAX_W
NARROW_K = 31  # the largest k of one int64 limb
BASES_PER_LIMB = 31
SENTINEL32 = np.uint32(0xFFFFFFFF)  # the JAX all-ones word
_U64 = np.uint64


def check_k(k):
    """Raise ``ValueError`` unless *k* is an odd k-mer size in 1..207."""
    if k < 1 or k % 2 == 0:
        raise ValueError(f"k must be odd and positive, got {k}")
    if enc.words_per_kmer(k) > MAX_W:
        raise ValueError(
            f"k={k} needs W={enc.words_per_kmer(k)} key words; the port, "
            f"like the JAX package's wide TPU kernels, carries W <= "
            f"{MAX_W} (k <= {MAX_K})")


def limbs_per_kmer(k):
    """Q, the number of int64 limbs of a k-mer key: ceil(k / 31)."""
    return -(-k // BASES_PER_LIMB)


def limb_bases(k):
    """Bases in each limb: 31, ..., 31, then the rest (1..31)."""
    q = limbs_per_kmer(k)
    return [BASES_PER_LIMB] * (q - 1) + [k - BASES_PER_LIMB * (q - 1)]


def _check_words(keys_np, k):
    words = np.asarray(keys_np, dtype=np.uint32)
    w = enc.words_per_kmer(k)
    if words.ndim != 2 or words.shape[1] != w:
        raise ValueError(
            f"expected (M, {w}) key words for k={k}, got {words.shape}")
    return words


def _check_narrow(k):
    check_k(k)
    if k > NARROW_K:
        raise ValueError(f"k={k} keys are (M, Q) limb rows: use "
                         "words_to_limbs / limbs_to_words")


def words_to_keys64(keys_np, k):
    """(M, W) uint32 packed keys → (M,) int64 CPU tensor (k <= 31).

    All-ones rows (the JAX sentinel/padding) map to :data:`SENTINEL`.
    """
    _check_narrow(k)
    words = _check_words(keys_np, k)
    w = words.shape[1]
    packed = words[:, 0].astype(np.uint64) << np.uint64(32)
    if w == 2:
        packed |= words[:, 1].astype(np.uint64)
    out = (packed >> np.uint64(64 - 2 * k)).astype(np.int64)
    out[(words == SENTINEL32).all(axis=1)] = SENTINEL
    return torch.from_numpy(out)


def keys64_to_words(keys, k):
    """(M,) int64 keys (tensor or array) → (M, W) uint32 packed keys."""
    _check_narrow(k)
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    v = np.asarray(keys, dtype=np.int64)
    sent = v == SENTINEL
    left = v.astype(np.uint64) << np.uint64(64 - 2 * k)
    words = np.stack([(left >> np.uint64(32)).astype(np.uint32),
                      (left & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                     axis=1)[:, :enc.words_per_kmer(k)]
    words[sent] = SENTINEL32
    return np.ascontiguousarray(words)


def words_to_limbs(keys_np, k):
    """(M, W) uint32 packed keys → (M, Q) int64 CPU tensor of limbs.

    Limb j is the 2·n_j-bit field of the key's bit string that starts at
    bit 62j (n_j = 31, or the rest in the last limb): a 64-bit window
    over three words, shifted down.  Whole columns at a time, so no
    (M, k) base matrix is built.  All-ones rows map to a row of
    :data:`SENTINEL`.  Q = 1 (k <= 31) gives :func:`words_to_keys64`
    as one column.
    """
    check_k(k)
    words = _check_words(keys_np, k)
    m, w = words.shape
    cols = [words[:, i].astype(np.uint64) for i in range(w)]
    zero = np.zeros(m, dtype=np.uint64)
    cols += [zero, zero]
    out = np.empty((m, limbs_per_kmer(k)), dtype=np.int64)
    for j, nb in enumerate(limb_bases(k)):
        start = 2 * BASES_PER_LIMB * j
        i, off = divmod(start, 32)
        window = (cols[i] << _U64(32)) | cols[i + 1]
        if off:
            window = (window << _U64(off)) | (cols[i + 2] >> _U64(32 - off))
        out[:, j] = (window >> _U64(64 - 2 * nb)).astype(np.int64)
    out[(words == SENTINEL32).all(axis=1)] = SENTINEL
    return torch.from_numpy(out)


def limbs_to_words(limbs, k):
    """(M, Q) int64 limbs (tensor or array) → (M, W) uint32 packed keys.

    The inverse of :func:`words_to_limbs`: word i is the 32-bit field at
    bit 32i of the key's bit string, taken from a 64-bit window over
    the limb that holds that bit and the next one.  Rows of
    :data:`SENTINEL` map to all-ones words.
    """
    check_k(k)
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    v = np.asarray(limbs, dtype=np.int64)
    bases = limb_bases(k)
    if v.ndim != 2 or v.shape[1] != len(bases):
        raise ValueError(f"expected (M, {len(bases)}) limbs for k={k}, "
                         f"got {v.shape}")
    m = v.shape[0]
    # each limb left-aligned in 64 bits; a zero limb past the last
    left = [v[:, j].astype(np.uint64) << _U64(64 - 2 * nb)
            for j, nb in enumerate(bases)] + [np.zeros(m, dtype=np.uint64)]
    w = enc.words_per_kmer(k)
    words = np.empty((m, w), dtype=np.uint32)
    for i in range(w):
        j, off = divmod(32 * i, 2 * BASES_PER_LIMB)
        window = left[j] << _U64(off)
        window |= left[j + 1] >> _U64(2 * bases[j] - off)
        words[:, i] = (window >> _U64(32)).astype(np.uint32)
    words[(v == SENTINEL).all(axis=1)] = SENTINEL32
    return words


def acc_to_int64(acc_np, n):
    """A JAX ``FilteredCounter`` int32 accumulator (aligned with the
    sentinel-padded table) → the port's (n,) int64 accumulator aligned
    with the n sorted keys."""
    return torch.from_numpy(np.asarray(acc_np)[:n].astype(np.int64))
