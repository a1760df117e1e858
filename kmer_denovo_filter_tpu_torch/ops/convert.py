"""Kernel K11 wrapper: a table's (M, W) uint32 key words to the port's
int64 keys, on the keys' device.

The JAX package sends its tables to the device as uint32 words; the
port carries a key as int64 limbs (:mod:`.keys`).  The engine's tables
(``steps.key_tensor``) send the words up as they are and convert them
on the card: :func:`words_to_keys` launches K11
(``csrc/words_to_keys.cu``) on a CUDA tensor and runs
:func:`plain_words_to_keys` on a CPU one.  The plain version is the
numpy conversion of :mod:`.keys` (``words_to_keys64``,
``words_to_limbs``) in int64 torch arithmetic: each limb gathered field
by field from the words it spans, where K11 funnels a 64-bit window as
the numpy code does.

A tensor holds the words as int32 (the uint32 bits; CPU PyTorch has no
uint32 arithmetic): :func:`words_tensor` makes one from host words.
"""

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch import tracing
from kmer_denovo_filter_tpu_torch.ops import _cuda
from kmer_denovo_filter_tpu_torch.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops.keys import (
    BASES_PER_LIMB,
    SENTINEL,
    check_k,
    limb_bases,
)


def words_tensor(keys_np):
    """Host (M, W) uint32 words as an (M, W) int32 CPU tensor of their
    bits (no copy when *keys_np* is a contiguous uint32 array)."""
    words = np.ascontiguousarray(keys_np, dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32))


def _check(words, k):
    check_k(k)
    w = enc.words_per_kmer(k)
    if words.dim() != 2 or words.shape[1] != w or words.dtype != torch.int32:
        raise ValueError(f"expected (M, {w}) int32 key words for k={k}, got "
                         f"{tuple(words.shape)} {words.dtype}")


def plain_words_to_keys(words, k):
    """The plain version of K11: (M, W) int32 words (the uint32 bits) ->
    (M,) int64 keys for k <= 31, else (M, Q) int64 limb rows; all-ones
    rows -> :data:`~.keys.SENTINEL`."""
    _check(words, k)
    cols = words.to(torch.int64) & 0xFFFFFFFF
    limbs = []
    for j, nb in enumerate(limb_bases(k)):
        start, end = 2 * BASES_PER_LIMB * j, 2 * BASES_PER_LIMB * j + 2 * nb
        limb = torch.zeros(words.shape[0], dtype=torch.int64,
                           device=words.device)
        for t in range(start // 32, (end - 1) // 32 + 1):
            lo, hi = max(start, 32 * t), min(end, 32 * t + 32)
            field = (cols[:, t] >> (32 * t + 32 - hi)) & ((1 << (hi - lo)) - 1)
            limb |= field << (end - hi)
        limbs.append(limb)
    out = torch.stack(limbs, dim=1)
    out[(words == -1).all(dim=1)] = SENTINEL
    return out[:, 0] if out.shape[1] == 1 else out


def words_to_keys(words, k):
    """(M, W) int32 key words (the uint32 bits) -> (M,) int64 keys for
    k <= 31, else (M, Q) int64 limb rows, on the words' device; all-ones
    rows become :data:`~.keys.SENTINEL` rows.  A CUDA tensor launches
    K11 (none for M = 0), a CPU tensor runs
    :func:`plain_words_to_keys`."""
    if words.device.type == "cpu":
        return plain_words_to_keys(words, k)
    _check(words, k)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    words = words.contiguous()
    m, w = words.shape
    q = len(limb_bases(k))
    out = torch.empty((m, q), dtype=torch.int64, device=words.device)
    if m:
        with torch.cuda.device(words.device):
            err = _cuda.lib().kdf_words_to_keys(
                words.data_ptr(), m, w, k, q, out.data_ptr(),
                _cuda.stream_of(words))
        _cuda.check(err, "words_to_keys")
        tracing.count("launches.words_to_keys")
    return out[:, 0] if q == 1 else out
