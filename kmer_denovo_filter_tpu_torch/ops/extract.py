"""Kernel K1 wrapper: canonical window extraction.

Counterpart of :func:`kmer_denovo_filter_tpu.ops.pallas_extract.extract_mixed`
(Pallas kernel ``_extract_mix_kernel``, pallas_extract.py:54) and of the
XLA ``ops/device.py:extract_canonical_windows``.  The CUDA kernel is
``csrc/extract_canonical.cu``; CPU tensors take the plain PyTorch
version :func:`~kmer_denovo_filter_tpu_torch.ops.device.extract_canonical_windows`.
"""

import torch

from kmer_denovo_filter_tpu_torch.ops import _cuda
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops.keys import check_k

# CUDA kernel launches since import (or since a caller reset it to 0)
launches = 0


def extract_canonical(codes, lengths, k):
    """(B, L) uint8 codes + (B,) int32 lengths → (B, L-k+1) int64 keys.

    Invalid windows (a code >= 4 inside, or past the read's length) hold
    :data:`~kmer_denovo_filter_tpu_torch.ops.keys.SENTINEL`.  A CUDA
    tensor launches the kernel; a CPU tensor runs the plain version.
    """
    global launches
    check_k(k)
    if codes.dim() != 2 or lengths.shape != codes.shape[:1]:
        raise ValueError(f"expected codes (B, L) and lengths (B,), got "
                         f"{tuple(codes.shape)} and {tuple(lengths.shape)}")
    if codes.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError(f"expected uint8 codes and int32 lengths, got "
                        f"{codes.dtype} and {lengths.dtype}")
    b, length = codes.shape
    if length < k:
        raise ValueError(f"reads shorter than k={k}")
    if codes.device != lengths.device:
        raise ValueError("codes and lengths on different devices")
    if codes.device.type == "cpu":
        return dev.extract_canonical_windows(codes, lengths, k)[0]
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if not (codes.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("codes and lengths must be contiguous")
    keys = torch.empty((b, length - k + 1), dtype=torch.int64,
                       device=codes.device)
    if b == 0:
        return keys
    with torch.cuda.device(codes.device):
        err = _cuda.lib().kdf_extract_canonical(
            codes.data_ptr(), lengths.data_ptr(), keys.data_ptr(), b,
            length, k, _cuda.stream_of(codes))
    _cuda.check(err, "extract_canonical")
    launches += 1
    return keys
