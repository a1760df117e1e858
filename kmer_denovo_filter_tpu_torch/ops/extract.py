"""Kernel K1 and K1w wrappers: canonical window extraction.

K1 (``extract_canonical``, k <= 31) is the counterpart of
:func:`kmer_denovo_filter_tpu.ops.pallas_extract.extract_mixed` (Pallas
kernel ``_extract_mix_kernel``, pallas_extract.py:54) and of the XLA
``ops/device.py:extract_canonical_windows``.  Its CUDA kernel is
``csrc/extract_canonical.cu``.

K1w (``extract_canonical_wide``, k = 33..207) is the counterpart of the
XLA ``extract_canonical_windows`` for W >= 3 words (the JAX
``pallas_join.extract_flat_keys``, :2195, which has no Pallas kernel):
keys as (Q,) int64 limb rows (:mod:`.keys`).  Its CUDA kernel is
``csrc/extract_wide.cu``.

``extract_canonical_stage`` runs K1 cut at a compile-time stage, the
timing probe of ``scripts/x_join_variants.py xmicro``.

CPU tensors take the plain PyTorch versions in :mod:`.device`.
"""

import torch

from kmer_denovo_filter_tpu_torch import tracing
from kmer_denovo_filter_tpu_torch.ops import _cuda
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops.keys import (
    NARROW_K,
    check_k,
    limbs_per_kmer,
)


def _check_batch(codes, lengths, k):
    """Checks shared by both wrappers; returns the device type."""
    check_k(k)
    if codes.dim() != 2 or lengths.shape != codes.shape[:1]:
        raise ValueError(f"expected codes (B, L) and lengths (B,), got "
                         f"{tuple(codes.shape)} and {tuple(lengths.shape)}")
    if codes.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError(f"expected uint8 codes and int32 lengths, got "
                        f"{codes.dtype} and {lengths.dtype}")
    if codes.shape[1] < k:
        raise ValueError(f"reads shorter than k={k}")
    if codes.device != lengths.device:
        raise ValueError("codes and lengths on different devices")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")
    if codes.device.type == "cuda" and not (codes.is_contiguous()
                                            and lengths.is_contiguous()):
        raise ValueError("codes and lengths must be contiguous")
    return codes.device.type


def extract_canonical(codes, lengths, k):
    """(B, L) uint8 codes + (B,) int32 lengths → (B, L-k+1) int64 keys,
    for k <= 31.

    Invalid windows (a code >= 4 inside, or past the read's length) hold
    :data:`~kmer_denovo_filter_tpu_torch.ops.keys.SENTINEL`.  A CUDA
    tensor launches the kernel; a CPU tensor runs the plain version.
    """
    if k > NARROW_K:
        raise ValueError(f"K1 takes k <= {NARROW_K}, got k={k}: wide keys "
                         "go through extract_canonical_wide")
    if _check_batch(codes, lengths, k) == "cpu":
        return dev.extract_canonical_windows(codes, lengths, k)[0]
    return _launch_k1(codes, lengths, k, 5, probe=False)


def extract_canonical_stage(codes, lengths, k, stage):
    """K1 cut at *stage* (0 load and pack, 1 forward extract, 2 reverse
    complement, 3 canonical minimum, 4 N-in-window mask, 5 the full K1):
    a timing probe, the counterpart of the stage kernels of
    ``scripts/x_join_variants.py:_make_extract_stage`` (:1449).  Stage 5
    equals :func:`extract_canonical`; only it is compared with anything,
    so stages 0-4 have no plain version.  A CUDA tensor launches the
    kernel's *stage* instantiation; a CPU tensor runs the plain version
    of stage 5 and refuses the others."""
    if k > NARROW_K or stage not in range(6):
        raise ValueError(f"stage probes take k <= {NARROW_K} and a stage "
                         f"in 0..5, got k={k}, stage={stage}")
    if _check_batch(codes, lengths, k) == "cpu":
        if stage != 5:
            raise ValueError(f"stage {stage} is a timing probe of the CUDA "
                             "kernel: on the CPU only stage 5 runs")
        return dev.extract_canonical_windows(codes, lengths, k)[0]
    return _launch_k1(codes, lengths, k, stage, probe=True)


def _launch_k1(codes, lengths, k, stage, probe):
    """(B, L - k + 1) int64 output of K1 cut at *stage* over a checked
    CUDA batch (no launch for B = 0).  A launch adds one to
    ``launches.extract_canonical_stage`` (:mod:`..tracing`) if it is a
    *probe*, else to ``launches.extract_canonical``."""
    b, length = codes.shape
    keys = torch.empty((b, length - k + 1), dtype=torch.int64,
                       device=codes.device)
    if b == 0:
        return keys
    with torch.cuda.device(codes.device):
        err = _cuda.lib().kdf_extract_canonical(
            codes.data_ptr(), lengths.data_ptr(), keys.data_ptr(), b,
            length, k, stage, _cuda.stream_of(codes))
    _cuda.check(err, "extract_canonical")
    if probe:
        tracing.count("launches.extract_canonical_stage")
    else:
        tracing.count("launches.extract_canonical")
    return keys


def extract_canonical_wide(codes, lengths, k):
    """(B, L) uint8 codes + (B,) int32 lengths → (B, L-k+1, Q) int64
    limb rows, Q = ceil(k / 31), for k = 33..207.

    Invalid windows hold a row of
    :data:`~kmer_denovo_filter_tpu_torch.ops.keys.SENTINEL`.  A CUDA
    tensor launches kernel K1w; a CPU tensor runs the plain version.
    """
    if k <= NARROW_K:
        raise ValueError(f"K1w takes k > {NARROW_K}, got k={k}: narrow "
                         "keys go through extract_canonical")
    if _check_batch(codes, lengths, k) == "cpu":
        return dev.extract_canonical_windows_wide(codes, lengths, k)[0]
    b, length = codes.shape
    keys = torch.empty((b, length - k + 1, limbs_per_kmer(k)),
                       dtype=torch.int64, device=codes.device)
    if b == 0:
        return keys
    with torch.cuda.device(codes.device):
        err = _cuda.lib().kdf_extract_canonical_wide(
            codes.data_ptr(), lengths.data_ptr(), keys.data_ptr(), b,
            length, k, _cuda.stream_of(codes))
    _cuda.check(err, "extract_canonical_wide")
    tracing.count("launches.extract_canonical_wide")
    return keys
