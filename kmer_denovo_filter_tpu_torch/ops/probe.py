"""Kernel K2 wrapper: filtered tally of window keys against a table.

Counterpart of :func:`kmer_denovo_filter_tpu.ops.pallas_probe.pallas_small_tally`
(Pallas kernel ``_sweep_tally_kernel``, pallas_probe.py:99) and of the
XLA sweeps ``pallas_join.small_weighted_tally`` (:1016) and
``ops/device.py:small_table_tally`` (:281).  The CUDA kernel is
``csrc/probe_tally.cu``; CPU tensors take the plain PyTorch version
:func:`~kmer_denovo_filter_tpu_torch.ops.device.small_table_tally`.
"""

import torch

from kmer_denovo_filter_tpu_torch.ops import _cuda
from kmer_denovo_filter_tpu_torch.ops import device as dev

# CUDA kernel launches since import (or since a caller reset it to 0)
launches = 0


def probe_tally(keys, table, acc):
    """``acc[j] += #{i : keys[i] == table[j]}``, in place; returns *acc*.

    *keys*: (N,) int64, sentinel entries skipped.  *table*: (M,) int64
    sorted ascending, unique apart from trailing sentinel rows (which
    count 0).  *acc*: (M,) int64.  A CUDA tensor launches the kernel; a
    CPU tensor runs the plain version.
    """
    global launches
    if keys.dim() != 1 or table.dim() != 1 or acc.shape != table.shape:
        raise ValueError(f"expected keys (N,), table (M,), acc (M,), got "
                         f"{tuple(keys.shape)}, {tuple(table.shape)}, "
                         f"{tuple(acc.shape)}")
    if not all(t.dtype == torch.int64 for t in (keys, table, acc)):
        raise TypeError("keys, table and acc must be int64")
    if not keys.device == table.device == acc.device:
        raise ValueError("keys, table and acc on different devices")
    if keys.device.type == "cpu":
        acc += dev.small_table_tally(table, keys)
        return acc
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if not (keys.is_contiguous() and table.is_contiguous()
            and acc.is_contiguous()):
        raise ValueError("keys, table and acc must be contiguous")
    n, m = keys.shape[0], table.shape[0]
    if m >= 1 << 31:
        raise ValueError(f"table of {m} keys exceeds the kernel's int32 "
                         "row index")
    if n == 0 or m == 0:
        return acc
    with torch.cuda.device(keys.device):
        err = _cuda.lib().kdf_probe_tally(
            keys.data_ptr(), n, table.data_ptr(), m, acc.data_ptr(),
            _cuda.stream_of(keys))
    _cuda.check(err, "probe_tally")
    launches += 1
    return acc
