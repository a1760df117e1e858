"""Kernel K4 wrapper: membership of window keys in a sorted table.

Counterpart of the Pallas member joins of
:mod:`kmer_denovo_filter_tpu.ops.pallas_join`: ``_join_kernel`` (:223,
one batch, via ``join_member_step`` :478 and ``join_member_step_dedup``
:1193) and ``_member_kernel_sb`` (:1277, a super-batch of NB batches in
one join, via ``join_member_superbatch_dedup`` :1386), and of the XLA
``ops/device.py:small_table_member`` (:313).  The engine's
``scan_reads_for_hits_many`` stacks a group into one call, the
counterpart of the super-batch join.  The CUDA kernel is
``csrc/probe_member.cu``; it searches through the table's prefix
directory (:mod:`.directory`), which a caller builds once per table and
passes in (``KmerIndex`` does); without one the wrapper builds it.

Kernel K8 (``probe_member_wide``, ``probe_rows_wide``) is the wide
counterpart: (N, Q) int64 limb rows (:mod:`.keys`) against a sorted
(M, Q) table, replacing ``pallas_join._member_kernel_wide`` (:1997, via
``join_member_step_wide`` :2216).  Its CUDA kernel is in
``csrc/probe_wide.cu``; it searches through the table's prefix
directory over limb 0, passed in or built as for K4.

CPU tensors take the plain PyTorch versions in :mod:`.device`
(``member``/``find_rows``, ``member_wide``/``find_rows_wide``).
"""

import torch

from kmer_denovo_filter_tpu_torch import tracing
from kmer_denovo_filter_tpu_torch.ops import _cuda
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops import directory as tdir
from kmer_denovo_filter_tpu_torch.ops.probe import (
    check_probe_args,
    check_wide_probe_args,
)


def probe_member(keys, table, directory=None, launch=None):
    """(N,) bool: ``keys[i]`` is in *table*; sentinel keys are never found.

    *keys*: (N,) int64.  *table*: (M,) int64 sorted ascending, unique
    apart from trailing sentinel rows.  *directory*: the table's
    :class:`~.directory.Directory`, or None.  *launch*: a
    :class:`~.directory.Launch` override of the kernel's launch plan,
    or None (the plan); the result does not depend on it.  A CUDA
    tensor launches the kernel (building the directory first when none
    is given); a CPU tensor runs the plain version, which needs no
    directory and takes no launch.
    """
    tdir.launch_args(launch)  # raises for a value the kernel does not take
    if check_probe_args(keys, table, []) == "cpu":
        return dev.member(table, keys)
    return _launch(keys, table, directory, torch.bool, launch)


def probe_rows(keys, table, directory=None):
    """(N,) int64: the row of ``keys[i]`` in *table*, or -1 where it is
    absent or a sentinel; arguments as for :func:`probe_member`.  The
    same kernel K4, writing rows instead of found bytes, in its plan."""
    if check_probe_args(keys, table, []) == "cpu":
        return dev.find_rows(table, keys)
    return _launch(keys, table, directory, torch.int64)


def _launch(keys, table, directory, dtype, launch=None):
    """K4 over checked CUDA tensors: found bytes (bool) or rows (int64),
    under the launch override *launch* (None: the plan)."""
    n, m = keys.shape[0], table.shape[0]
    if m == 0:
        return torch.full((n,), -1 if dtype == torch.int64 else 0,
                          dtype=dtype, device=keys.device)
    out = torch.empty(n, dtype=dtype, device=keys.device)
    if n == 0:
        return out
    d = tdir.directory_for(table, directory)
    found, rows = ((out.data_ptr(), None) if dtype == torch.bool
                   else (None, out.data_ptr()))
    with torch.cuda.device(keys.device):
        if launch is not None:  # raises for the staged form over its edge
            tdir.launch_plan(n, d.live, d.bits, False, launch)
        err = _cuda.lib().kdf_probe_member(
            keys.data_ptr(), n, table.data_ptr(), d.live,
            d.offsets.data_ptr(), d.bits, d.shift, found, rows,
            *tdir.launch_args(launch),
            _cuda.stream_of(keys))
    _cuda.check(err, "probe_member")
    tracing.count("launches.probe_member")
    return out


def probe_member_wide(keys, table, directory=None):
    """(N,) bool: row ``keys[i]`` is in *table*; sentinel rows are never
    found.

    *keys*: (N, Q) int64 limb rows.  *table*: (M, Q) int64 rows
    ascending, unique apart from trailing sentinel rows.  *directory*:
    the table's :class:`~.directory.Directory` (over limb 0), or None.
    A CUDA tensor launches kernel K8 (building the directory first when
    none is given); a CPU tensor runs the plain version, which needs no
    directory.
    """
    if check_wide_probe_args(keys, table, []) == "cpu":
        return dev.member_wide(table, keys)
    return _launch_wide(keys, table, directory, torch.bool)


def probe_rows_wide(keys, table, directory=None):
    """(N,) int64: the table row of ``keys[i]``, or -1 where it is absent
    or a sentinel; arguments as for :func:`probe_member_wide`.  The same
    kernel K8, writing rows instead of found bytes."""
    if check_wide_probe_args(keys, table, []) == "cpu":
        return dev.find_rows_wide(table, keys)
    return _launch_wide(keys, table, directory, torch.int64)


def _launch_wide(keys, table, directory, dtype):
    """K8 over checked CUDA tensors: found bytes (bool) or rows (int64)."""
    n, m = keys.shape[0], table.shape[0]
    if m == 0:
        return torch.full((n,), -1 if dtype == torch.int64 else 0,
                          dtype=dtype, device=keys.device)
    out = torch.empty(n, dtype=dtype, device=keys.device)
    if n == 0:
        return out
    d = tdir.directory_for(table, directory)
    found, rows = ((out.data_ptr(), None) if dtype == torch.bool
                   else (None, out.data_ptr()))
    with torch.cuda.device(keys.device):
        err = _cuda.lib().kdf_probe_member_wide(
            keys.data_ptr(), n, table.data_ptr(), d.offsets.data_ptr(),
            d.bits, d.shift, table.shape[1], found, rows,
            _cuda.stream_of(keys))
    _cuda.check(err, "probe_member_wide")
    tracing.count("launches.probe_member_wide")
    return out
