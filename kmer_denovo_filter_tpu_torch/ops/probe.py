"""Kernel K2 and K3 wrappers: filtered tallies of window keys against a
sorted table.

K2 (``probe_tally``) is the counterpart of
:func:`kmer_denovo_filter_tpu.ops.pallas_probe.pallas_small_tally`
(Pallas kernel ``_sweep_tally_kernel``, pallas_probe.py:99), of the XLA
sweeps ``pallas_join.small_weighted_tally`` (:1016) and
``ops/device.py:small_table_tally`` (:281), and of the unweighted tile
join ``pallas_join._tally_kernel`` (:273, via ``join_tally_step`` :394):
on its global-memory branch it computes what that kernel computes.

K3 (``probe_tally_weighted``) is the counterpart of the weighted tile
join ``pallas_join._tally_kernel_w`` (:679, via ``join_tally_step_dedup``
:808 and ``join_tally_superbatch_dedup`` :915): the tally of a batch's
deduplicated (key, weight) stream, flat or as kernel K9d's per-segment
slots (``segsort.seg_dedup``) read in place.

Both kernels are in ``csrc/probe_tally.cu``.  Both search through the
table's prefix directory (:mod:`.directory`), which a caller builds once
per table and passes in (``KmerIndex`` does); without one the wrapper
builds it.

K7 (``probe_tally_wide``) is the counterpart of the wide tile join
``pallas_join._tally_kernel_wide`` (:1905) in both its forms: unweighted
via ``join_tally_flat_wide`` (:2180) and weighted via
``join_tally_flat_wide_dedup`` (:1564), flat or on kernel K9dw's
per-segment slots (``segsort.seg_dedup_wide``) read in place.  Keys are
(N, Q) int64 limb rows (:mod:`.keys`); its CUDA kernel is in
``csrc/probe_wide.cu`` and searches through the table's prefix directory
over limb 0, passed in or built as for K2.

CPU tensors take the plain PyTorch versions in :mod:`.device`.
"""

import torch

from kmer_denovo_filter_tpu_torch import tracing
from kmer_denovo_filter_tpu_torch.ops import _cuda
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops import directory as tdir
from kmer_denovo_filter_tpu_torch.ops.keys import MAX_K, limbs_per_kmer
from kmer_denovo_filter_tpu_torch.ops.segsort import SEGMENT


def check_probe_args(keys, table, others):
    """Checks shared by the probe wrappers: (N,) int64 *keys*, (M,)
    int64 *table* with M < 2**31 (the kernels' row index is int32), and
    *others* ((name, tensor, shape) triples) on one device.  Returns
    the device type."""
    if keys.dim() != 1 or table.dim() != 1:
        raise ValueError(f"expected keys (N,) and table (M,), got "
                         f"{tuple(keys.shape)} and {tuple(table.shape)}")
    return _check_tensors(keys, table, others)


def _check_tensors(keys, table, others):
    """Shapes of *others*, dtypes, one device, contiguity and the table's
    row count; returns the device type."""
    tensors = [keys, table] + [t for _n, t, _s in others]
    for name, t, shape in others:
        if t.shape != shape:
            raise ValueError(f"expected {name} of shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
    if not all(t.dtype == torch.int64 for t in tensors):
        raise TypeError("probe tensors must be int64")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("probe tensors on different devices")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    if keys.device.type == "cuda":
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("probe tensors must be contiguous")
        if table.shape[0] >= 1 << 31:
            raise ValueError(f"table of {table.shape[0]} keys exceeds the "
                             "kernels' int32 row index")
    return keys.device.type


def probe_tally(keys, table, acc, directory=None, launch=None):
    """``acc[j] += #{i : keys[i] == table[j]}``, in place; returns *acc*.

    *keys*: (N,) int64, sentinel entries skipped.  *table*: (M,) int64
    sorted ascending, unique apart from trailing sentinel rows (which
    count 0).  *acc*: (M,) int64.  *directory*: the table's
    :class:`~.directory.Directory`, or None.  *launch*: a
    :class:`~.directory.Launch` override of the kernel's launch plan,
    or None (the plan); the result does not depend on it.  A CUDA
    tensor launches the kernel (building the directory first when none
    is given); a CPU tensor runs the plain version, which needs no
    directory and takes no launch.
    """
    args = tdir.launch_args(launch)
    if check_probe_args(keys, table, [("acc", acc, table.shape)]) == "cpu":
        acc += dev.small_table_tally(table, keys)
        return acc
    n, m = keys.shape[0], table.shape[0]
    if n == 0 or m == 0:
        return acc
    d = tdir.directory_for(table, directory)
    with torch.cuda.device(keys.device):
        if launch is not None:  # raises for the staged form over its edge
            tdir.launch_plan(n, d.live, d.bits, True, launch)
        err = _cuda.lib().kdf_probe_tally(
            keys.data_ptr(), n, table.data_ptr(), d.live,
            d.offsets.data_ptr(), d.bits, d.shift, acc.data_ptr(), *args,
            _cuda.stream_of(keys))
    _cuda.check(err, "probe_tally")
    tracing.count("launches.probe_tally")
    return acc


def probe_tally_weighted(keys, weights, table, acc, directory=None,
                         counts=None, launch=None):
    """``acc[j] += sum(weights[i] : keys[i] == table[j])``, in place;
    returns *acc*.

    *keys*, *weights*: (N,) int64, a batch's distinct keys and their
    multiplicities (:func:`.device.dedup_windows`); or, with *counts*,
    kernel K9d's (S, 8192) slots and (S,) int32 counts
    (:func:`.segsort.seg_dedup`), of which only the first counts[s] of
    row s are read.  Sentinel keys are skipped.  *table*, *acc*,
    *directory* and *launch* as for :func:`probe_tally`; K3 has no
    staged form.  A CUDA tensor launches kernel K3 (building the
    directory first when none is given); a CPU tensor runs the plain
    version, which needs no directory.
    """
    args = tdir.launch_args(launch)
    if args[0] == tdir.FORMS["staged"]:
        raise ValueError("K3 has no staged form")
    flat_keys, flat_weights = keys, weights
    if counts is not None:
        if (keys.dim() != 2 or keys.shape[1] != SEGMENT
                or counts.shape != keys.shape[:1]
                or counts.dtype != torch.int32
                or counts.device != keys.device):
            raise ValueError(
                f"expected (S, {SEGMENT}) slots and (S,) int32 counts on "
                f"their device, got {tuple(keys.shape)} and "
                f"{tuple(counts.shape)} {counts.dtype}")
        if weights.shape != keys.shape:
            raise ValueError(f"expected weights of shape {tuple(keys.shape)},"
                             f" got {tuple(weights.shape)}")
        flat_keys, flat_weights = keys.reshape(-1), weights.reshape(-1)
    kind = check_probe_args(flat_keys, table,
                            [("weights", flat_weights, flat_keys.shape),
                             ("acc", acc, table.shape)])
    if kind == "cuda" and counts is not None and not counts.is_contiguous():
        raise ValueError("probe tensors must be contiguous")
    if kind == "cpu":
        if counts is not None:
            keys, weights = dev.segment_compact(keys, weights, counts)
        return dev.weighted_tally(table, keys, weights, acc)
    n, m = flat_keys.shape[0], table.shape[0]
    if n == 0 or m == 0:
        return acc
    d = tdir.directory_for(table, directory)
    with torch.cuda.device(keys.device):
        err = _cuda.lib().kdf_probe_tally_weighted(
            flat_keys.data_ptr(), flat_weights.data_ptr(),
            None if counts is None else counts.data_ptr(), n,
            table.data_ptr(), d.offsets.data_ptr(), d.bits, d.shift,
            acc.data_ptr(), *args, _cuda.stream_of(keys))
    _cuda.check(err, "probe_tally_weighted")
    tracing.count("launches.probe_tally_weighted")
    return acc


def check_wide_probe_args(keys, table, others):
    """Checks shared by the wide probe wrappers: (N, Q) int64 *keys* and
    (M, Q) int64 *table* with Q in 2..7 (k = 33..207) and M < 2**31,
    and *others* ((name, tensor, shape) triples) on one device.  Returns
    the device type."""
    if keys.dim() != 2 or table.dim() != 2 or keys.shape[1] != table.shape[1]:
        raise ValueError(f"expected keys (N, Q) and table (M, Q), got "
                         f"{tuple(keys.shape)} and {tuple(table.shape)}")
    if not 2 <= table.shape[1] <= limbs_per_kmer(MAX_K):
        raise ValueError(f"expected Q in 2..{limbs_per_kmer(MAX_K)} limbs, "
                         f"got {table.shape[1]}")
    return _check_tensors(keys, table, others)


def probe_tally_wide(keys, table, acc, weights=None, directory=None,
                     counts=None):
    """``acc[j] += #{i : keys[i] == table[j]}``, or the sum of
    ``weights[i]`` over those i when *weights* is given, in place;
    returns *acc*.

    *keys*: (N, Q) int64 limb rows, sentinel rows skipped.  *table*:
    (M, Q) int64 rows ascending, unique apart from trailing sentinel
    rows (which count 0).  *acc*: (M,) int64.  *weights*: (N,) int64,
    normally the multiplicities of a batch's distinct keys
    (:func:`.device.dedup_windows_wide`); or, with *counts*, kernel
    K9dw's (S, 8192, Q) slots and (S, 8192) weights with (S,) int32
    counts (:func:`.segsort.seg_dedup_wide`), of which only the first
    counts[s] of segment s are read.  *directory*: the table's
    :class:`~.directory.Directory` (over limb 0), or None.  A CUDA
    tensor launches kernel K7 (building the directory first when none
    is given); a CPU tensor runs the plain version, which needs no
    directory.
    """
    flat_keys, flat_weights = keys, weights
    if counts is not None:
        if (keys.dim() != 3 or keys.shape[1] != SEGMENT or weights is None
                or weights.shape != keys.shape[:2]
                or counts.shape != keys.shape[:1]
                or counts.dtype != torch.int32
                or counts.device != keys.device):
            raise ValueError(
                f"expected (S, {SEGMENT}, Q) slots, (S, {SEGMENT}) weights "
                f"and (S,) int32 counts on their device, got "
                f"{tuple(keys.shape)}, "
                f"{None if weights is None else tuple(weights.shape)} and "
                f"{tuple(counts.shape)} {counts.dtype}")
        flat_keys = keys.reshape(-1, keys.shape[2])
        flat_weights = weights.reshape(-1)
    others = [("acc", acc, table.shape[:1])]
    if weights is not None:
        others.append(("weights", flat_weights, flat_keys.shape[:1]))
    kind = check_wide_probe_args(flat_keys, table, others)
    if kind == "cuda" and counts is not None and not (
            keys.is_contiguous() and weights.is_contiguous()
            and counts.is_contiguous()):
        raise ValueError("probe tensors must be contiguous")
    if kind == "cpu":
        if weights is None:
            acc += dev.small_table_tally_wide(table, keys)
            return acc
        if counts is not None:
            keys, weights = dev.segment_compact(keys, weights, counts)
        return dev.weighted_tally_wide(table, keys, weights, acc)
    n, m = flat_keys.shape[0], table.shape[0]
    if n == 0 or m == 0:
        return acc
    d = tdir.directory_for(table, directory)
    with torch.cuda.device(keys.device):
        err = _cuda.lib().kdf_probe_tally_wide(
            flat_keys.data_ptr(),
            None if weights is None else flat_weights.data_ptr(),
            None if counts is None else counts.data_ptr(), n,
            table.data_ptr(), d.offsets.data_ptr(), d.bits, d.shift,
            table.shape[1], acc.data_ptr(), _cuda.stream_of(keys))
    _cuda.check(err, "probe_tally_wide")
    if weights is None:
        tracing.count("launches.probe_tally_wide")
    else:
        tracing.count("launches.probe_tally_wide_weighted")
    return acc
