"""Kernel K12 wrapper: the stream count's sort-count of one batch.

The JAX package sort-counts each batch's window keys on the device in
XLA, ``kmer_denovo_filter_tpu/ops/device.py:sort_count`` (:121: a
``jax.lax.sort`` over the W word columns, then ``_run_lengths`` :145),
and ``StreamCounter.feed`` masks the sentinel run (engine.py:381).
:func:`sort_count` (flat (N,) int64 keys, k <= 31) and
:func:`sort_count_wide` ((N, Q) limb rows) return the distinct live keys
ascending with their int64 counts, the sentinel dropped.

A CUDA tensor runs K12 (``csrc/sort_count.cu``) behind K9d (or K9dw for
wide rows, :mod:`.segsort`): the batch's segment-local dedup leaves S
sorted runs in the segments' slots, and K12 merges them, a tree of
ceil(log2 S) rounds of merge-path tiles, then sums the equal rows.  The
wrappers take k and check that the keys have its limbs.  The call syncs
once, to read the number of distinct keys; the results are views of
that many rows.  A CPU tensor runs the plain versions,
:func:`.device.sort_count` and :func:`.device.sort_count_wide`
(``torch.unique``; Q stable ``torch.sort``s).  Both give the same
tensors.
"""

import torch

from kmer_denovo_filter_tpu_torch.ops import _cuda, segsort
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops.keys import (
    MAX_K,
    check_k,
    limbs_per_kmer,
)

# CUDA kernel launches since import (or since a caller reset them to 0)
launches = 0

# K9d's segments, 2**SEGMENT_SHIFT rows each: K12's first round reads
# their slots in place
SEGMENT_SHIFT = segsort.SEGMENT.bit_length() - 1
assert segsort.SEGMENT == 1 << SEGMENT_SHIFT


def _check_k(q, k):
    """Raise unless *k* is a valid k whose keys have *q* limbs."""
    check_k(k)
    if limbs_per_kmer(k) != q:
        raise ValueError(f"k={k} keys have {limbs_per_kmer(k)} limbs, "
                         f"not {q}")


def sort_count(flat, k):
    """Distinct live keys of the (N,) int64 window keys *flat* at *k*
    (keys below 4**k), ascending, and their int64 counts; sentinel keys
    are dropped.  A CUDA tensor launches K12 (one host sync), a CPU
    tensor runs the plain version."""
    if flat.dim() != 1 or flat.dtype != torch.int64:
        raise ValueError(f"expected (N,) int64 keys, got "
                         f"{tuple(flat.shape)} {flat.dtype}")
    _check_k(1, k)
    if flat.device.type == "cpu":
        return dev.sort_count(flat)
    return _distinct(*launch(flat, k))


def sort_count_wide(flat, k):
    """Distinct live rows of the (N, Q) int64 limb rows *flat* at *k*
    (Q = ceil(k / 31) in 2..7), ascending, and their int64 counts;
    sentinel rows are dropped.  A
    CUDA tensor launches K12 (one host sync), a CPU tensor runs the
    plain version."""
    if (flat.dim() != 2 or flat.dtype != torch.int64
            or not 2 <= flat.shape[1] <= limbs_per_kmer(MAX_K)):
        raise ValueError(f"expected (N, Q) int64 rows with Q in "
                         f"2..{limbs_per_kmer(MAX_K)}, got "
                         f"{tuple(flat.shape)} {flat.dtype}")
    _check_k(flat.shape[1], k)
    if flat.device.type == "cpu":
        return dev.sort_count_wide(flat)
    return _distinct(*launch(flat.contiguous(), k))


def _distinct(keys, counts, totals):
    """The first totals[1] rows of *keys* and *counts*: one host sync."""
    distinct = int(totals[1])
    return keys[:distinct], counts[:distinct]


def launch(flat, k):
    """K9d (K9dw for (N, Q) rows) and K12 on the CUDA tensor *flat*,
    with no host sync: ``(keys, counts, totals)`` on the card, N rows
    each of which the first ``totals[1]`` hold the result.  The
    wrappers above read that count."""
    global launches
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    n = flat.shape[0]
    q = 1 if flat.dim() == 1 else flat.shape[1]
    if n == 0:
        return (flat.new_empty(flat.shape), flat.new_empty((0,)),
                flat.new_zeros(2))
    if q == 1:
        keys0, weights0, seg_counts = segsort.seg_dedup(flat)
    else:
        keys0, weights0, seg_counts = segsort.seg_dedup_wide(flat)
    n_segments = seg_counts.shape[0]
    keys1 = torch.empty_like(keys0)
    weights1 = torch.empty_like(weights0)
    aux = flat.new_empty((_cuda.lib().kdf_sort_count_aux(n_segments),))
    keys_out = flat.new_empty((weights0.numel(),) + flat.shape[1:])
    counts_out = flat.new_empty((weights0.numel(),))
    with torch.cuda.device(flat.device):
        err = _cuda.lib().kdf_sort_count(
            keys0.data_ptr(), weights0.data_ptr(), seg_counts.data_ptr(),
            SEGMENT_SHIFT, n_segments, q, keys1.data_ptr(),
            weights1.data_ptr(), aux.data_ptr(), keys_out.data_ptr(),
            counts_out.data_ptr(), _cuda.stream_of(flat))
    _cuda.check(err, "sort_count")
    launches += 1
    return keys_out, counts_out, aux[:2]
