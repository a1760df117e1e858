"""Kernel K9, K9d and K9dw wrappers: the segment-local sort and dedup of
a flat window-key stream.

K9 (``seg_sort``) is the counterpart of the Pallas kernel
``scripts/x_fused.py:_sort_kernel`` (:133, via ``seg_sort_pallas`` :144),
an in-VMEM bitonic sort of each 8,192-row segment with one payload
riding along.  K9d (``seg_dedup``) is the counterpart of
``kmer_denovo_filter_tpu/ops/pallas_join.py:_dedup_compact`` (:600), the
XLA front half of the dedup-first tally: each segment's distinct keys
with their multiplicities, left in the segment's slot.  K9dw
(``seg_dedup_wide``) is the same for wide keys, (N, Q) limb rows, the
counterpart of ``pallas_join._dedup_compact_wide`` (:1494).  Kernels K3
(``probe.probe_tally_weighted``) and K7 (``probe.probe_tally_wide``)
read those slots as they stand, so the engine's dedup form is K1 -> K9d
-> K3, or K1w -> K9dw -> K7 for k > 31, with no compaction and no host
sync between them.  Those tallies read no order among a slot's keys, so
the engine takes K9d's and K9dw's unordered form (``ordered=False``),
which sorts nothing; K12 (``sortcount``) merges the sorted slots of the
ordered form.  K9 and K9d are in ``csrc/seg_sort.cu``, K9dw in
``csrc/seg_dedup_wide.cu``; all three sort by the register network of
``csrc/block_sort.cuh``.

The stream is cut into segments of :data:`SEGMENT` rows, its tail padded
with :data:`~.keys.SENTINEL` keys (rows), as the JAX dedup pads its
stream with the all-ones word (pallas_join.py:823); K9d and K9dw read
the tail's padding as sentinels without a padded copy.  CPU tensors take
the plain versions in :mod:`.device` (``segment_sort``,
``segment_runs``, ``segment_runs_wide``).
"""

import torch

from kmer_denovo_filter_tpu_torch import tracing
from kmer_denovo_filter_tpu_torch.ops import _cuda
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops.keys import (
    MAX_K,
    SENTINEL,
    limbs_per_kmer,
)

SEGMENT = 8192  # rows a segment (pallas_join.LCHUNK_DD)


def segments(flat, fill):
    """(N,) *flat* padded with *fill* to a multiple of :data:`SEGMENT`,
    as an (S, SEGMENT) contiguous tensor; (N, Q) rows padded with rows
    of *fill*, as (S, SEGMENT, Q)."""
    pad = -flat.shape[0] % SEGMENT
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,) + flat.shape[1:],
                                              fill)])
    return flat.reshape((-1, SEGMENT) + flat.shape[1:]).contiguous()


def _check(flat, payload=None):
    """(N,) int64 *flat* and an optional (N,) int32 *payload* on one
    device; returns the device type."""
    if flat.dim() != 1 or flat.dtype != torch.int64:
        raise ValueError(f"expected (N,) int64 keys, got {tuple(flat.shape)} "
                         f"{flat.dtype}")
    if payload is not None and (payload.shape != flat.shape
                                or payload.dtype != torch.int32
                                or payload.device != flat.device):
        raise ValueError("expected an (N,) int32 payload on the keys' device")
    if flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {flat.device}")
    return flat.device.type


def seg_sort(flat, payload=None):
    """Each 8,192-row segment of the (N,) int64 stream *flat* sorted
    ascending (sentinel keys last), with the (N,) int32 *payload*, if
    given, riding along.

    Returns ``(keys, payload)`` as (S, 8192) tensors, S = ceil(N /
    8192), or ``(keys, None)``: padding rows hold :data:`SENTINEL` keys
    and payload -1.  The order within equal keys is unspecified.  A CUDA
    tensor launches kernel K9; a CPU tensor runs the plain version.
    """
    kind = _check(flat, payload)
    keys = segments(flat, SENTINEL)
    pay = None if payload is None else segments(payload, -1)
    if kind == "cpu":
        return dev.segment_sort(keys, pay)
    keys_out = torch.empty_like(keys)
    pay_out = None if pay is None else torch.empty_like(pay)
    if keys.shape[0] == 0:
        return keys_out, pay_out
    with torch.cuda.device(flat.device):
        err = _cuda.lib().kdf_seg_sort(
            keys.data_ptr(), None if pay is None else pay.data_ptr(),
            keys_out.data_ptr(), None if pay is None else pay_out.data_ptr(),
            keys.shape[0], _cuda.stream_of(flat))
    _cuda.check(err, "seg_sort")
    tracing.count("launches.seg_sort")
    return keys_out, pay_out


def _flags(n_seg, ordered, device):
    """The int32 per-segment outputs of K9d / K9dw: counts, and beside
    them, unordered, the passed-through flags (else None)."""
    if ordered:
        return torch.empty(n_seg, dtype=torch.int32, device=device), None
    flags = torch.empty((2, n_seg), dtype=torch.int32, device=device)
    return flags[0], flags[1]


def _plain(out, ordered):
    """The plain version's sorted, merged slots; unordered, with the
    flags of no segment passed through."""
    return out if ordered else (*out, torch.zeros_like(out[2]))


def seg_dedup(flat, ordered=True):
    """Segment-local dedup of the (N,) int64 stream *flat*.

    Returns ``(keys, weights, counts)``: (S, 8192) int64 keys and
    weights and (S,) int32 counts, S = ceil(N / 8192).  Row s begins
    with the counts[s] distinct live keys of segment s, ascending, and
    their multiplicities; sentinel keys form no run.  What follows in a
    row is unspecified (the kernel leaves it unwritten).  A CUDA tensor
    launches kernel K9d; a CPU tensor runs the plain version.

    *ordered* False is the form for a consumer that reads no order among
    a segment's keys and adds weights that commute (the parent filter's
    K3): ``(keys, weights, counts, passed)``, row s beginning with
    counts[s] live keys whose weights sum, key by key, to the key's
    multiplicity in segment s; their order, and whether equal keys are
    merged, are unspecified.  The kernel sorts nothing then: a segment
    whose hash gives up is passed through (every live key, of weight 1),
    in row order, and passed[s] (int32) is 1 for such a segment, else 0;
    a segment the hash keeps leaves its distinct keys with their counts
    in slot order.  The plain version merges every segment (passed all
    0).
    """
    if _check(flat) == "cpu":
        return _plain(dev.segment_runs(segments(flat, SENTINEL)), ordered)
    n = flat.shape[0]
    n_seg = -(-n // SEGMENT)
    keys = torch.empty((n_seg, SEGMENT), dtype=torch.int64,
                       device=flat.device)
    weights = torch.empty_like(keys)
    counts, passed = _flags(n_seg, ordered, flat.device)
    out = (keys, weights, counts) + (() if ordered else (passed,))
    if n_seg == 0:
        return out
    flat = flat.contiguous()
    with torch.cuda.device(flat.device):
        err = _cuda.lib().kdf_seg_dedup(
            flat.data_ptr(), n, int(ordered), keys.data_ptr(),
            weights.data_ptr(), counts.data_ptr(),
            None if ordered else passed.data_ptr(), _cuda.stream_of(flat))
    _cuda.check(err, "seg_dedup")
    tracing.count("launches.seg_dedup")
    return out


def seg_dedup_wide(flat, ordered=True):
    """Segment-local dedup of the (N, Q) int64 limb rows *flat* (Q in
    2..7, the row form of :mod:`.keys`: limb 0 first, compared
    row-lexicographically, the sentinel in every limb).

    Returns ``(keys, weights, counts)``: (S, 8192, Q) int64 rows, (S,
    8192) int64 weights and (S,) int32 counts, S = ceil(N / 8192).
    Segment s begins with its counts[s] distinct live rows, ascending,
    and their multiplicities; sentinel rows form no run.  What follows
    in a segment is unspecified (the kernel leaves it unwritten).  A
    CUDA tensor launches kernel K9dw (it must be contiguous); a CPU
    tensor runs the plain version.  *ordered* False: as
    :func:`seg_dedup`'s, ``(keys, weights, counts, passed)`` with rows
    for keys (the parent filter's K7 reads them).
    """
    if (flat.dim() != 2 or flat.dtype != torch.int64
            or not 2 <= flat.shape[1] <= limbs_per_kmer(MAX_K)):
        raise ValueError(f"expected (N, Q) int64 rows with Q in "
                         f"2..{limbs_per_kmer(MAX_K)}, got "
                         f"{tuple(flat.shape)} {flat.dtype}")
    if flat.device.type == "cpu":
        return _plain(dev.segment_runs_wide(segments(flat, SENTINEL)),
                      ordered)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    if not flat.is_contiguous():
        raise ValueError("seg_dedup_wide needs contiguous rows")
    n, q = flat.shape
    n_seg = -(-n // SEGMENT)
    keys = torch.empty((n_seg, SEGMENT, q), dtype=torch.int64,
                       device=flat.device)
    weights = torch.empty((n_seg, SEGMENT), dtype=torch.int64,
                          device=flat.device)
    counts, passed = _flags(n_seg, ordered, flat.device)
    out = (keys, weights, counts) + (() if ordered else (passed,))
    if n_seg == 0:
        return out
    with torch.cuda.device(flat.device):
        err = _cuda.lib().kdf_seg_dedup_wide(
            flat.data_ptr(), n, q, int(ordered), keys.data_ptr(),
            weights.data_ptr(), counts.data_ptr(),
            None if ordered else passed.data_ptr(), _cuda.stream_of(flat))
    _cuda.check(err, "seg_dedup_wide")
    tracing.count("launches.seg_dedup_wide")
    return out
