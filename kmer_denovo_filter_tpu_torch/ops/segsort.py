"""Kernel K9 and K9d wrappers: the segment-local sort and dedup of a flat
window-key stream.

K9 (``seg_sort``) is the counterpart of the Pallas kernel
``scripts/x_fused.py:_sort_kernel`` (:133, via ``seg_sort_pallas`` :144),
an in-VMEM bitonic sort of each 8,192-row segment with one payload
riding along.  K9d (``seg_dedup``) is the counterpart of
``kmer_denovo_filter_tpu/ops/pallas_join.py:_dedup_compact`` (:600), the
XLA front half of the dedup-first tally: that sort, then each segment's
distinct keys with their run lengths.  :func:`dedup_segments` gathers
K9d's rows into one stream and sorts it, the input of kernel K3
(``probe.probe_tally_weighted``).  Both CUDA kernels are in
``csrc/seg_sort.cu``.

The stream is cut into segments of :data:`SEGMENT` rows after padding
it with :data:`~.keys.SENTINEL` keys, as the JAX dedup pads its stream
with the all-ones word (pallas_join.py:823).  CPU tensors take the
plain versions in :mod:`.device` (``segment_sort``, ``segment_runs``).
"""

import torch

from kmer_denovo_filter_tpu_torch.ops import _cuda
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL

SEGMENT = 8192  # rows a segment (pallas_join.LCHUNK_DD)

# CUDA kernel launches since import (or since a caller reset them to 0)
launches = 0        # K9
dedup_launches = 0  # K9d


def segments(flat, fill):
    """(N,) *flat* padded with *fill* to a multiple of :data:`SEGMENT`,
    as an (S, SEGMENT) contiguous tensor."""
    pad = -flat.shape[0] % SEGMENT
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), fill)])
    return flat.reshape(-1, SEGMENT).contiguous()


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
    global launches
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
    launches += 1
    return keys_out, pay_out


def seg_dedup(flat):
    """Segment-local dedup of the (N,) int64 stream *flat*.

    Returns ``(keys, weights, counts)``: (S, 8192) int64 keys and
    weights and (S,) int32 counts.  Row s begins with the counts[s]
    distinct live keys of segment s, ascending, and their multiplicities;
    sentinel keys form no run.  What follows in a row is unspecified (the
    kernel leaves it unwritten).  A CUDA tensor launches kernel K9d; a
    CPU tensor runs the plain version.
    """
    global dedup_launches
    kind = _check(flat)
    keys = segments(flat, SENTINEL)
    if kind == "cpu":
        return dev.segment_runs(keys)
    keys_out = torch.empty_like(keys)
    weights = torch.empty_like(keys)
    counts = torch.empty(keys.shape[0], dtype=torch.int32,
                         device=flat.device)
    if keys.shape[0] == 0:
        return keys_out, weights, counts
    with torch.cuda.device(flat.device):
        err = _cuda.lib().kdf_seg_dedup(
            keys.data_ptr(), keys_out.data_ptr(), weights.data_ptr(),
            counts.data_ptr(), keys.shape[0], _cuda.stream_of(flat))
    _cuda.check(err, "seg_dedup")
    dedup_launches += 1
    return keys_out, weights, counts


def compact(keys, weights, counts):
    """The first counts[s] rows of each segment of :func:`seg_dedup`'s
    output, as one (U,) stream of keys and one of weights, in segment
    order.  The boolean gather reads the total count back to the host:
    one synchronisation per batch, as ``torch.unique`` in
    :func:`.device.dedup_windows` makes one."""
    mask = (torch.arange(SEGMENT, device=keys.device)[None, :]
            < counts[:, None])
    return keys[mask], weights[mask]


def dedup_segments(flat):
    """The segment-local dedup of the (N,) int64 stream *flat* as one
    (keys, weights) stream sorted by key: K9d, :func:`compact`, then a
    global ``torch.sort``.  A key repeated in several segments stays
    one row per segment; kernel K3 adds their weights exactly.  Sentinel
    keys are dropped, so the weights sum to the live windows."""
    keys, weights = compact(*seg_dedup(flat))
    keys, order = torch.sort(keys)
    return keys, weights[order]
