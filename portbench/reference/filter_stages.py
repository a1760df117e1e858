"""Plain reference of the filter scan, stage by stage: each stage's
least bytes.

The table's counts, their checks (``rows_differing`` and
``count_sum_gap``, both with limit 0) and, for every pool batch, its
distinct keys and the table rows it hits are
:func:`portbench.reference.filter_scan.expected_counts`', the one
recount.  Beside them, for every pool batch of B reads of L codes at k,
this counts, in plain PyTorch and apart from the port:

* the *window slots*, B (L - k + 1): the (B, L - k + 1) grid of every
  start of every read, valid or not, as an extract stage writes it;
* the *valid windows*: those inside their read with no code above 3;
* the *segments*: the grid flattened row by row and cut into runs of
  :data:`SEGMENT` slots, the last one short (the port's cut:
  ``ops/segsort.py`` pads the flat window stream with sentinel keys to a
  multiple of ``SEGMENT`` = 8,192 rows and dedups each run of 8,192 on
  its own);
* the *segment keys*: the distinct canonical keys of the valid windows
  of each segment, summed over the segments.

With the rows hit that recount gives, each stage's least bytes follow
from those counts, with a key taken as C = ceil(W / 2) int64 columns (8C bytes; :mod:`portbench.kmerwords`),
the fewest whole int64 words a 2k-bit key fits in: 1 at k = 31, 2 at
k = 63.  Whatever implements a stage has to move at least these bytes,
each once:

* **extract**: the codes and lengths in (B L + 4 B) and a key out for
  every window slot (8C each): the next stage reads the grid by
  position, so no slot can be left unwritten;
* **dedup**: every slot's key in (8C each); out, each distinct key of a
  segment with its multiplicity (8C + 8 each) and each segment's count
  of them (4 each): fewer keys out would lose a distinct key, fewer
  multiplicities a count;
* **tally**: each distinct key of a segment with its multiplicity in
  (8C + 8 each) and, for it, one 32-byte sector of the table, the least
  a random read of device memory moves; then, for each table row hit,
  its 8-byte count read and written (16 each).

A stage that moves more than this (a wider key, a dedup that keeps every
row where its hash gives up, a second probe of one key) reads below its
roofline, never above it.
"""

import torch

from portbench import kmerwords as kw

SEGMENT = 8192  # window slots a segment (ops/segsort.py SEGMENT)
SECTOR = 32     # bytes of device memory one random read moves


def batch_stages(codes, lengths, k, segment=SEGMENT):
    """One batch's stage counts {"slots", "windows", "segments",
    "segment_keys", "code_bytes"}: *codes* (B, L) and *lengths* (B,)
    tensors."""
    keys, valid = kw.window_keys(codes, lengths, k)
    slots = valid.numel()
    flat = keys.reshape(slots, -1)[valid.reshape(-1)]
    seg = torch.nonzero(valid.reshape(-1)).flatten() // segment
    segment_keys = kw.unique_counts(
        torch.cat([seg.unsqueeze(1), flat], 1))[0].shape[0]
    return {"slots": slots,
            "windows": flat.shape[0],
            "segments": -(-slots // segment),
            "segment_keys": segment_keys,
            "code_bytes": (codes.numel() * codes.element_size()
                           + lengths.numel() * lengths.element_size())}


def stage_counts(pool, k, device, segment=SEGMENT):
    """:func:`batch_stages` of each pool batch, made on *device*."""
    return [batch_stages(torch.from_numpy(codes).to(device),
                         torch.from_numpy(lengths).to(device), k, segment)
            for codes, lengths in pool]


def stage_bytes(batch, rows_hit, k):
    """{"extract_bytes", "dedup_bytes", "tally_bytes"}: each stage's
    least bytes for one batch's counts and the table rows it hits (the
    module's rules)."""
    key = 8 * kw.columns_per_kmer(k)
    return {
        "extract_bytes": batch["code_bytes"] + key * batch["slots"],
        "dedup_bytes": (key * batch["slots"]
                        + (key + 8) * batch["segment_keys"]
                        + 4 * batch["segments"]),
        "tally_bytes": ((key + 8 + SECTOR) * batch["segment_keys"]
                        + 16 * rows_hit)}


def fed_bytes(stages, per_batch, feeds, k):
    """Each stage's least bytes summed over the batches fed, and the
    whole step's (``least_bytes``, as ``step_roofline.filter`` reads it:
    codes and lengths, a 32-byte sector a distinct key of the batch, 16
    bytes a row hit).  *stages*: :func:`stage_counts`; *per_batch*: the
    (distinct keys, rows hit) of each pool batch that
    :func:`filter_scan.expected_counts` gives; *feeds*: how often each
    was fed."""
    total = {"least_bytes": 0}
    for batch, (distinct, rows), times in zip(stages, per_batch, feeds):
        total["least_bytes"] += times * (batch["code_bytes"] + 32 * distinct
                                         + 16 * rows)
        for name, n in stage_bytes(batch, rows, k).items():
            total[name] = total.get(name, 0) + times * n
    return total


def stage_roofline(run, stage, kernels):
    """*stage*'s share of its bandwidth roofline in the traced window of
    *run* (a run's state, as the metric readers take it), %: the stage's
    least bytes (``work["<stage>_bytes"]``) over the card's peak
    bandwidth, divided by the device time of the kernels whose function
    name holds one of *kernels* (the trace summary's ``device_ops``).
    None where the run has no such kernel, bytes or peak."""
    trace, peaks = run["trace"], run["peaks"]
    least = run["work"].get(f"{stage}_bytes")
    if not trace or not peaks or not least:
        return None
    seconds = sum(s for name, s in trace["device_ops"]
                  if any(kernel in name for kernel in kernels))
    if seconds <= 0:
        return None
    return least / peaks["hbm_bytes_per_s"] / seconds * 100
