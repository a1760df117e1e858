"""Pinned staging of host read batches on their way to a CUDA device.

:class:`Stage` is a ring of :data:`SLOTS` reused slots, taken in turn.  A
slot holds a pinned host buffer for a batch's (B, L) uint8 codes and one
for its (B,) int32 lengths, device buffers of the same sizes, an event
marking the end of its last copy up and one marking the end of the last
launch that read its device buffers.  Each buffer is as large as the
largest batch the slot has taken, and grows when a larger one comes.
:meth:`Stage.put`:

1. takes the next slot and, if its last copy up is still in flight,
   waits for it on the host: the only back-pressure, so the host runs at
   most :data:`SLOTS` copies ahead of the copy engine;
2. copies the caller's arrays into the slot's pinned buffers, converted as
   :func:`.steps.to_device` converts them (uint8 codes, int32 lengths,
   contiguous), on torch's intra-op threads: the caller's count, raised
   for the copy alone to :data:`COPY_THREADS` (or the cores this process
   may run on, if fewer) where the caller has set it lower.
   Every batch is copied, every time: when ``put`` returns the caller may
   overwrite its arrays;
3. on the stage's own copy stream, waits for the last reader of the
   slot's device buffers, copies them up (``non_blocking``) and records
   the copy's end;
4. makes the current stream, the kernels', wait for that copy, and
   returns the batch's views of the slot's device buffers.

The caller enqueues the launch that reads the batch on the current
stream, then marks its end with :meth:`Stage.release`.  Nothing waits for
the card but step 1.

Off CUDA nothing is pinned and there is no stream or event: ``put`` fills
the slot's host buffers and returns views of them, so the ring's
bookkeeping runs on the CPU.  While tracing is on (:mod:`.tracing`) the
stage counts ``filter.stage_waits``, the puts whose slot still had its
copy up in flight, and ``filter.stage_grows``, the slots (re)allocated for
a batch larger than they held.
"""

import math
import os

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch import tracing

# slots in the ring: while the host fills one, the batch before it can be
# on its way up and the one before that still waiting for its reader
SLOTS = 3
# the fewest intra-op threads of the host copy into pinned memory (bounded
# by the cores this process may run on): a 4.9 MB batch took 0.88-1.06 ms
# on one thread of an 8-core H100 host and 0.19 ms on eight, where the
# pageable copy took 1.07-1.15 ms (PERF.md section 6)
COPY_THREADS = 8


class _Slot:
    """One batch's buffers, host and device, its two events, and the
    views of its buffers for the shapes of the last batch it took."""

    __slots__ = ("codes", "lengths", "dev_codes", "dev_lengths", "copied",
                 "read", "shapes", "host", "up")

    def __init__(self, pinned):
        self.codes = self.lengths = None
        self.dev_codes = self.dev_lengths = None
        self.shapes = self.host = self.up = None
        # recorded at the end of the slot's copy up / of the launch that
        # read its device buffers; unrecorded, both wait for nothing
        self.copied = torch.cuda.Event() if pinned else None
        self.read = torch.cuda.Event() if pinned else None

    def holds(self, n_codes, n_lengths):
        return (self.codes is not None and self.codes.numel() >= n_codes
                and self.lengths.numel() >= n_lengths)

    def view(self, shapes):
        """Take the views of a batch of *shapes*: its codes' and its
        lengths'."""
        self.shapes = shapes
        self.host = _views((self.codes, self.lengths), shapes)
        if self.dev_codes is not None:
            self.up = _views((self.dev_codes, self.dev_lengths), shapes)


def _views(buffers, shapes):
    return tuple(buf[:math.prod(shape)].view(shape)
                 for buf, shape in zip(buffers, shapes))


class Stage:
    """A ring of :data:`SLOTS` staging slots for batches bound for
    *device*: pinned, with a copy stream of its own, on a CUDA device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self.slots = [_Slot(self.pinned) for _ in range(SLOTS)]
        self._turn = 0
        self._last = None
        self._kernels = None  # the stream the last batch put was bound for
        self._stream = (torch.cuda.Stream(self.device) if self.pinned
                        else None)
        self._threads = max(1, min(COPY_THREADS,
                                   len(os.sched_getaffinity(0))))

    def put(self, codes, lengths):
        """(B, L) uint8 codes and (B,) int32 lengths of the host batch
        (*codes*, *lengths*) on the device, the current stream ordered
        after their copy up; off CUDA, the slot's host copies of them."""
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        slot = self.slots[self._turn]
        self._turn = (self._turn + 1) % len(self.slots)
        self._last = slot
        if self.pinned:
            if tracing.enabled() and not slot.copied.query():
                tracing.count("filter.stage_waits")
            slot.copied.synchronize()
        shapes = (codes.shape, lengths.shape)
        if slot.shapes != shapes:
            self._fit(slot, codes.size, lengths.size)
            slot.view(shapes)
        self._copy_in(slot.host, (torch.from_numpy(codes),
                                  torch.from_numpy(lengths)))
        if not self.pinned:
            return slot.host
        # the streams set directly and the views kept per shape: the
        # stream context manager and fresh views cost the host 0.1-0.15 ms
        # a batch on an H100's host (PERF.md section 6)
        kernels = self._kernels = torch.cuda.current_stream(self.device)
        torch.cuda.set_stream(self._stream)
        try:
            self._stream.wait_event(slot.read)
            for dst, src in zip(slot.up, slot.host):
                dst.copy_(src, non_blocking=True)
            slot.copied.record(self._stream)
        finally:
            torch.cuda.set_stream(kernels)
        kernels.wait_event(slot.copied)
        return slot.up

    def release(self):
        """Mark the last batch put as read: its slot's device buffers are
        free once the launches enqueued so far on the stream it was put
        for have run."""
        if self.pinned:
            self._last.read.record(self._kernels)

    def _fit(self, slot, n_codes, n_lengths):
        """Grow *slot* to hold *n_codes* codes and *n_lengths* lengths;
        its last copy up has finished, and a device buffer it drops is
        reused only after the launches queued on it and the copy stream.

        A new device buffer comes from the current stream's pool, which
        may hand out a block whose readers are still queued on that
        stream; the copy stream, its first writer, is ordered after them."""
        if slot.holds(n_codes, n_lengths):
            return
        if tracing.enabled():
            tracing.count("filter.stage_grows")
        if slot.codes is not None:
            n_codes = max(n_codes, slot.codes.numel())
            n_lengths = max(n_lengths, slot.lengths.numel())
        slot.codes = torch.empty(n_codes, dtype=torch.uint8,
                                 pin_memory=self.pinned)
        slot.lengths = torch.empty(n_lengths, dtype=torch.int32,
                                   pin_memory=self.pinned)
        if self.pinned:
            slot.dev_codes = torch.empty(n_codes, dtype=torch.uint8,
                                         device=self.device)
            slot.dev_lengths = torch.empty(n_lengths, dtype=torch.int32,
                                           device=self.device)
            slot.dev_codes.record_stream(self._stream)
            slot.dev_lengths.record_stream(self._stream)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def _copy_in(self, dsts, srcs):
        """``dst.copy_(src)`` of each pair on torch's intra-op threads,
        their count raised to the stage's for the copy alone where the
        caller set it lower, and never cut."""
        held = torch.get_num_threads()
        lift = held < self._threads
        if lift:
            torch.set_num_threads(self._threads)
        try:
            for dst, src in zip(dsts, srcs):
                dst.copy_(src)
        finally:
            if lift:
                torch.set_num_threads(held)
