"""The port's spans and counters: one registry for the whole process.

* :func:`span` times one call at a layer boundary.  Off (the default) it
  returns one shared null context after reading one module global: it
  enters no ``torch.profiler.record_function`` and allocates nothing.  On
  (:func:`enable`) a span is kept in memory, stamped by
  :func:`time.time_ns`, the Unix-nanosecond clock the profiler converts
  its events to, so an exported span lies over the trace; and while a
  profiler runs (``torch.profiler``, ``KDF_PROFILE``'s or a benchmark's)
  it also enters ``record_function(name)``, so it lands on that timeline
  beside the device's kernels and copies.  With no profiler running it
  does not: ``record_function`` costs microseconds even then.  A
  span records its name, start, end, the span that encloses it (a stack a
  thread) and its batch: the ordinal of its outermost span among that
  name's calls, so every child of one ``filter.feed`` carries that
  call's number.  Spans aggregate a name (count, total, max); the first
  :data:`RECORDS` are also kept one by one.
* :func:`count` adds to a counter.  The kernels' launch counters,
  ``launches.<kernel>`` (:data:`KERNELS`), count always, as a plain
  integer add; the engine's other counters count only while tracing is
  on.  :func:`count_on_device` adds a tensor's sum into a scalar on its
  device, with no host sync, read once by :func:`collect`.

Every span and counter is listed once, here, with the layer it belongs
to (:data:`SPANS`, :data:`COUNTERS`).  ``KDF_PROFILE`` turns tracing on
for a whole run and writes :func:`collect` beside its trace
(:mod:`.profiling`).
"""

import contextlib
import threading
import time

import torch

ENGINE = "engine (engine.FilteredCounter)"
BUILD = "keys and build (engine.KmerIndex, ops/convert.py K11, ops/directory.py)"
KERNELS_LAYER = ("kernels (csrc/ through ops/extract.py, ops/segsort.py, "
                 "ops/probe.py)")
COUNT = "stream count (engine.StreamCounter)"
SCAN = "anchoring scan (engine.scan_reads_for_hits_many)"
DECODE = "decode (utils.prefetch_batches)"

# every span the port opens: name -> layer
SPANS = {
    "filter.feed": ENGINE,           # FilteredCounter.feed, whole
    "filter.feed.htod": ENGINE,      # the batch up: on a card the slot's
                                     # wait, the host copy into pinned
                                     # memory and the copy up enqueued
    "filter.feed.extract": ENGINE,   # K1 / K1w enqueued
    "filter.feed.dedup": ENGINE,     # K9d / K9dw enqueued
    "filter.feed.tally": ENGINE,     # K3 / K7 / K2 enqueued
    "filter.feed.graph": ENGINE,     # on a card, the three enqueued as
                                     # one CUDA graph (engine._StepGraphs)
    "filter.result": ENGINE,         # the accumulator's copy back
    "index.build": BUILD,            # KmerIndex.__init__, whole
    "index.upload": BUILD,           # the host words up (pageable)
    "index.convert": BUILD,          # K11 (numpy on the CPU)
    "index.directory": BUILD,        # live rows and the prefix directory
    "count.sort": COUNT,             # K12, with its host sync
    "count.dtoh": COUNT,             # a batch's rows and counts back
    "count.consolidate": COUNT,      # the host merge of pending chunks
    "count.result.words": COUNT,     # result()'s keys back to words
    "scan.stage": SCAN,              # the padded group made and copied up
    "scan.member": SCAN,             # K1 and K4 (K1w and K8) enqueued
    "scan.mask_back": SCAN,          # the mask back and split per batch
    "prefetch.wait": DECODE,         # the consumer waiting on the queue
    "prefetch.decode": DECODE,       # the producer's next() of a batch
}

# the kernels whose launches count always, as ``launches.<kernel>``
KERNELS = (
    "extract_canonical",          # K1
    "probe_tally",                # K2
    "probe_tally_weighted",       # K3
    "probe_member",               # K4
    "build_directory",            # the prefix directory
    "extract_canonical_wide",     # K1w
    "probe_tally_wide",           # K7, unweighted
    "probe_tally_wide_weighted",  # K7, weighted
    "probe_member_wide",          # K8
    "seg_sort",                   # K9
    "seg_dedup",                  # K9d
    "seg_dedup_wide",             # K9dw
    "route",                      # K10
    "words_to_keys",              # K11
    "sort_count",                 # K12
    "extract_canonical_stage",    # K1 cut at a stage (timing probes)
)

# every counter: name -> layer
COUNTERS = {
    "filter.batches": ENGINE,
    "filter.reads": ENGINE,
    "filter.windows": ENGINE,         # sum of max(0, length - k + 1)
    "filter.bytes_up": ENGINE,        # codes and lengths copied up
    "filter.stage_waits": ENGINE,     # feeds that waited for their slot
    "filter.stage_grows": ENGINE,     # slots (re)allocated for a larger batch
    # keys the tally probes: distinct where the hash kept the segment,
    # every live key where it passed it through (K9d's / K9dw's counts)
    "filter.distinct_keys": KERNELS_LAYER,
    "filter.segments": KERNELS_LAYER,         # segments fed to the dedup
    "filter.passed_segments": KERNELS_LAYER,  # segments it passed through
    "count.merges": COUNT,
    **{f"launches.{kernel}": KERNELS_LAYER for kernel in KERNELS},
}

# spans kept one by one (aggregates go on past it)
RECORDS = 1 << 18

_on = False
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_stats = {}       # name -> [count, total ns, max ns]
_records = []     # (name, start ns, end ns, parent, batch, thread)
_dropped = 0      # spans past RECORDS
_ordinals = {}    # outermost span name -> calls so far
_counters = {}    # name -> int
_on_device = {}   # (name, device) -> int64 scalar tensor


def enable():
    """Turn span recording and the engine's counters on."""
    global _on
    _on = True


def disable():
    """Turn them off again; what was recorded stays until :func:`reset`."""
    global _on
    _on = False


def enabled():
    return _on


def reset():
    """Forget every span, record and counter, the launch counters too."""
    global _dropped
    with _lock:
        _stats.clear()
        _records.clear()
        _dropped = 0
        _ordinals.clear()
        _counters.clear()
        _on_device.clear()


def span(name):
    """A context manager timing *name* (one of :data:`SPANS`) while
    tracing is on; the shared null context while it is off."""
    if not _on:
        return _OFF
    if name not in SPANS:
        raise KeyError(f"{name!r} is not in tracing.SPANS")
    return _Span(name)


class _Span:
    __slots__ = ("name", "parent", "batch", "start", "_annotation")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent = stack[-1].name
            self.batch = stack[-1].batch
        else:
            self.parent = None
            with _lock:
                self.batch = _ordinals.get(self.name, 0)
                _ordinals[self.name] = self.batch + 1
        stack.append(self)
        self._annotation = None
        if torch.autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _record(self.name, self.start, end, self.parent, self.batch)
        return False


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _record(name, start, end, parent, batch):
    global _dropped
    took = end - start
    with _lock:
        agg = _stats.get(name)
        if agg is None:
            _stats[name] = [1, took, took]
        else:
            agg[0] += 1
            agg[1] += took
            agg[2] = max(agg[2], took)
        if len(_records) < RECORDS:
            _records.append((name, start, end, parent, batch,
                             threading.current_thread().name))
        else:
            _dropped += 1


def count(name, n=1):
    """Add *n* to the counter *name*."""
    _counters[name] = _counters.get(name, 0) + n


def counter(name):
    """The counter *name* (0 until counted); device sums not included."""
    return _counters.get(name, 0)


def launches():
    """{kernel: launches} of every kernel in :data:`KERNELS`."""
    return {kernel: _counters.get(f"launches.{kernel}", 0)
            for kernel in KERNELS}


def count_on_device(name, values):
    """Add the sum of the integer tensor *values* to the counter *name*,
    in an int64 scalar on *values*' device: no host sync."""
    key = (name, values.device)
    total = values.sum(dtype=torch.int64)
    held = _on_device.get(key)
    if held is None:
        _on_device[key] = total
    else:
        held += total


def collect():
    """Spans and counters as plain data (the device sums read here, once):
    ``{"clock", "spans": {name: {"count", "total_s", "max_s"}},
    "records": [{"name", "start_ns", "end_ns", "parent", "batch",
    "thread"}], "dropped", "counters": {name: int}}``."""
    with _lock:
        stats = {name: {"count": c, "total_s": total / 1e9,
                        "max_s": most / 1e9}
                 for name, (c, total, most) in _stats.items()}
        records = [{"name": r[0], "start_ns": r[1], "end_ns": r[2],
                    "parent": r[3], "batch": r[4], "thread": r[5]}
                   for r in _records]
        dropped = _dropped
        counters = dict(_counters)
        held = list(_on_device.items())
    for (name, _device), total in held:
        counters[name] = counters.get(name, 0) + int(total)
    return {"clock": "unix_ns", "spans": stats, "records": records,
            "dropped": dropped, "counters": counters}
