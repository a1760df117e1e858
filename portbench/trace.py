"""Host spans and the device timeline of a traced window.

:class:`Spans` times the benchmark's own spans around calls into the
program (host clock) and, in a traced run, also marks them on the
profiler's timeline (``record_function``).  :func:`timeline` sorts a
``torch.profiler`` trace's events by their kineto activity type, and
:func:`summarize` reads them: the traced window is the span ``window``,
the device is busy where a kernel, copy or fill runs, and each idle gap
is named by the benchmark's span open when it began.  Annotations on the
device's timeline (every ``record_function``, the benchmark's or the
program's) are no device work, whatever their name.
"""

import bisect
import contextlib
import time
from collections import defaultdict

WINDOW = "window"
# kineto activity types of device work: what :func:`timeline` keeps
KERNEL, COPY, FILL = "kernel", "gpu_memcpy", "gpu_memset"
DEVICE_WORK = (KERNEL, COPY, FILL)


class Spans:
    """Durations (seconds, host clock) of named spans, in order."""

    def __init__(self, traced=False):
        self.traced = traced
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name):
        if self.traced:
            import torch
            with torch.profiler.record_function(name):
                start = time.perf_counter()
                yield
                self.seconds[name].append(time.perf_counter() - start)
        else:
            start = time.perf_counter()
            yield
            self.seconds[name].append(time.perf_counter() - start)


def merge(intervals):
    """Sorted (start, end) intervals merged where they overlap."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarize(device_ops, host_spans, top=10):
    """Read a traced window.

    *device_ops*: [(kind, name, start µs, end µs)] of every device
    operation, *kind* one of :data:`DEVICE_WORK`; *host_spans*: [(name,
    start µs, end µs)] of the benchmark's spans, ``window`` among them, on
    the same timeline.  Returns a dict of seconds (``window_s``,
    ``busy_s``, ``kernel_s``: kernels alone, ``htod_s``: copies host to
    device), the device operations that took most time and the longest
    idle gaps, or None when the timeline holds no window or no device
    operation."""
    windows = [(lo, hi) for name, lo, hi in host_spans if name == WINDOW]
    if not windows:
        return None
    w_lo, w_hi = windows[0]
    inside = [(kind, name, max(lo, w_lo), min(hi, w_hi))
              for kind, name, lo, hi in device_ops
              if kind in DEVICE_WORK and hi > w_lo and lo < w_hi]
    if not inside:
        return None
    per_op = defaultdict(float)
    kernel_us = htod_us = 0.0
    for kind, name, lo, hi in inside:
        per_op[name] += hi - lo
        if kind == KERNEL:
            kernel_us += hi - lo
        elif kind == COPY and name.startswith("Memcpy HtoD"):
            htod_us += hi - lo
    busy = merge((lo, hi) for _, _, lo, hi in inside)
    busy_us = sum(hi - lo for lo, hi in busy)
    # idle gaps, each named by the innermost benchmark span open at its
    # start ("loop" where only the window is)
    named = sorted((lo, hi, name) for name, lo, hi in host_spans
                   if name != WINDOW and hi > w_lo and lo < w_hi)
    starts = [lo for lo, _, _ in named]
    gaps = []
    edge = w_lo
    for lo, hi in busy + [[w_hi, w_hi]]:
        if lo > edge:
            i = bisect.bisect_right(starts, edge) - 1
            name = named[i][2] if i >= 0 and named[i][1] > edge else "loop"
            gaps.append((name, (lo - edge) / 1e6))
        edge = max(edge, hi)
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w_hi - w_lo) / 1e6,
            "busy_s": busy_us / 1e6,
            "kernel_s": kernel_us / 1e6,
            "htod_s": htod_us / 1e6,
            "device_ops": [[name, us / 1e6] for name, us in ops],
            "idle_gaps": [[name, s] for name, s in gaps[:top]]}


def timeline(prof, span_names):
    """(device ops, host spans named in *span_names*, events a kind) of a
    finished ``torch.profiler.profile``, as :func:`summarize` takes them,
    read from the profiler's raw events (µs on one clock)."""
    return classify(prof.profiler.kineto_results.events(), span_names)


def kind_of(event):
    """The kineto activity type of *event*: its own where torch's binding
    gives it (``activity_type()``, torch 2.12 on), else worked out from its
    device, its annotation flag and, on the device, its name."""
    if hasattr(event, "activity_type"):
        return event.activity_type()
    from torch.autograd import DeviceType
    on_card = event.device_type() == DeviceType.CUDA
    if event.is_user_annotation():
        return "gpu_user_annotation" if on_card else "user_annotation"
    if not on_card:
        return "host"
    name = event.name()
    if name.startswith("Memcpy"):
        return COPY
    if name.startswith("Memset"):
        return FILL
    return KERNEL


def classify(events, span_names):
    """Sort kineto events (as :func:`kind_of` reads them, with ``name()``,
    ``start_ns()`` and ``duration_ns()``) into device work, by activity
    type, and the host's spans named in *span_names*; also count the
    events of each type."""
    device, host = [], []
    kinds = defaultdict(int)
    for e in events:
        kind, name = kind_of(e), e.name()
        kinds[kind] += 1
        lo = e.start_ns() / 1e3
        hi = lo + e.duration_ns() / 1e3
        if kind in DEVICE_WORK:
            device.append((kind, name, lo, hi))
        elif kind == "user_annotation" and name in span_names:
            host.append((name, lo, hi))
    return device, host, dict(kinds)
