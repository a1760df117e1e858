"""The program's own spans and counters over a cell's windows.

    python3 -m portbench.program_spans --workload <name> --seed <n> --seconds <s> --rounds <r>

The program (``kmer_denovo_filter_tpu_torch``) keeps spans and counters
inside its calls (its module ``tracing``); a benchmark run
(:mod:`portbench.run`) reads only its own spans around those calls and
the device's timeline.  This command makes the cell's inputs from the
seed and sets the drive up with the program's tracing on (so set-up's
spans are kept), then runs *r* rounds of three windows of *s* seconds
each, each window on a fresh accumulator over the same table:

* ``off``: the program's tracing off, as a benchmark run has it;
* ``on``: tracing on, no profiler;
* ``profiled``: tracing on under ``torch.profiler``, read by
  :func:`summarize`.

Each window prints one JSON line: ``scan_reads_per_s``, the program's
spans and counters (:func:`readings`) and, profiled, the breakdown.  The
drive's plain reference checks the last window.  Without a CUDA device
the command exits with 2.  The benchmark's own runs never run this.

:func:`summarize` is :func:`portbench.trace.summarize` with two things
more: each idle gap is named by the innermost span open at its start,
the program's spans included, and each span's share of the window's
idle time is given.  On a timeline of the benchmark's spans alone, which
never nest inside ``window``, its readings are
:func:`~portbench.trace.summarize`'s.
"""

import argparse
import heapq
import json
import sys
import time
from collections import defaultdict

from portbench import spec
from portbench import trace as tr
from portbench.run import log, power_limit

MODES = ("off", "on", "profiled")
# the names of PyTorch's own kernels: on the filter's path only the
# program's device counters (their sums and adds) launch any
TORCH_KERNEL = "at::native::"


def _idle(busy, w_lo, w_hi):
    """The window's idle intervals: what *busy* (merged, sorted) leaves."""
    out, edge = [], w_lo
    for lo, hi in busy + [[w_hi, w_hi]]:
        if lo > edge:
            out.append((edge, min(lo, w_hi)))
        edge = max(edge, hi)
    return out


def _innermost(points, spans):
    """For each of the sorted *points*, the name of the latest-started
    span of *spans* [(lo, hi, name)] open there, or None."""
    spans = sorted(spans)
    out, heap, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            lo, hi, name = spans[i]
            heapq.heappush(heap, (-lo, hi, name))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def _overlap(intervals, spans):
    """Length of the sorted disjoint *intervals* that the union of
    *spans* [(lo, hi)] covers."""
    covered, j = 0.0, 0
    union = tr.merge(spans)
    for lo, hi in intervals:
        while j < len(union) and union[j][1] <= lo:
            j += 1
        k = j
        while k < len(union) and union[k][0] < hi:
            covered += min(hi, union[k][1]) - max(lo, union[k][0])
            k += 1
    return covered


def summarize(device_ops, host_spans, top=10):
    """:func:`portbench.trace.summarize` of the same timeline, its idle
    gaps named by the innermost span open at their start (``loop`` where
    only the window is), plus ``idle_s``, ``idle_in`` {span name: % of the
    idle time inside that name's spans} and ``kernels`` {kernel name:
    seconds}; None where that gives None."""
    out = tr.summarize(device_ops, host_spans, top)
    if out is None:
        return None
    w_lo, w_hi = next((lo, hi) for name, lo, hi in host_spans
                      if name == tr.WINDOW)
    inside = [(kind, name, max(lo, w_lo), min(hi, w_hi))
              for kind, name, lo, hi in device_ops
              if kind in tr.DEVICE_WORK and hi > w_lo and lo < w_hi]
    idle = _idle(tr.merge((lo, hi) for _, _, lo, hi in inside), w_lo, w_hi)
    named = [(lo, hi, name) for name, lo, hi in host_spans
             if name != tr.WINDOW and hi > w_lo and lo < w_hi]
    names = _innermost([lo for lo, _ in idle], named)
    gaps = sorted(((name or "loop", (hi - lo) / 1e6)
                   for (lo, hi), name in zip(idle, names)),
                  key=lambda g: -g[1])
    out["idle_gaps"] = [[name, s] for name, s in gaps[:top]]
    idle_us = sum(hi - lo for lo, hi in idle)
    out["idle_s"] = idle_us / 1e6
    by_name = defaultdict(list)
    for lo, hi, name in named:
        by_name[name].append((lo, hi))
    out["idle_in"] = {name: (_overlap(idle, spans) / idle_us * 100
                             if idle_us else 0.0)
                      for name, spans in sorted(by_name.items())}
    kernels = defaultdict(float)
    for kind, name, lo, hi in inside:
        if kind == tr.KERNEL:
            kernels[name] += (hi - lo) / 1e6
    out["kernels"] = dict(kernels)
    return out


def readings(setup, window, summary):
    """The program's readings of one window, from ``tracing.collect()``
    of set-up (*setup*) and of the window (*window*) and the window's
    :func:`summarize` (*summary*, or None): each None where its source
    has nothing.

    * ``htod_host_ms``: the mean ``filter.feed.htod`` a batch, ms;
    * ``launch_host_ms``: ``filter.feed.extract`` + ``.dedup`` +
      ``.tally`` a batch, ms: the host's enqueue of the three kernels;
    * ``idle_in_htod_share``: % of the device's idle time inside
      ``filter.feed.htod``;
    * ``dedup_keep_share``: ``filter.distinct_keys`` over
      ``filter.windows``, %: what K9d leaves K3 to probe;
    * ``build_upload_ms``: the last ``index.upload`` of set-up (the
      counter's build, after the warm-up's), ms."""
    spans = window["spans"] if window else {}
    counters = window["counters"] if window else {}
    batches = spans.get("filter.feed", {}).get("count", 0)
    out = {}
    htod = spans.get("filter.feed.htod")
    out["htod_host_ms"] = (htod["total_s"] / batches * 1e3
                           if htod and batches else None)
    launch = [spans.get(f"filter.feed.{part}")
              for part in ("extract", "dedup", "tally")]
    out["launch_host_ms"] = (sum(s["total_s"] for s in launch) / batches
                             * 1e3 if all(launch) and batches else None)
    idle_in = (summary or {}).get("idle_in", {})
    out["idle_in_htod_share"] = idle_in.get("filter.feed.htod")
    windows = counters.get("filter.windows")
    distinct = counters.get("filter.distinct_keys")
    out["dedup_keep_share"] = (distinct / windows * 100
                               if windows and distinct is not None else None)
    uploads = [r for r in (setup or {}).get("records", [])
               if r["name"] == "index.upload"]
    out["build_upload_ms"] = ((uploads[-1]["end_ns"]
                               - uploads[-1]["start_ns"]) / 1e6
                              if uploads else None)
    return out


def counter_kernel_share(summary):
    """% of the window's kernel time in PyTorch's own kernels, which on
    the filter's path only the program's device counters launch."""
    if not summary or summary["kernel_s"] <= 0:
        return None
    ours = sum(s for name, s in summary["kernels"].items()
               if TORCH_KERNEL in name)
    return ours / summary["kernel_s"] * 100


def _window(run, mode, seconds, tracing, spans):
    """One window of *mode* on a fresh accumulator; (the drive's window
    dict, the program's collect() or None, the summary or None)."""
    import torch
    from kmer_denovo_filter_tpu_torch import engine
    index = run.counter.index
    run.counter = None
    run.counter = engine.FilteredCounter(index, dedup=True)
    torch.cuda.synchronize()
    tracing.reset()
    if mode != "off":
        tracing.enable()
    # the benchmark's own spans mark the profiler's timeline only when
    # it runs, as in a benchmark run
    spans.traced = mode == "profiled"
    summary = None
    if mode == "profiled":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            window = run.window(seconds)
        names = set(spans.seconds) | set(tracing.SPANS)
        device_ops, host, _kinds = tr.timeline(prof, names)
        summary = summarize(device_ops, host)
    else:
        window = run.window(seconds)
    tracing.disable()
    return window, (tracing.collect() if mode != "off" else None), summary


def main(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.program_spans",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rounds", type=int, default=1)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the program's spans are read on the card")
        return 2
    from kmer_denovo_filter_tpu_torch import tracing
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    spans = tr.Spans(traced=True)
    t0 = time.perf_counter()
    tracing.reset()
    tracing.enable()
    run = spec.drive(traffic["drive"]).make(cfg, traffic, args.seed, device,
                                            spans, log)
    run.setup()
    tracing.disable()
    setup = tracing.collect()
    log(f"set-up {time.perf_counter() - t0} s, traced")
    card = power_limit()
    for r in range(args.rounds):
        for mode in MODES:
            window, got, summary = _window(run, mode, args.seconds, tracing,
                                           spans)
            line = {"workload": args.workload, "seed": args.seed,
                    "round": r, "mode": mode, "card": card,
                    "scan_reads_per_s":
                        window["metrics"]["scan_reads_per_s"],
                    "batches": window["attempted"]}
            if got is not None:
                line["readings"] = readings(setup, got, summary)
                line["spans"] = got["spans"]
                line["counters"] = {k: v for k, v in got["counters"].items()
                                    if not k.startswith("launches.")}
            if summary is not None:
                line["counter_kernel_share"] = counter_kernel_share(summary)
                line["breakdown"] = summary
            print(json.dumps(line), flush=True)
    run.release()
    checks, _work = run.check()
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "setup_spans": setup["spans"],
                      "correct": all(v <= lim for v, lim in checks.values()),
                      "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
