"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (the drive's inputs made from the seed, its warm-up and its
build) is timed as ``setup_s``; the window then runs for ``--seconds``;
the program's state is freed and the drive's plain reference checks what
the window produced.  With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from
the benchmark's spans and a ``torch.profiler`` timeline of the window.
Without as many CUDA devices as the cell asks for, the run prints no
result and exits with 2; it never falls back to the CPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

from portbench import spec
from portbench import trace as tr

# top-level module names the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "kmer_denovo_filter_tpu")
PEAKS = os.path.join(spec.HERE, "peaks.json")


def log(msg):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"not read ({err})"
    return out.stdout.strip() or f"not read ({out.stderr.strip()})"


def peaks_of(kind):
    with open(PEAKS) as fh:
        return json.load(fh).get(kind)


def run_cell(bench, cell, cfg, traffic, seed, seconds, traced, device, t0):
    """Run *cell* once on *device*; returns the result line's dict."""
    import torch
    device = torch.device(device)
    on_card = device.type == "cuda"
    spans = tr.Spans(traced and on_card)
    drive = spec.drive(traffic["drive"])
    run = drive.make(cfg, traffic, seed, device, spans, log)
    run.setup()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s} s; window of {seconds} s")
    prof = None
    if spans.traced:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            window = run.window(seconds)
    else:
        window = run.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run.release()
    checks, work = run.check()
    correct = all(value <= limit for value, limit in checks.values())
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": window["attempted"],
           "failed": window["failed"], "metrics": {}, "device": dev}
    if traced:
        summary = None
        if prof is not None:
            t = time.perf_counter()
            device_ops, host, kinds = tr.timeline(prof, set(spans.seconds))
            summary = tr.summarize(device_ops, host)
            log(f"trace read in {time.perf_counter() - t} s; its events "
                f"by kind: {kinds}")
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
            out["breakdown"] = {"device_ops": summary["device_ops"],
                                "idle_gaps": summary["idle_gaps"]}
        state = {"spans": spans.seconds, "trace": summary, "work": work,
                 "peaks": peaks_of(kind)}
        for m in spec.cell_metrics(bench, cell["name"], "per_layer"):
            value = spec.metric_reader(m["name"]).read(state)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(window["metrics"], setup_s=setup_s)
        for m in spec.cell_metrics(bench, cell["name"], "end_to_end"):
            if m["name"] not in e2e:
                raise RuntimeError(f"the drive gave no {m['name']}")
            out["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, (value, limit) in checks.items()}
    return out


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0):
    args = parse(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s), this "
            f"host has {have}: no result")
        return 2
    torch.set_num_threads(1)
    out = run_cell(bench, cell, cfg, traffic, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), t0)
    # read once the window has closed, so set-up does not pay for it
    log(f"card: {power_limit()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    found = forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: no result")
        return 3
    for name, check in out["checks"].items():
        log(f"check {name}: {check['value']} (limit {check['limit']})")
    print(json.dumps(out), flush=True)
    return 0
