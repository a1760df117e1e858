"""The feed loop of ``chip_smoke.py`` phase 5 for one checkout, read so
that two checkouts compare under one clock (as ``timer_ab.py`` does for
single kernels).

``FilteredCounter`` (K1 -> K2) feeds 16 batches of 32,768 synthetic
152 bp reads (4 Mbp genome, 40x, 0.3 % error, seed 0: phase 5's recipe)
against tables of 4,096 and 262,144 keys, half drawn from the batches'
distinct keys and half random, with the counts checked against the
plain path.  For each table: one warm-up feed, then REPS timed feeds
(reads/s) with the host's milliseconds a batch in the engine's two
steps (``upload``: ``staging.Stage.put``, the copy into the pinned ring;
``launch``: ``engine._StepGraphs.run``, the batch's kernels enqueued,
eagerly or as one CUDA graph's replay), then one feed under
``torch.profiler``:
device milliseconds a batch of each op (the HtoD copies among them),
device busy time, and the idle share of the profiled wall::

    python kmer_denovo_filter_tpu_torch/experiments/feed_ab.py \\
        [--root CHECKOUT] [--tag NAME]

Run it as a file: *CHECKOUT* (default: the one that holds this file) goes
first on ``sys.path`` and its package is imported.  Prints a line per
table and reading, then one JSON line."""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
B, L, K, BATCHES, REPS = 32768, 152, 31, 16, 4
TABLE_MS = (4096, 262144)
GENOME_BASES = 4 << 20


def load_timer_ab():
    """``timer_ab.py`` beside this file (its read recipe), by path."""
    spec = importlib.util.spec_from_file_location(
        "kdf_feed_ab_timer", os.path.join(HERE, "timer_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def short_name(name):
    """A device op's name without its return type and argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.removeprefix("void ").strip()


def profile_feed(feed, n_batches):
    """(device ms a batch per op, device busy ms, profiled wall ms) of one
    call of *feed* under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        feed()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    per_op, busy_us, end = {}, 0.0, float("-inf")
    for lo, hi, name in sorted((e.time_range.start, e.time_range.end, e.name)
                               for e in prof.events()
                               if e.device_type == DeviceType.CUDA):
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        per_op[name] = per_op.get(name, 0.0) + (hi - lo)
    return ({short_name(name): us / 1e3 / n_batches
             for name, us in per_op.items()}, busy_us / 1e3, wall_ms)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="feed_ab")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("feed_ab: needs a CUDA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from kmer_denovo_filter_tpu_torch import engine as eng
    from kmer_denovo_filter_tpu_torch import staging
    from kmer_denovo_filter_tpu_torch.ops import device as dev
    from kmer_denovo_filter_tpu_torch.ops import keys as keys64
    print(f"feed_ab {args.tag}: package {os.path.dirname(eng.__file__)}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    cuda = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, GENOME_BASES, dtype=np.uint8)
    synth = load_timer_ab().synth_reads
    batches = [synth(rng, genome, B, L) for _ in range(BATCHES)]
    lens = np.full(B, L, np.int32)
    lens_t = torch.from_numpy(lens).to(cuda)
    seen = torch.unique(torch.cat([
        dev.extract_canonical_windows(torch.from_numpy(c).to(cuda), lens_t,
                                      K)[0].reshape(-1).unique()
        for c in batches]))
    seen = seen[seen != keys64.SENTINEL]

    host_ms = {"upload": 0.0, "launch": 0.0}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            host_ms[name] += (time.perf_counter() - t) * 1e3
            return out
        return wrapper

    staging.Stage.put = timed("upload", staging.Stage.put)
    eng._StepGraphs.run = timed("launch", eng._StepGraphs.run)
    gen = torch.Generator(device=cuda).manual_seed(1)
    rows = []
    for m in TABLE_MS:
        pick = seen[torch.randperm(seen.numel(), generator=gen,
                                   device=cuda)[:m // 2]]
        rand = torch.randint(0, 4 ** K, (2 * m,), generator=gen, device=cuda)
        rand = torch.unique(rand[~torch.isin(rand, pick)])
        rand = rand[torch.randperm(rand.numel(), generator=gen,
                                   device=cuda)[:m - pick.numel()]]
        table = torch.sort(torch.cat([pick, rand])).values
        index = eng.KmerIndex(keys64.keys64_to_words(table, K), K,
                              device=cuda)

        def feed():
            fc = eng.FilteredCounter(index)
            for c in batches:
                fc.feed(c, lens)
            torch.cuda.synchronize()
            return fc

        want = dev.small_table_tally(
            index.table, torch.cat([dev.extract_canonical_windows(
                torch.from_numpy(c).to(cuda), lens_t, K)[0].reshape(-1)
                for c in batches]))
        if not torch.equal(feed().acc, want):
            sys.exit(f"feed_ab: the feed at M={m} differs from plain")
        for _ in range(REPS):
            for name in host_ms:
                host_ms[name] = 0.0
            torch.cuda.synchronize()
            t = time.perf_counter()
            feed()
            rate = BATCHES * B / (time.perf_counter() - t)
            host = {name: ms / BATCHES for name, ms in host_ms.items()}
            rows.append({"m": m, "reads_per_s": rate, "host_ms": host})
            print(f"{args.tag:8s} M={m:<7d} feed {rate:.1f} reads/s; host ms "
                  f"a batch: upload {host['upload']:.4f}, launch "
                  f"{host['launch']:.4f}", flush=True)
        ops, busy_ms, wall_ms = profile_feed(feed, BATCHES)
        rows.append({"m": m, "profile_ms_per_batch": ops,
                     "busy_ms": busy_ms, "wall_ms": wall_ms})
        print(f"{args.tag:8s} M={m:<7d} profiled: busy {busy_ms:.3f} ms of "
              f"{wall_ms:.3f} ms, idle {1 - busy_ms / wall_ms:.4f}; ms a "
              "batch: " + "; ".join(f"{n} {v:.4f}"
                                    for n, v in sorted(ops.items())),
              flush=True)
        del index, table
    print(json.dumps({"feed_ab": args.tag, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
