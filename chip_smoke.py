#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kmer_denovo_filter_tpu_torch`` on the card, phase by phase;
any failure exits non-zero before the result line:

1. Card: ``nvidia-smi`` name and power limit, torch's device name.
2. Build: nvcc builds the kernels from ``kmer_denovo_filter_tpu_torch/csrc``.
3. Kernels: K1 (extract_canonical) and K2 (probe_tally) against their
   plain PyTorch versions on the same card, exact equality, at
   k in {15, 17, 21, 31} on 32,768 random reads x 152 bp with N bases
   and ragged lengths; K2 at M in {1, 4,096, 262,144} table keys, half
   of them drawn from the batch.  Times by CUDA events.
4. Main path: ``kmer-denovo-torch`` (``cli.vcf_main``) on the GIAB mini
   trio in ``tests/data/giab``; the three VCF-mode outputs must equal
   ``tests/goldens`` byte for byte, and both kernels must have been
   launched during that run.
5. Scale: ``FilteredCounter`` on cuda over 16 batches x 32,768 reads x
   152 bp (synthetic 40x-coverage reads, 0.3 % error, seed 0) against
   4,096- and 262,144-key tables; counts must equal the plain path on
   the same card.  Reads/s for both.
6. Profile: the phase-5 feed loop once more under ``torch.profiler``;
   device busy time (union of kernel and copy spans), each device op's
   ms per batch, and the device's idle share against the loop's wall
   time with and without the profiler.

The line before the last is ``{"kernels": [...]}`` with each kernel's
launches in phase 4, its largest deviation from the plain version and
its time beside the plain version's; the last line is
``{"ok": true, "device": {...}}``.
"""

import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.abspath(__file__))
B, L = 32768, 152
KS = (15, 17, 21, 31)
TABLE_MS = (1, 4096, 262144)
SCALE_BATCHES = 16
SCALE_TABLE_MS = (4096, 262144)
COVERAGE = 40
ERROR_RATE = 0.003
GENOME_BASES = 4 << 20


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device milliseconds of *fn* over *reps* launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, ref):
    if torch.equal(got, ref):
        return 0
    return float((got.double() - ref.double()).abs().max())


def random_batch(rng):
    """Random codes with ~0.5 % N, 10 % ragged rows, some shorter than k."""
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.005] = 4
    lengths = np.full(B, L, np.int32)
    ragged = rng.random(B) < 0.1
    lengths[ragged] = rng.integers(0, L + 1, int(ragged.sum()))
    return codes, lengths


def make_table(rng, batch_keys, m, k, sentinel, device):
    """Sorted unique (m,) int64 table: half batch keys, half random."""
    live = torch.unique(batch_keys[batch_keys != sentinel])
    pick = torch.from_numpy(rng.permutation(live.numel())[:max(1, m // 2)])
    from_batch = live[pick.to(device)]
    n_rand = m - from_batch.numel()
    rand = torch.from_numpy(
        rng.integers(0, 4 ** k, 2 * n_rand + 16, dtype=np.int64)).to(device)
    rand = torch.unique(rand[~torch.isin(rand, from_batch)])
    rand = rand[torch.from_numpy(rng.permutation(rand.numel())[:n_rand])
                .to(device)]
    table = torch.sort(torch.cat([from_batch, rand])).values
    if table.numel() != m or torch.unique(table).numel() != m:
        fail(f"table construction gave {table.numel()} keys, wanted {m}")
    return table


def synth_reads(rng, genome, n_reads, read_len):
    """Position-local reads with 0.3 % error, like a sorted WGS BAM
    (the recipe of bench.py:synth_reads)."""
    span = max(n_reads * read_len // COVERAGE, read_len * 4)
    start0 = rng.integers(0, len(genome) - span - read_len)
    starts = np.sort(rng.integers(start0, start0 + span, n_reads))
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    err = rng.random((n_reads, read_len)) < ERROR_RATE
    return np.where(err, (reads + rng.integers(
        1, 4, (n_reads, read_len))) % 4, reads).astype(np.uint8)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA GPU")
    from kmer_denovo_filter_tpu_torch import cli, engine as eng
    from kmer_denovo_filter_tpu_torch.ops import _cuda, extract, probe
    from kmer_denovo_filter_tpu_torch.ops import device as dev
    from kmer_denovo_filter_tpu_torch.ops import keys as keys64

    cuda = torch.device("cuda", 0)
    sentinel = keys64.SENTINEL

    # ── 1. card ────────────────────────────────────────────────────
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ── 2. build ───────────────────────────────────────────────────
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.lib()
    print(f"[2] built {lib_path} in {time.perf_counter() - t0:.3f} s",
          flush=True)
    with open(os.path.join(os.path.dirname(lib_path), "build.log")) as fh:
        for line in fh:
            if "ptxas info" in line:
                print("    " + line.strip())

    # ── 3. kernels against their plain versions ────────────────────
    rng = np.random.default_rng(0)
    codes_np, lengths_np = random_batch(rng)
    codes = torch.from_numpy(codes_np).to(cuda)
    lengths = torch.from_numpy(lengths_np).to(cuda)
    err = {"extract_canonical": 0.0, "probe_tally": 0.0}
    times = {}
    for k in KS:
        got = extract.extract_canonical(codes, lengths, k)
        ref = dev.extract_canonical_windows(codes, lengths, k)[0]
        torch.cuda.synchronize()
        e = max_abs_err(got, ref)
        err["extract_canonical"] = max(err["extract_canonical"], e)
        if e:
            fail(f"K1 extract_canonical differs from plain at k={k}")
        ms = cuda_ms(lambda: extract.extract_canonical(codes, lengths, k))
        plain_ms = cuda_ms(
            lambda: dev.extract_canonical_windows(codes, lengths, k))
        times[("extract_canonical", k)] = (ms, plain_ms)
        live = int((got != sentinel).sum())
        print(f"[3] K1 k={k}: equal ({got.numel()} windows, {live} live); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        flat = got.reshape(-1)
        for m in TABLE_MS:
            table = make_table(rng, flat, m, k, sentinel, cuda)
            acc = torch.zeros(m, dtype=torch.int64, device=cuda)
            probe.probe_tally(flat, table, acc)
            ref = dev.small_table_tally(table, flat)
            torch.cuda.synchronize()
            e = max_abs_err(acc, ref)
            err["probe_tally"] = max(err["probe_tally"], e)
            if e:
                fail(f"K2 probe_tally differs from plain at k={k}, M={m}")
            ms = cuda_ms(lambda: probe.probe_tally(flat, table, acc))
            plain_ms = cuda_ms(
                lambda: acc.add_(dev.small_table_tally(table, flat)))
            times[("probe_tally", k, m)] = (ms, plain_ms)
            print(f"[3] K2 k={k} M={m}: equal ({int(ref.sum())} hits); "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)

    # ── 4. main path: kmer-denovo-torch on the GIAB mini trio ──────
    giab = os.path.join(REPO, "tests", "data", "giab")
    goldens = os.path.join(REPO, "tests", "goldens")
    out = tempfile.mkdtemp(prefix="kdf_chip_smoke_")
    try:
        argv = [
            "--child", os.path.join(giab, "HG002_child.bam"),
            "--mother", os.path.join(giab, "HG004_mother.bam"),
            "--father", os.path.join(giab, "HG003_father.bam"),
            "--vcf", os.path.join(giab, "candidates.vcf.gz"),
            "--output", os.path.join(out, "annotated.vcf.gz"),
            "--metrics", os.path.join(out, "metrics.json"),
            "--summary", os.path.join(out, "summary.txt"),
            "--proband-id", "HG002",
        ]
        extract.launches = 0
        probe.launches = 0
        t0 = time.perf_counter()
        cli.vcf_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"extract_canonical": extract.launches,
                    "probe_tally": probe.launches}
        with gzip.open(os.path.join(out, "annotated.vcf.gz")) as fh:
            got_vcf = fh.read()
        with gzip.open(os.path.join(goldens, "annotated.vcf.gz")) as fh:
            if got_vcf != fh.read():
                fail("annotated.vcf.gz differs from tests/goldens")
        for name in ("metrics.json", "summary.txt"):
            with open(os.path.join(out, name)) as a, \
                    open(os.path.join(goldens, name)) as b:
                if a.read() != b.read():
                    fail(f"{name} differs from tests/goldens")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    print(f"[4] kmer-denovo-torch: 3 goldens byte-equal in {wall:.3f} s; "
          f"launches {launches}", flush=True)

    # ── 5. scale: FilteredCounter on cuda vs the plain path ────────
    k = 31
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, GENOME_BASES, dtype=np.uint8)
    batches = [synth_reads(rng, genome, B, L)
               for _ in range(SCALE_BATCHES)]
    lens = np.full(B, L, np.int32)
    seen = torch.unique(torch.cat([
        extract.extract_canonical(torch.from_numpy(c).to(cuda),
                                  torch.from_numpy(lens).to(cuda),
                                  k).reshape(-1).unique()
        for c in batches]))
    n_reads = SCALE_BATCHES * B

    def run_kernel_path(index):
        fc = eng.FilteredCounter(index)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for c in batches:
            fc.feed(c, lens)
        res = fc.result()
        return res, n_reads / (time.perf_counter() - t)

    def run_plain_path(index):
        acc = torch.zeros(index.n, dtype=torch.int64, device=cuda)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for c in batches:
            dev.small_tally_step(
                index.table, acc, torch.from_numpy(c).to(cuda),
                torch.from_numpy(lens).to(cuda), k)
        res = acc.cpu().numpy()
        return res, n_reads / (time.perf_counter() - t)

    for m in SCALE_TABLE_MS:
        table = make_table(rng, seen, m, k, sentinel, cuda)
        index = eng.KmerIndex(keys64.keys64_to_words(table, k), k,
                              device=cuda)
        if not torch.equal(index.table, table):
            fail("KmerIndex table does not round-trip the int64 keys")
        run_kernel_path(index)  # warm-up
        run_plain_path(index)
        p1, plain_a = run_plain_path(index)
        r1, kern_a = run_kernel_path(index)
        r2, kern_b = run_kernel_path(index)
        p2, plain_b = run_plain_path(index)
        for other in (r2, p1, p2):
            if not np.array_equal(r1, other):
                fail(f"scale M={m}: FilteredCounter differs from plain")
        print(f"[5] scale M={m}: {n_reads} reads x {L} bp, "
              f"{int(r1.sum())} hits, equal to plain; reads/s kernel "
              f"{kern_a:.1f} / {kern_b:.1f}, plain {plain_a:.1f} / "
              f"{plain_b:.1f} ({card})", flush=True)

        # ── 6. profile of the same feed loop ───────────────────────
        wall_plain = n_reads / max(kern_a, kern_b)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fc = eng.FilteredCounter(index)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for c in batches:
                fc.feed(c, lens)
            fc.result()
            wall_prof = time.perf_counter() - t
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if not spans:
            print(f"[6] profile M={m}: the profiler recorded no device "
                  "events; device busy time not measured", flush=True)
            continue
        busy_us, end = 0.0, float("-inf")
        per_op = {}
        for lo, hi, name in spans:
            busy_us += max(0.0, hi - max(lo, end))
            end = max(end, hi)
            per_op[name] = per_op.get(name, 0.0) + (hi - lo)
        busy = busy_us / 1e6
        ops = "; ".join(f"{name} {us / 1e3 / SCALE_BATCHES:.4f}"
                        for name, us in sorted(per_op.items()))
        print(f"[6] profile M={m}: device busy {busy * 1e3:.3f} ms; loop "
              f"wall {wall_prof * 1e3:.3f} ms profiled, "
              f"{wall_plain * 1e3:.3f} ms unprofiled (phase 5); idle share "
              f"{1 - busy / wall_prof:.4f} profiled, "
              f"{1 - busy / wall_plain:.4f} against the unprofiled wall; "
              f"device ms per batch: {ops} ({card})", flush=True)

    if "jax" in sys.modules:
        fail("jax was imported")

    k1_ms, k1_plain = times[("extract_canonical", 31)]
    k2_ms, k2_plain = times[("probe_tally", 31, 4096)]
    report = {"kernels": [
        {"name": "extract_canonical", "route": "cuda",
         "source": "kmer_denovo_filter_tpu_torch/csrc/extract_canonical.cu",
         "replaces": "kmer_denovo_filter_tpu/ops/pallas_extract.py:54",
         "launches": launches["extract_canonical"],
         "max_abs_err": err["extract_canonical"],
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "probe_tally", "route": "cuda",
         "source": "kmer_denovo_filter_tpu_torch/csrc/probe_tally.cu",
         "replaces": "kmer_denovo_filter_tpu/ops/pallas_probe.py:99",
         "launches": launches["probe_tally"],
         "max_abs_err": err["probe_tally"],
         "ms": k2_ms, "plain_ms": k2_plain},
    ]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
