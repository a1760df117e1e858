"""The segmented-sort experiments of ``scripts/x_fused.py``, on the
port's kernels.

    python -m kmer_denovo_filter_tpu_torch.experiments.x_fused \\
        <command> [--device cuda|cpu] [--reps N]

The JAX script asks whether a segment-local dedup in front of the
global sort and the join pays; these commands ask it on the card, where
the port's join (K3) reads the segment dedup's slots with no global
sort:

* ``sort``: K9 (``csrc/seg_sort.cu``, the counterpart of the Pallas
  ``_sort_kernel`` :133) against ``torch.sort(dim=1)`` with the payload
  gathered, on the 488 segments of one 32,768 x 152 bp batch at k = 31.
  Parity as in ``run_sort`` :183: keys equal, and each segment's
  multiset of (key, payload) pairs equal.
* ``prof``: the cumulative-prefix profile of ``run_prof`` :291 on the
  port's segment-form step: K1 / +K9 / +K9d (in place of K9) / +K3 on
  K9d's slots, on the WGS-scale table.
* ``transposed`` and ``unroll2``: the Pallas ``_tally_kernel_wT`` :480
  and ``_tally_kernel_w2`` :389 are two more TPU layouts of the v5
  prototype's weighted tally, so both run the ``x_join_variants v5``
  A/B of the segment form against the engine's two forms.

The script's other commands run no Pallas kernel; on the card:

* ``anatomy`` (``run_kernel_anatomy`` :319, which doctored the TPU
  kernel's metadata to split launch, DMA and compute): K3 on the WGS
  table fed an empty batch (K9d's slots with no live key: the launch
  floor), all-sentinel keys, the batch's keys sorted, the same keys
  shuffled, and K9d's slots; each exact against its plain version.
* ``variants`` (``run_variants`` :704, a sweep of the TPU tile shape)
  and ``steps`` (``run_steps`` :724, of ``w_part``): on the card the
  launch shape is K2/K3/K4's plan (``csrc/sorted_table.cuh``
  ``dir_probe_launch``), swept by a :class:`~ops.directory.Launch`
  override.  ``variants``: K2 and K4 staged against global at 1,024,
  4,096, 6,207 and 10,367 live rows on a random and a 40x batch (the
  staged form refused over its edge); ``steps``: K2 and K3 (on K9d's
  slots) at 128, 256 and 512 threads a block with 1, 2 or 4 blocks an
  SM, at 262,144 rows and on the WGS table.  Every variant exact
  against the plan's launch.
* ``super`` (``run_super`` :757): one K1 -> K9d -> K3 pass over a
  stacked group of 4, 8 and 16 batches (:func:`group_tally`) against
  one pass per batch, and the engine's stacked scan
  (``scan_reads_for_hits_many``, K1 -> K4 once) over 8 and 16 batches
  against ``scan_reads_for_hits`` per batch; exact.
* ``sprof`` (``run_sprof`` :826): the cumulative prefixes of the
  8-batch group pass: K1, + K9d, + K3.
"""

import sys

import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch.experiments import x_join_variants
from kmer_denovo_filter_tpu_torch.experiments._common import (
    K,
    batch_table,
    bound,
    pair_order,
    parity,
    parse_args,
    random_batch,
    read_batch,
    read_group,
    setup,
    timeit,
    wgs_index,
    window_keys,
)
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops import segsort
from kmer_denovo_filter_tpu_torch.ops.directory import (
    Launch,
    build_directory,
    launch_plan,
)
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical
from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL
from kmer_denovo_filter_tpu_torch.ops.member import probe_member
from kmer_denovo_filter_tpu_torch.ops.probe import (
    probe_tally,
    probe_tally_weighted,
)

COMMANDS = ("sort", "prof", "transposed", "unroll2", "anatomy", "variants",
            "steps", "super", "sprof")
V5_LAYOUTS = ("transposed", "unroll2")  # the commands that run v5
PREFIXES = ("K1", "+K9 seg sort", "+K9d (for K9)", "+K3 on the slots")
# variants: live rows about the staged edges (K2 6,207, K4 10,367 on an
# H100)
VARIANT_MS = (1024, 4096, 6207, 10367)
STEPS_M = 262144  # steps' table beside the WGS one
STEP_THREADS = (128, 256, 512)
STEP_BLOCKS_PER_SM = (1, 2, 4)
GROUPS = (4, 8, 16)  # super's stacked groups; nb <= 16: 512 MB of keys
MEMBER_GROUPS = (8, 16)
SPROF_GROUP = 8
SPREFIXES = ("K1", "+K9d", "+K3 on the slots")


def run_sort(args, device, rng, genome):
    codes, lengths = read_batch(rng, genome, args.reads, device)
    flat = extract_canonical(codes, lengths, K).reshape(-1)
    payload = torch.arange(flat.numel(), dtype=torch.int32, device=device)
    segs = segsort.segments(flat, SENTINEL)
    pays = segsort.segments(payload, -1)
    print(f"segments: {tuple(segs.shape)} ({flat.numel()} windows)",
          flush=True)
    keys, pay = segsort.seg_sort(flat, payload)
    ref_keys, ref_pay = dev.segment_sort(segs, pays)
    parity("key", torch.equal(keys, ref_keys))
    got_pairs, ref_pairs = pair_order(keys, pay), pair_order(ref_keys,
                                                             ref_pay)
    parity("pair", all(torch.equal(a, b)
                       for a, b in zip(got_pairs, ref_pairs)))
    ms = timeit("K9 seg sort (key + 1 payload)",
                lambda: segsort.seg_sort(flat, payload), device, args.reps)
    timeit("torch.sort(dim=1) + payload gather",
           lambda: dev.segment_sort(segs, pays), device, args.reps)
    lim = bound(24 * segs.numel(), 91 * segs.numel() // 2)
    print(f"  K9 bound {lim[0]:.4f} ms by {lim[1]} ({lim[0] / ms:.3f} of "
          "the kernel's time)", flush=True)


def run_prof(args, device, rng, genome):
    """Cumulative prefixes of the segment-form step on one batch; only
    differences inside one run attribute cost."""
    index = wgs_index(args.table_m, device)
    table, directory = index.table, index.directory
    acc = torch.zeros(table.shape[0], dtype=torch.int64, device=device)
    codes, lengths = read_batch(rng, genome, args.reads, device)
    print(f"prof: table M={table.shape[0]}, {args.reads} reads", flush=True)

    def step(stage, acc):
        """The step cut after prefix *stage* (3: the whole step)."""
        flat = extract_canonical(codes, lengths, K).reshape(-1)
        if stage == 1:
            segsort.seg_sort(flat)
        if stage < 2:
            return
        keys, weights, counts = segsort.seg_dedup(flat)
        if stage == 3:
            probe_tally_weighted(keys, weights, table, acc, directory,
                                 counts)

    got = torch.zeros_like(acc)
    step(3, got)
    ref = torch.zeros_like(acc)
    probe_tally(extract_canonical(codes, lengths, K).reshape(-1), table, ref,
                directory)
    parity("segment-form step vs K1 -> K2", torch.equal(got, ref))
    del got, ref
    prev = None
    for stage, name in enumerate(PREFIXES):
        ms = timeit(f"prefix {stage} {name}",
                    lambda stage=stage: step(stage, acc), device, args.reps)
        if prev is not None:
            print(f"    marginal {ms - prev:+10.4f} ms", flush=True)
        prev = ms


def run_layout_of_v5(name, kernel, args, device, rng, genome):
    """10b and 10c: TPU layouts of the weighted tally 9c; run v5."""
    print(f"{name}: the Pallas {kernel} computes the weighted tally of the "
          "segment-deduped stream (x_join_variants._tally_kernel_w, 9c) "
          "in another TPU layout; on the card that is K3 behind K9d: "
          "running x_join_variants v5", flush=True)
    return x_join_variants.run_v5(args, device, rng, genome)


def _plain_weighted(table, keys, weights, counts):
    """The plain version of K3: flat keys, or slots with *counts*."""
    if counts is not None:
        keys, weights = dev.segment_compact(keys, weights, counts)
    acc = torch.zeros(table.shape[0], dtype=torch.int64, device=table.device)
    return dev.weighted_tally(table, keys, weights, acc)


def run_anatomy(args, device, rng, genome):
    """What K3 costs at each stage: the launch floor, reading keys that
    search nothing, sorted and shuffled keys, K9d's slots."""
    index = wgs_index(args.table_m, device)
    table, directory = index.table, index.directory
    codes, lengths = read_batch(rng, genome, args.reads, device)
    flat = window_keys(codes, lengths)
    ones = torch.ones_like(flat)
    slots = segsort.seg_dedup(flat)
    shuffled = flat[torch.from_numpy(rng.permutation(flat.numel()))
                    .to(device)]
    cases = {
        "empty batch (no live slot: launch floor)":
            (slots[0], slots[1], torch.zeros_like(slots[2])),
        "all-sentinel keys": (torch.full_like(flat, SENTINEL), ones, None),
        "sorted keys": (torch.sort(flat).values, ones, None),
        "random keys (the same, shuffled)": (shuffled, ones, None),
        "K9d's slots": slots,
    }
    print(f"anatomy: table M={table.shape[0]}, {flat.numel()} windows, "
          f"{int(slots[2].sum())} live slots", flush=True)
    acc = torch.zeros(table.shape[0], dtype=torch.int64, device=device)
    for name, (keys, weights, counts) in cases.items():
        acc.zero_()
        probe_tally_weighted(keys, weights, table, acc, directory, counts)
        parity(f"K3 on {name}", torch.equal(
            acc, _plain_weighted(table, keys, weights, counts)))
    for name, (keys, weights, counts) in cases.items():
        timeit(f"K3 {name}", lambda keys=keys, weights=weights,
               counts=counts: probe_tally_weighted(
                   keys, weights, table, acc, directory, counts),
               device, args.reps)


def _probe(kernel, flat, table, directory, launch=None):
    """K2's accumulator or K4's found bits under *launch*."""
    if kernel == "K4":
        return probe_member(flat, table, directory, launch)
    acc = torch.zeros(table.shape[0], dtype=torch.int64, device=flat.device)
    return probe_tally(flat, table, acc, directory, launch)


def run_variants(args, device, rng, genome):
    """K2 and K4 staged against global about the staged edges, on a
    random and a 40x batch; the staged form refused over its edge."""
    batches = {"random": random_batch(rng, args.reads, device),
               "40x": read_batch(rng, genome, args.reads, device)}
    for label, (codes, lengths) in batches.items():
        flat = window_keys(codes, lengths)
        for m in VARIANT_MS:
            table = batch_table(rng, flat, m, device)
            directory = build_directory(table)
            print(f"variants [{label} batch] M={m}: {flat.numel()} windows",
                  flush=True)
            for kernel in ("K2", "K4"):
                ref = _probe(kernel, flat, table, directory)
                for form in ("staged", "global"):
                    launch = Launch(form)
                    if device.type == "cuda":
                        with torch.cuda.device(device):
                            fits = launch_plan(flat.numel(), directory.live,
                                               directory.bits,
                                               kernel == "K2").staged
                        if form == "staged" and not fits:
                            try:
                                _probe(kernel, flat, table, directory, launch)
                                refused = False
                            except ValueError:
                                refused = True
                            parity(f"{kernel} staged refused over its edge "
                                   f"at M={m}", refused)
                            continue
                    parity(f"{kernel} {form} M={m} [{label}]", torch.equal(
                        _probe(kernel, flat, table, directory, launch), ref))
                    timeit(f"{kernel} {form} M={m} [{label}]",
                           lambda kernel=kernel, launch=launch: _probe(
                               kernel, flat, table, directory, launch),
                           device, args.reps)


def run_steps(args, device, rng, genome):
    """K2 (flat windows) and K3 (K9d's slots) at each block size and cap
    on the blocks an SM, at 262,144 rows and on the WGS table."""
    codes, lengths = read_batch(rng, genome, args.reads, device)
    flat = window_keys(codes, lengths)
    slots = segsort.seg_dedup(flat)
    wgs = wgs_index(args.table_m, device)
    small = batch_table(rng, flat, STEPS_M, device)
    tables = ((small, build_directory(small)), (wgs.table, wgs.directory))
    for table, directory in tables:
        m = table.shape[0]
        print(f"steps: table M={m}, {flat.numel()} windows, "
              f"{int(slots[2].sum())} live slots", flush=True)
        acc = torch.zeros(m, dtype=torch.int64, device=device)

        def k2(launch=None):
            acc.zero_()
            return probe_tally(flat, table, acc, directory, launch)

        def k3(launch=None):
            acc.zero_()
            return probe_tally_weighted(*slots[:2], table, acc, directory,
                                        slots[2], launch)

        for name, fn in (("K2", k2), ("K3 slots", k3)):
            ref = fn().clone()
            for threads in STEP_THREADS:
                for per_sm in STEP_BLOCKS_PER_SM:
                    launch = Launch("auto", threads, per_sm)
                    label = f"{name} M={m} {threads} thr x{per_sm}/SM"
                    parity(label, torch.equal(fn(launch), ref))
                    timeit(label, lambda fn=fn, launch=launch: fn(launch),
                           device, args.reps)


def group_tally(codes, lengths, table, acc, directory=None):
    """One K1 -> K9d -> K3 pass over a stacked group, in place into
    *acc*: (nb, B, L) uint8 *codes* and (nb, B) int32 *lengths* on the
    table's device, one launch of each kernel for the whole group (the
    counterpart of ``join_tally_superbatch_dedup``).  Returns *acc*."""
    flat = window_keys(codes.flatten(0, 1), lengths.flatten())
    keys, weights, counts = segsort.seg_dedup(flat)
    return probe_tally_weighted(keys, weights, table, acc, directory, counts)


def run_super(args, device, rng, genome):
    """One pass over a stacked group against one pass per batch: the
    dedup tally, and the engine's stacked anchoring scan."""
    index = wgs_index(args.table_m, device)
    table, directory = index.table, index.directory
    codes_np, lens_np = read_group(rng, genome, max(GROUPS), args.reads)
    codes = torch.from_numpy(codes_np).to(device)
    lengths = torch.from_numpy(lens_np).to(device)
    print(f"super: table M={table.shape[0]}, groups of {GROUPS} x "
          f"{args.reads} reads", flush=True)
    acc = torch.zeros(table.shape[0], dtype=torch.int64, device=device)
    ref = torch.zeros_like(acc)

    def per_batch(nb):
        for i in range(nb):
            group_tally(codes[i:i + 1], lengths[i:i + 1], table, ref,
                        directory)

    for nb in GROUPS:
        acc.zero_()
        ref.zero_()
        group_tally(codes[:nb], lengths[:nb], table, acc, directory)
        per_batch(nb)
        parity(f"tally of {nb} batches, one pass vs one a batch",
               torch.equal(acc, ref))
        n_reads = nb * args.reads
        for label, fn in (
                (f"group pass, {nb} batches",
                 lambda nb=nb: group_tally(codes[:nb], lengths[:nb], table,
                                           acc, directory)),
                (f"a pass a batch, {nb} batches",
                 lambda nb=nb: per_batch(nb))):
            ms = timeit(label, fn, device, args.reps)
            print(f"    = {n_reads / ms * 1e3:.1f} reads/s", flush=True)
    for nb in MEMBER_GROUPS:
        batches = list(zip(codes_np[:nb], lens_np[:nb]))
        got = eng.scan_reads_for_hits_many(index, batches)
        want = [eng.scan_reads_for_hits(index, c, ln) for c, ln in batches]
        parity(f"scan of {nb} batches, stacked vs one a batch",
               all((g == w).all() for g, w in zip(got, want)))
        n_reads = nb * args.reads
        for label, fn in (
                (f"stacked scan, {nb} batches",
                 lambda batches=batches: eng.scan_reads_for_hits_many(
                     index, batches)),
                (f"scan_reads_for_hits, {nb} batches",
                 lambda batches=batches: [eng.scan_reads_for_hits(
                     index, c, ln) for c, ln in batches])):
            ms = timeit(label, fn, device, args.reps)
            print(f"    = {n_reads / ms * 1e3:.1f} reads/s", flush=True)


def run_sprof(args, device, rng, genome):
    """Cumulative prefixes of the group pass over 8 stacked batches."""
    index = wgs_index(args.table_m, device)
    table, directory = index.table, index.directory
    codes_np, lens_np = read_group(rng, genome, SPROF_GROUP, args.reads)
    codes = torch.from_numpy(codes_np).to(device)
    lengths = torch.from_numpy(lens_np).to(device)
    acc = torch.zeros(table.shape[0], dtype=torch.int64, device=device)
    print(f"sprof: table M={table.shape[0]}, {SPROF_GROUP} x {args.reads} "
          "reads", flush=True)

    def step(stage):
        """The group pass cut after prefix *stage* (2: the whole pass)."""
        flat = window_keys(codes.flatten(0, 1), lengths.flatten())
        if stage == 0:
            return
        slots = segsort.seg_dedup(flat)
        if stage == 2:
            probe_tally_weighted(*slots[:2], table, acc, directory, slots[2])

    step(2)
    ref = torch.zeros_like(acc)
    probe_tally(window_keys(codes.flatten(0, 1), lengths.flatten()), table, ref,
                directory)
    parity("group pass vs K1 -> K2", torch.equal(acc, ref))
    prev = None
    for stage, name in enumerate(SPREFIXES):
        ms = timeit(f"sprefix {stage} {name}", lambda stage=stage: step(stage),
                    device, args.reps)
        if prev is not None:
            print(f"    marginal {ms - prev:+10.4f} ms "
                  f"({(ms - prev) / SPROF_GROUP:+.4f} a batch)", flush=True)
        prev = ms


RUNS = {
    "sort": run_sort,
    "prof": run_prof,
    "transposed": lambda *a: run_layout_of_v5(
        "transposed", "_tally_kernel_wT (x_fused.py:480)", *a),
    "unroll2": lambda *a: run_layout_of_v5(
        "unroll2", "_tally_kernel_w2 (x_fused.py:389)", *a),
    "anatomy": run_anatomy,
    "variants": run_variants,
    "steps": run_steps,
    "super": run_super,
    "sprof": run_sprof,
}


def main(argv=None):
    args = parse_args("x_fused", COMMANDS, argv)
    RUNS[args.command](args, *setup(args))


if __name__ == "__main__":
    main(sys.argv[1:])
