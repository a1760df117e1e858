"""The join and extract experiments of ``scripts/x_join_variants.py``,
on the port's kernels.

    python -m kmer_denovo_filter_tpu_torch.experiments.x_join_variants \\
        <command> [--device cuda|cpu] [--reps N]

The JAX script's Pallas kernels and what stands for each here:

* ``_tally_kernel_v3`` (:189) and ``_tally_kernel_v4`` (:366): the
  unweighted tally of route-sorted windows, as layouts of the TPU tile
  join.  Their function is K2's; ``kernel`` asks their design question
  on the card: K1 -> K2 on the raw windows against K1 -> ``torch.sort``
  -> K2 on the sorted windows, at the WGS table size.
* ``_tally_kernel_w`` (:782, the v5 prototype of the weighted tally):
  ``v5`` runs :class:`SegmentDedupCounter`, K1 -> K9d -> K3 on K9d's
  slots, interleaved with K1 -> K2 and :class:`BatchDedupCounter`
  (K1 -> a whole-batch ``torch.unique`` -> K3) on the same batches, all
  three exact against each other.
* the ``extract_mixed`` variants ``extract_v2p`` (:1169), ``extract_v3``
  (:1306) and the stage kernels of ``_make_extract_stage`` (:1449): K1.
  ``xextract`` and ``xextract3`` hold K1 against its plain version and
  its bound; ``xmicro`` times K1 cut at each compile-time stage (0 load
  and pack, 1 forward extract, 2 reverse complement, 3 canonical
  minimum, 4 N-in-window mask, 5 the full K1) and compares stage 5 only.

The script's other commands run no Pallas kernel; each asks its
question of the port's kernels:

* ``sort`` (``run_sort`` :145): whole-batch ``torch.sort`` of one
  batch's int64 window keys, bare, stable with an int32 payload
  gathered, and as an argsort (the member path's index), against K9 per
  8,192-row segment with and without its payload.
* ``pieces5`` (``run_pieces5`` :664): each piece of the segment form
  alone: K9 (keys, then with the payload), K9d, the run starts and
  ranks and the compaction of ``ops/device.segment_compact`` (the
  plain stand-in for K9d's slots), and K3 on the compacted stream
  against K3 on K9d's slots.
* ``prof5`` (``run_prof5`` :1032): the cumulative prefixes of the
  engine's dedup step on the WGS table: K1, + K9d, + K3 on the slots,
  and the whole ``FilteredCounter(dedup=True).feed`` of a host batch.
* ``xfloor`` (``run_xfloor`` :1577): an empty launch (device time, and
  the host's launch rate apart), one elementwise pass over a (B, 167)
  int32 tensor, and the engine's dedup-form feed at 1x, 2x and 4x a
  batch in reads/s, each exact against the K1 -> K2 form.
* ``v5m`` (``run_v5m`` :1629): the member scan behind a dedup, built
  from the port's kernels (it has no such path): K9 with the window
  index as payload -> run heads -> K4 on the heads -> each head's bit
  spread over its run and scattered back (:func:`member_behind_seg_sort`),
  and ``torch.unique`` -> K4 -> a gather (:func:`member_behind_unique`),
  both exact against K4 on the raw windows.
* ``v5w`` (``run_v5w`` :1669): at k = 63 the wide filter's three forms,
  K1w -> K7, K1w -> K9dw -> K7 on the slots and K1w ->
  ``dedup_windows_wide`` -> K7, on a table of random rows and every
  fifth live row of the batch; all three exact.

``extract`` (the doubling pack, which K1's packed tile is) and ``s1``
(the sharded engine's S = 1 rate, ``chip_smoke.py`` phase 8) have
their answers already and are not ported.
"""

import sys
import time

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch import steps
from kmer_denovo_filter_tpu_torch.experiments._common import (
    K,
    READ_LEN,
    V5_BATCHES,
    bound,
    pair_order,
    parity,
    parse_args,
    read_batch,
    setup,
    synth_reads,
    timeit,
    wgs_index,
    window_keys,
)
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops import segsort
from kmer_denovo_filter_tpu_torch.ops.directory import build_directory
from kmer_denovo_filter_tpu_torch.ops.extract import (
    extract_canonical,
    extract_canonical_stage,
    extract_canonical_wide,
)
from kmer_denovo_filter_tpu_torch.ops.member import probe_member
from kmer_denovo_filter_tpu_torch.ops.probe import (
    probe_tally,
    probe_tally_weighted,
    probe_tally_wide,
)
from kmer_denovo_filter_tpu_torch.ops.timing import timings

COMMANDS = ("v5", "kernel", "xextract", "xextract3", "xmicro", "sort",
            "pieces5", "prof5", "xfloor", "v5m", "v5w")
K_WIDE = 63  # v5w's k, as the JAX run_v5w
FLOOR_WIDTH = 167  # xfloor's elementwise tensor: (B, 167) int32
FLOOR_MULTS = (1, 2, 4)  # xfloor's batch sizes, in BATCH_READS
STAGES = ("load + pack", "+forward extract", "+reverse complement",
          "+canonical min", "+N-in-window mask", "+read length (= K1)")


class SegmentDedupCounter(eng.FilteredCounter):
    """The parent filter in the segment form of the v5 prototype
    (``scripts/x_join_variants.py:join_tally_step_v5`` :946): K1 window
    keys -> K9d (each 8,192-window segment's distinct keys and their
    multiplicities, left in its slot) -> K3 on the slots, through the
    index's directory: the engine's dedup form at k <= 31, which it
    runs."""

    def __init__(self, index):
        if index.k > keys64.NARROW_K:
            raise ValueError(f"the segment form takes k <= "
                             f"{keys64.NARROW_K}, got k={index.k}")
        super().__init__(index, dedup=True)


class BatchDedupCounter(SegmentDedupCounter):
    """The parent filter with a whole-batch dedup: K1 -> ``torch.unique``
    (:func:`~kmer_denovo_filter_tpu_torch.ops.device.dedup_windows`, a
    host sync) -> K3 on the flat (key, weight) stream; k <= 31 only."""

    def feed(self, codes, lengths):
        win = steps.window_keys(codes, lengths, self.index.k,
                                self.index.device)
        if win is None:
            return
        keys, weights = dev.dedup_windows(win.reshape(-1))
        probe_tally_weighted(keys, weights, self.index.table, self.acc,
                             self.index.directory)


class WideBatchDedupCounter(eng.FilteredCounter):
    """The wide parent filter with a whole-batch dedup: K1w ->
    :func:`~kmer_denovo_filter_tpu_torch.ops.device.dedup_windows_wide`
    (Q stable sorts and a host sync) -> K7 weighted on the flat (row,
    weight) stream, the engine's wide dedup form before K9dw; k > 31
    only (``chip_smoke.py`` phase 5c's third form)."""

    def __init__(self, index):
        if index.k <= keys64.NARROW_K:
            raise ValueError(f"the wide batch form takes k > "
                             f"{keys64.NARROW_K}, got k={index.k}")
        super().__init__(index, dedup=True)

    def feed(self, codes, lengths):
        win = steps.window_keys(codes, lengths, self.index.k,
                                self.index.device)
        if win is None:
            return
        keys, weights = dev.dedup_windows_wide(win.flatten(0, 1))
        probe_tally_wide(keys, self.index.table, self.acc, weights,
                         self.index.directory)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_v5(args, device, rng, genome):
    """The three parent-filter forms on the same batches, interleaved
    (A B C C B A), each exact against the others; reads/s of each."""
    index = wgs_index(args.table_m, device)
    batches = [synth_reads(rng, genome, args.reads)
               for _ in range(V5_BATCHES)]
    lens = np.full(args.reads, READ_LEN, np.int32)
    n_reads = args.reads * len(batches)
    forms = {
        "K1->K2": lambda: eng.FilteredCounter(index),
        "K1->dedup->K3": lambda: BatchDedupCounter(index),
        "K1->K9d->K3": lambda: SegmentDedupCounter(index),
    }
    print(f"v5: table M={index.n}, {len(batches)} batches x {args.reads} "
          f"reads x {READ_LEN} bp", flush=True)

    def feed(name):
        fc = forms[name]()
        _sync(device)
        t = time.perf_counter()
        for c in batches:
            fc.feed(c, lens)
        _sync(device)
        return fc.acc, n_reads / (time.perf_counter() - t)

    for name in forms:  # warm-up
        feed(name)
    rates = {name: [] for name in forms}
    same = {name: True for name in forms}
    ref = None
    for name in list(forms) + list(forms)[::-1]:
        acc, rate = feed(name)
        rates[name].append(rate)
        ref = acc if ref is None else ref
        same[name] &= torch.equal(acc, ref)
    for name in forms:
        parity(f"v5 {name} tally", same[name])
    print(f"  v5 hits {int(ref.sum())} in {int((ref > 0).sum())} table rows",
          flush=True)
    for name, r in rates.items():
        print(f"{'feed ' + name:44s} {r[0]:14.1f} / {r[1]:.1f} reads/s",
              flush=True)
    return rates


def run_kernel(args, device, rng, genome):
    """K1 -> K2 on raw windows against K1 -> sort -> K2 on sorted ones
    (the question of the sorted-route tally kernels v3 and v4)."""
    index = wgs_index(args.table_m, device)
    table, directory = index.table, index.directory
    codes, lengths = read_batch(rng, genome, args.reads, device)
    flat = extract_canonical(codes, lengths, K).reshape(-1)
    srt = torch.sort(flat).values
    acc_raw = torch.zeros(table.shape[0], dtype=torch.int64, device=device)
    acc_sorted = torch.zeros_like(acc_raw)
    probe_tally(flat, table, acc_raw, directory)
    probe_tally(srt, table, acc_sorted, directory)
    print(f"kernel: table M={table.shape[0]}, {flat.numel()} windows",
          flush=True)
    parity("sorted-query tally", torch.equal(acc_raw, acc_sorted))
    parity("tally vs plain", torch.equal(
        acc_raw, dev.small_table_tally(table, flat)))
    reps = args.reps
    raw_ms = timeit("K2 on raw windows",
                    lambda: probe_tally(flat, table, acc_raw, directory),
                    device, reps)
    sorted_ms = timeit("K2 on sorted windows",
                       lambda: probe_tally(srt, table, acc_sorted, directory),
                       device, reps)
    timeit("K2 plain on sorted windows",
           lambda: dev.small_table_tally(table, srt), device, reps)
    # windows read; per table row hit its key read and its count read and
    # written; ceil(log2(M + 1)) + 1 compares per live window
    live = int((flat != keys64.SENTINEL).sum())
    lim = bound(8 * flat.numel() + 24 * int((acc_raw > 0).sum()),
                live * (table.shape[0].bit_length() + 1))
    print(f"  K2 bound {lim[0]:.4f} ms by {lim[1]} ({lim[0] / raw_ms:.3f} "
          f"of the raw, {lim[0] / sorted_ms:.3f} of the sorted time)",
          flush=True)
    timeit("step K1 -> K2", lambda: probe_tally(
        extract_canonical(codes, lengths, K).reshape(-1), table, acc_raw,
        directory), device, reps)
    timeit("step K1 -> sort -> K2", lambda: probe_tally(
        torch.sort(extract_canonical(codes, lengths, K).reshape(-1)).values,
        table, acc_sorted, directory), device, reps)


def _extract_report(label, codes, lengths, device, reps):
    """K1 against its plain version, timed beside it and its bound."""
    got = extract_canonical(codes, lengths, K)
    parity(f"K1 {label}", torch.equal(
        got, dev.extract_canonical_windows(codes, lengths, K)[0]))
    ms = timeit(f"K1 [{label}]", lambda: extract_canonical(codes, lengths, K),
                device, reps)
    timeit(f"K1 plain [{label}]",
           lambda: dev.extract_canonical_windows(codes, lengths, K), device,
           reps)
    lim = bound(codes.numel() + 4 * codes.shape[0] + 8 * got.numel(),
                6 * got.numel())
    print(f"  K1 [{label}] bound {lim[0]:.4f} ms by {lim[1]} "
          f"({lim[0] / ms:.3f} of the kernel's time)", flush=True)


def run_xextract(args, device, rng, genome):
    codes, lengths = read_batch(rng, genome, args.reads, device)
    _extract_report("clean", codes, lengths, device, args.reps)


def run_xextract3(args, device, rng, genome):
    """K1 on the clean batch and on the same reads made ragged with N
    bases (the parity inputs of the JAX ``run_xextract3``)."""
    codes, lengths = read_batch(rng, genome, args.reads, device)
    ln = np.full(args.reads, READ_LEN, np.int32)
    ln[::7] = 100
    ln[::11] = 63
    cn = codes.cpu().numpy().copy()
    cn[np.random.default_rng(5).random(cn.shape) < 0.01] = 4
    _extract_report("clean", codes, lengths, device, args.reps)
    _extract_report("ragged+N", torch.from_numpy(cn).to(device),
                    torch.from_numpy(ln).to(device), device, args.reps)


def run_xmicro(args, device, rng, genome):
    """K1 cut at each compile-time stage; only stage 5 is compared.  The
    cuts 0-4 exist in the CUDA kernel only: on the CPU stage 5 runs."""
    codes, lengths = read_batch(rng, genome, args.reads, device)
    parity("stage 5", torch.equal(
        extract_canonical_stage(codes, lengths, K, 5),
        dev.extract_canonical_windows(codes, lengths, K)[0]))
    stages = range(len(STAGES)) if device.type == "cuda" else (5,)
    for stage in stages:
        timeit(f"stage {stage} {STAGES[stage]}",
               lambda stage=stage: extract_canonical_stage(codes, lengths,
                                                           K, stage),
               device, args.reps)


def run_sort(args, device, rng, genome):
    """Whole-batch sorts of one batch's window keys against K9 per
    segment; parity of the sorted keys and of each segment's pairs."""
    codes, lengths = read_batch(rng, genome, args.reads, device)
    flat = window_keys(codes, lengths)
    index = torch.arange(flat.numel(), dtype=torch.int32, device=device)
    print(f"sort: {flat.numel()} int64 window keys", flush=True)
    bare = torch.sort(flat).values
    stable = torch.sort(flat, stable=True)
    order = torch.argsort(flat, stable=True)
    parity("whole-batch sorted keys", torch.equal(bare, stable.values)
           and torch.equal(flat[order], bare)
           and torch.equal(flat[index[stable.indices].long()], bare))
    keys, pay = segsort.seg_sort(flat, index)
    ref_keys, ref_pay = dev.segment_sort(segsort.segments(flat,
                                                          keys64.SENTINEL),
                                         segsort.segments(index, -1))
    parity("K9 segment keys", torch.equal(keys, ref_keys) and torch.equal(
        segsort.seg_sort(flat)[0], ref_keys))
    parity("K9 segment (key, payload) pairs", all(
        torch.equal(a, b) for a, b in zip(pair_order(keys, pay),
                                          pair_order(ref_keys, ref_pay))))
    reps = args.reps
    timeit("torch.sort, whole batch", lambda: torch.sort(flat), device, reps)

    def with_payload():
        srt = torch.sort(flat, stable=True)
        return srt.values, index[srt.indices]

    timeit("torch.sort stable + int32 payload", with_payload, device, reps)
    timeit("torch.argsort stable [member index]",
           lambda: torch.argsort(flat, stable=True), device, reps)
    timeit("K9 seg sort, keys", lambda: segsort.seg_sort(flat), device, reps)
    timeit("K9 seg sort, key + payload",
           lambda: segsort.seg_sort(flat, index), device, reps)


def _run_heads(srt):
    """Run starts of each row of sorted (S, 8192) keys (sentinel keys
    start none) and each slot's rank among them (a torch compare and a
    cumulative sum)."""
    start = srt != keys64.SENTINEL
    start[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    return start, start.cumsum(1)


def run_pieces5(args, device, rng, genome):
    """Each piece of the segment form alone; K3 on the compacted stream
    against K3 on K9d's slots."""
    index = wgs_index(args.table_m, device)
    table, directory = index.table, index.directory
    codes, lengths = read_batch(rng, genome, args.reads, device)
    flat = window_keys(codes, lengths)
    payload = torch.arange(flat.numel(), dtype=torch.int32, device=device)
    slots = segsort.seg_dedup(flat)
    keys, weights = dev.segment_compact(*slots)
    start, rank = _run_heads(segsort.seg_sort(flat)[0])
    live = int((flat != keys64.SENTINEL).sum())
    print(f"pieces5: table M={table.shape[0]}, {flat.numel()} windows "
          f"({live} live), {slots[0].shape[0]} segments, {keys.numel()} "
          f"segment-distinct keys", flush=True)
    parity("weights sum to the live windows", int(weights.sum()) == live)
    parity("run starts and ranks count K9d's slots", torch.equal(
        start.sum(1).int(), slots[2]) and torch.equal(rank[:, -1].int(),
                                                      slots[2]))
    acc_flat = torch.zeros(table.shape[0], dtype=torch.int64, device=device)
    acc_slots = torch.zeros_like(acc_flat)
    probe_tally_weighted(keys, weights, table, acc_flat, directory)
    probe_tally_weighted(*slots[:2], table, acc_slots, directory, slots[2])
    parity("K3 compacted vs K3 on the slots", torch.equal(acc_flat,
                                                         acc_slots))
    reps = args.reps
    timeit("K9 seg sort, keys", lambda: segsort.seg_sort(flat), device, reps)
    timeit("K9 seg sort, key + payload",
           lambda: segsort.seg_sort(flat, payload), device, reps)
    timeit("K9d seg dedup", lambda: segsort.seg_dedup(flat), device, reps)
    srt = segsort.seg_sort(flat)[0]
    timeit("run starts + ranks (torch)", lambda: _run_heads(srt), device,
           reps)
    timeit("compaction (segment_compact, a sync)",
           lambda: dev.segment_compact(*slots), device, reps)
    timeit("K3 on the compacted stream", lambda: probe_tally_weighted(
        keys, weights, table, acc_flat, directory), device, reps)
    timeit("K3 on K9d's slots", lambda: probe_tally_weighted(
        *slots[:2], table, acc_slots, directory, slots[2]), device, reps)


def run_prof5(args, device, rng, genome):
    """Cumulative prefixes of the engine's dedup step, to the whole
    ``FilteredCounter(dedup=True).feed`` of a host batch."""
    index = wgs_index(args.table_m, device)
    table, directory = index.table, index.directory
    codes_np = synth_reads(rng, genome, args.reads)
    lens_np = np.full(args.reads, READ_LEN, np.int32)
    codes = torch.from_numpy(codes_np).to(device)
    lengths = torch.from_numpy(lens_np).to(device)
    acc = torch.zeros(table.shape[0], dtype=torch.int64, device=device)
    counter = eng.FilteredCounter(index, dedup=True)
    print(f"prof5: table M={table.shape[0]}, {args.reads} reads",
          flush=True)

    def step(stage, acc):
        """The step cut after prefix *stage* (3: the engine's feed)."""
        if stage == 3:
            counter.feed(codes_np, lens_np)
            return
        flat = window_keys(codes, lengths)
        if stage == 0:
            return
        slots = segsort.seg_dedup(flat)
        if stage == 2:
            probe_tally_weighted(*slots[:2], table, acc, directory, slots[2])

    step(2, acc)
    step(3, None)
    flat_acc = torch.zeros_like(acc)
    probe_tally_weighted(*dev.segment_compact(*segsort.seg_dedup(
        window_keys(codes, lengths))), table, flat_acc, directory)
    parity("K3 compacted vs K3 on the slots vs the engine's feed",
           torch.equal(acc, flat_acc) and torch.equal(acc, counter.acc))
    prev = None
    for stage, name in enumerate(("K1", "+K9d", "+K3 on the slots",
                                  "+host feed (FilteredCounter.feed)")):
        ms = timeit(f"prefix {stage} {name}",
                    lambda stage=stage: step(stage, acc), device, args.reps)
        if prev is not None:
            print(f"    marginal {ms - prev:+10.4f} ms", flush=True)
        prev = ms


def run_xfloor(args, device, rng, genome):
    """The launch floor, one elementwise pass, and the dedup-form feed
    rate at 1x, 2x and 4x a batch."""
    tiny = torch.zeros((8, 128), dtype=torch.int32, device=device)

    def empty():
        return tiny[:1, :1] + 1

    if device.type == "cuda":
        with torch.cuda.device(device):
            spun_ms, loop_ms = timings(empty, args.reps)
        print(f"{'empty launch (device, behind the spin)':44s} "
              f"{spun_ms:10.4f} ms", flush=True)
        print(f"{'empty launch (host launch rate)':44s} {loop_ms:10.4f} ms "
              f"= {1e3 / loop_ms:.0f} launches/s", flush=True)
    else:
        timeit("empty launch (host)", empty, device, args.reps)
    big = torch.zeros((args.reads, FLOOR_WIDTH), dtype=torch.int32,
                      device=device)
    out = torch.empty_like(big)
    ms = timeit(f"one elementwise pass {tuple(big.shape)} int32",
                lambda: torch.mul(big, 2, out=out), device, args.reps)
    lim = bound(2 * 4 * big.numel(), big.numel())
    print(f"  bound {lim[0]:.4f} ms by {lim[1]} ({lim[0] / ms:.3f} of the "
          "pass's time)", flush=True)
    index = wgs_index(args.table_m, device)
    print(f"xfloor: table M={index.n}", flush=True)
    for mult in FLOOR_MULTS:
        n = args.reads * mult
        codes = synth_reads(rng, genome, n)
        lens = np.full(n, READ_LEN, np.int32)
        dedup = eng.FilteredCounter(index, dedup=True)
        plain = eng.FilteredCounter(index)
        dedup.feed(codes, lens)
        plain.feed(codes, lens)
        parity(f"{n} reads: dedup form vs K1 -> K2",
               torch.equal(dedup.acc, plain.acc))
        ms = timeit(f"dedup-form feed, {n} reads",
                    lambda: dedup.feed(codes, lens), device, args.reps)
        print(f"    = {n / ms * 1e3:.1f} reads/s", flush=True)


def member_behind_seg_sort(flat, table, directory=None):
    """(N,) bool: each window key of the (N,) int64 stream *flat* is in
    *table*, probing each distinct key of a segment once: K9 sorts each
    8,192-window segment with the window index as payload, the run heads
    (a key unlike the one before it) go through K4 on their own, each
    head's found bit is spread over its run and scattered back through
    the payload.  Sentinel windows are never found."""
    n = flat.shape[0]
    keys, pay = segsort.seg_sort(
        flat, torch.arange(n, dtype=torch.int32, device=flat.device))
    head = torch.ones_like(keys, dtype=torch.bool)
    head[:, 1:] = keys[:, 1:] != keys[:, :-1]
    found = probe_member(keys[head], table, directory)[
        head.reshape(-1).cumsum(0) - 1]
    # padding slots (payload -1) land in a spare last entry
    pay = pay.reshape(-1).long()
    out = torch.zeros(n + 1, dtype=torch.bool, device=flat.device)
    out[torch.where(pay >= 0, pay, n)] = found
    return out[:n]


def member_behind_unique(flat, table, directory=None):
    """:func:`member_behind_seg_sort` by a whole-batch ``torch.unique``:
    K4 on the distinct keys, gathered back by the inverse index."""
    uniq, inverse = torch.unique(flat, return_inverse=True)
    return probe_member(uniq, table, directory)[inverse]


def run_v5m(args, device, rng, genome):
    """The member scan behind a dedup, two ways, against K4 on the raw
    windows; the dedup tally step timed in the same run."""
    index = wgs_index(args.table_m, device)
    table, directory = index.table, index.directory
    codes, lengths = read_batch(rng, genome, args.reads, device)
    flat = window_keys(codes, lengths)
    raw = probe_member(flat, table, directory)
    heads = int((segsort.seg_dedup(flat)[2]).sum())
    print(f"v5m: table M={table.shape[0]}, {flat.numel()} windows, "
          f"{heads} segment-distinct keys, "
          f"{torch.unique(flat).numel()} of the batch, {int(raw.sum())} "
          "found", flush=True)
    parity("member behind K9 vs K4 raw", torch.equal(
        member_behind_seg_sort(flat, table, directory), raw))
    parity("member behind torch.unique vs K4 raw", torch.equal(
        member_behind_unique(flat, table, directory), raw))
    reps = args.reps
    timeit("K4 on the raw windows",
           lambda: probe_member(flat, table, directory), device, reps)
    timeit("K9 -> heads -> K4 -> spread + scatter",
           lambda: member_behind_seg_sort(flat, table, directory), device,
           reps)
    timeit("torch.unique -> K4 -> gather",
           lambda: member_behind_unique(flat, table, directory), device,
           reps)
    acc = torch.zeros(table.shape[0], dtype=torch.int64, device=device)

    def tally():
        slots = segsort.seg_dedup(flat)
        probe_tally_weighted(*slots[:2], table, acc, directory, slots[2])

    timeit("tally K9d -> K3 (same run)", tally, device, reps)


def wide_table(rng, flat, m, k, device):
    """Sorted unique (M', Q) limb-row table on *device*: *m* random rows
    and every fifth live row of the window rows *flat* (the recipe of
    ``run_v5w`` :1669)."""
    rand = torch.from_numpy(np.stack([
        rng.integers(0, 4 ** nb, m, dtype=np.int64)
        for nb in keys64.limb_bases(k)], 1)).to(device)
    live = flat[flat[:, 0] != keys64.SENTINEL]
    return dev.unique_rows(torch.cat([rand, live[::5]]))[0]


def run_v5w(args, device, rng, genome):
    """The wide filter's three forms at k = 63, exact against each
    other."""
    k = K_WIDE
    codes, lengths = read_batch(rng, genome, args.reads, device)
    table = wide_table(rng, extract_canonical_wide(codes, lengths,
                                                   k).flatten(0, 1),
                       args.table_m, k, device)
    directory = build_directory(table)  # once per table, as KmerIndex
    accs = {}

    def plain(acc):
        flat = extract_canonical_wide(codes, lengths, k).flatten(0, 1)
        probe_tally_wide(flat, table, acc, directory=directory)

    def segment(acc):
        flat = extract_canonical_wide(codes, lengths, k).flatten(0, 1)
        keys, weights, counts = segsort.seg_dedup_wide(flat)
        probe_tally_wide(keys, table, acc, weights, directory, counts)

    def batch(acc):
        flat = extract_canonical_wide(codes, lengths, k).flatten(0, 1)
        keys, weights = dev.dedup_windows_wide(flat)
        probe_tally_wide(keys, table, acc, weights, directory)

    forms = {"K1w -> K7": plain, "K1w -> K9dw -> K7 slots": segment,
             "K1w -> dedup_windows_wide -> K7": batch}
    for name, form in forms.items():
        accs[name] = torch.zeros(table.shape[0], dtype=torch.int64,
                                 device=device)
        form(accs[name])
    ref = accs["K1w -> K7"]
    print(f"v5w: k={k}, table M={table.shape[0]} x {table.shape[1]} limbs, "
          f"{int(ref.sum())} hits", flush=True)
    for name, acc in accs.items():
        parity(f"wide {name} tally", torch.equal(acc, ref))
    for name, form in forms.items():
        timeit(f"step {name}", lambda form=form, name=name: form(accs[name]),
               device, args.reps)


RUNS = {"v5": run_v5, "kernel": run_kernel, "xextract": run_xextract,
        "xextract3": run_xextract3, "xmicro": run_xmicro, "sort": run_sort,
        "pieces5": run_pieces5, "prof5": run_prof5, "xfloor": run_xfloor,
        "v5m": run_v5m, "v5w": run_v5w}


def main(argv=None):
    args = parse_args("x_join_variants", COMMANDS, argv)
    RUNS[args.command](args, *setup(args))


if __name__ == "__main__":
    main(sys.argv[1:])
