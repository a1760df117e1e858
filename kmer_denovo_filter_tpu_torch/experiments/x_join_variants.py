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

The script's other commands run no Pallas kernel and are not ported
yet (ROADMAP, queue of experiment commands).
"""

import sys
import time

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch.experiments._common import (
    K,
    READ_LEN,
    V5_BATCHES,
    bound,
    parity,
    parse_args,
    read_batch,
    setup,
    synth_reads,
    timeit,
    wgs_table,
)
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.directory import build_directory
from kmer_denovo_filter_tpu_torch.ops.extract import (
    extract_canonical,
    extract_canonical_stage,
)
from kmer_denovo_filter_tpu_torch.ops.probe import (
    probe_tally,
    probe_tally_weighted,
    probe_tally_wide,
)

COMMANDS = ("v5", "kernel", "xextract", "xextract3", "xmicro")
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
        win = eng._window_keys(codes, lengths, self.index.k,
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
        win = eng._window_keys(codes, lengths, self.index.k,
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
    table = wgs_table(rng, genome, args.table_m, device)
    index = eng.KmerIndex(keys64.keys64_to_words(table, K), K, device=device)
    del table
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
    table = wgs_table(rng, genome, args.table_m, device)
    directory = build_directory(table)  # once per table, as KmerIndex
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


RUNS = {"v5": run_v5, "kernel": run_kernel, "xextract": run_xextract,
        "xextract3": run_xextract3, "xmicro": run_xmicro}


def main(argv=None):
    args = parse_args("x_join_variants", COMMANDS, argv)
    RUNS[args.command](args, *setup(args))


if __name__ == "__main__":
    main(sys.argv[1:])
