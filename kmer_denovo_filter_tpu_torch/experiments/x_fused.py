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

The script's other commands run no Pallas kernel and are not ported
yet (ROADMAP, queue of experiment commands).
"""

import sys

import torch

from kmer_denovo_filter_tpu_torch.experiments import x_join_variants
from kmer_denovo_filter_tpu_torch.experiments._common import (
    K,
    bound,
    parity,
    parse_args,
    read_batch,
    setup,
    timeit,
    wgs_table,
)
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops import segsort
from kmer_denovo_filter_tpu_torch.ops.directory import build_directory
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical
from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL
from kmer_denovo_filter_tpu_torch.ops.probe import (
    probe_tally,
    probe_tally_weighted,
)

COMMANDS = ("sort", "prof", "transposed", "unroll2")
V5_LAYOUTS = ("transposed", "unroll2")  # the commands that run v5
PREFIXES = ("K1", "+K9 seg sort", "+K9d (for K9)", "+K3 on the slots")


def pair_order(keys, payload):
    """Each row's (key, payload) pairs in lexicographic order: a form in
    which two sorts of one segment are equal exactly when their pair
    multisets are."""
    by_pay = torch.sort(payload, dim=1, stable=True).indices
    keys, payload = keys.gather(1, by_pay), payload.gather(1, by_pay)
    by_key = torch.sort(keys, dim=1, stable=True).indices
    return keys.gather(1, by_key), payload.gather(1, by_key)


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
    table = wgs_table(rng, genome, args.table_m, device)
    directory = build_directory(table)  # once per table, as KmerIndex
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


RUNS = {
    "sort": run_sort,
    "prof": run_prof,
    "transposed": lambda *a: run_layout_of_v5(
        "transposed", "_tally_kernel_wT (x_fused.py:480)", *a),
    "unroll2": lambda *a: run_layout_of_v5(
        "unroll2", "_tally_kernel_w2 (x_fused.py:389)", *a),
}


def main(argv=None):
    args = parse_args("x_fused", COMMANDS, argv)
    RUNS[args.command](args, *setup(args))


if __name__ == "__main__":
    main(sys.argv[1:])
