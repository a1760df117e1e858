"""K1, K1w, K2, K3, K4, K7, K8, K9, K9d, K9dw, K10, K11 and K12 of one
checkout, each read three ways on the card:

* ``device``: ``ops.timing.timings``' first reading, the calls queued
  behind a spin, the timer of ``chip_smoke.py`` and the experiments;
* ``loop``: its second reading, a plain loop of calls between two CUDA
  events, which was their timer before the spin (it times the host's
  launch rate for a kernel shorter than the launch);
* ``profiler``: the device time of the calls' own kernels by
  ``torch.profiler``, which no host timing can bias.

The shapes are those of ``chip_smoke.py`` phases 3, 3p and 3w: 32,768
random reads of 152 bp (256 at k = 201) with ~0.5 % N and 10 % ragged
lengths, tables of 4,096 keys half drawn from the batch, and one
(1, 2**20) row; K2, K3 and K4 at k = 31 also at 262,144, 2**20 and
2**24 keys, K4 also on a stacked group of 8 x 4,096 reads, K2, K3 and
K4 also on one 40x-coverage batch (the 3s batch) with tables half drawn
from its keys.  Every probe goes through its table's prefix directory
(``ops/directory.py``), built once per table as the engine does (the
wide build timed as ``dir wide``).  K3 is read on the batch's whole
dedup (``flat``) and on K9d's slots in both of K9d's forms (``slots``,
``slots unordered``); K9d and K9dw in both forms, the unordered one
(``K9d unordered``, ``K9dw unordered``: the parent filter's) checked by
each segment's weight sums, with the number of segments passed through
printed; and the step from K1's keys to the tally at 2**24 keys in each
form: K1 -> K2, K1 -> whole-batch dedup -> K3, K1 -> K9d -> K3 on the
slots, ordered and unordered.  K7 (unweighted, and weighted on the
batch dedup) and K8 (found bytes, rows) at k = 63 on 2,048, 4,096,
262,144 and 2**24 rows and at k = 201 on 1,024, 4,096 and 2**22, half
drawn from the batch (2,048 and 1,024 rows are tables that a form
staging them in shared memory would hold).  K9 with and without its
payload on the k = 31 keys of both batches; K9dw beside the whole-batch
dedup ``dedup_windows_wide`` and ``torch.unique(dim=0)``, and the wide
step from the codes to the tally at k = 63, 2**24 rows and k = 201,
2**22 rows, in each form (K1w -> K7, K1w -> ``dedup_windows_wide`` ->
K7 weighted, K1w -> K9dw -> K7 on the slots, ordered and unordered, and
K7 on the slots alone), on the random batch and a 40x batch of 152 bp
(256 bp at k = 201).  The timer is always the one beside this file,
whatever checkout's kernels it times, so two checkouts compare under
one timer::

    python kmer_denovo_filter_tpu_torch/experiments/timer_ab.py \\
        [--root CHECKOUT] [--tag NAME] [--kernels K1,K3,...]

``--kernels`` keeps only the named groups (K1, K1w, K2, K3, K4, K7, K8,
K9, K9d, K9dw, step, wstep, dir, K10, K11, K12; default all).

K10 routes the k = 31 and k = 63 keys of the random batch to S = 1, 2
and 4 shards; ``K10 route`` times the whole route of that one source,
``parallel.sharded._gather_by_owner`` with its sizes' host sync.  K11
converts 2**20, 2**22 and 2**24 words on the card at k = 31 and 63;
``K11 keys`` times the host words to keys on the card as a table's
build takes them, ``ops.convert.words_tensor`` copied up, then K11.
K12 sort-counts the window keys of the random and the 40x batch at
k = 31, 63 and 201, the call with its host sync; ``K12 plain`` times
the plain version on the same keys (``torch.unique``, or Q stable sorts
for rows).

Run it as a file: *CHECKOUT* (default: the one that holds this file) goes
first on ``sys.path`` and its package is imported; it needs every kernel
above and the ops wrappers' signatures of this tree.  Every output is
checked against its plain version.  Prints a line per kernel and shape,
then one JSON line."""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
B, L, L_K201, ROW, M, REPS = 32768, 152, 256, 1 << 20, 4096, 20
PROBE_MS = (4096, 262144, 1 << 20, 1 << 24)
WIDE_MS = {63: (2048, 4096, 262144, 1 << 24), 201: (1024, 4096, 1 << 22)}
GROUP, GROUP_B = 8, 4096
GROUPS = ("K1", "K1w", "K2", "K3", "K4", "K7", "K8", "K9", "K9d", "K9dw",
          "step", "wstep", "dir", "K10", "K11", "K12")
ROUTE_SHARDS = (1, 2, 4)
K11_MS = (1 << 20, 1 << 22, 1 << 24)
STEP_M = 1 << 24
WSTEP_M = {63: 1 << 24, 201: 1 << 22}


def load_timing():
    """This checkout's ``ops/timing.py``, loaded by path."""
    path = os.path.join(os.path.dirname(HERE), "ops", "timing.py")
    spec = importlib.util.spec_from_file_location("kdf_ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profiler_ms(fn, reps):
    """Mean device milliseconds of the kernels *fn* launches, by
    ``torch.profiler`` over *reps* calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps


def synth_reads(rng, genome, n_reads, read_len, coverage=40,
                error_rate=0.003):
    """Position-local reads with 0.3 % error at 40x (``chip_smoke.py``'s
    recipe, from bench.py)."""
    span = max(n_reads * read_len // coverage, read_len * 4)
    start0 = rng.integers(0, len(genome) - span - read_len)
    starts = np.sort(rng.integers(start0, start0 + span, n_reads))
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    err = rng.random((n_reads, read_len)) < error_rate
    return np.where(err, (reads + rng.integers(
        1, 4, (n_reads, read_len))) % 4, reads).astype(np.uint8)


def random_batch(rng, length):
    codes = rng.integers(0, 4, (B, length), dtype=np.uint8)
    codes[rng.random((B, length)) < 0.005] = 4
    lengths = np.full(B, length, np.int32)
    ragged = rng.random(B) < 0.1
    lengths[ragged] = rng.integers(0, length + 1, int(ragged.sum()))
    return codes, lengths


def segment_sums(keys, weights, counts):
    """Every segment's live slots merged: sorted (segment, key limbs)
    rows and each row's weight sum, the contract of K9d's and K9dw's
    unordered form."""
    seg = keys.shape[1]
    live = (torch.arange(seg, device=keys.device)[None, :]
            < counts[:, None].long())
    segs = torch.arange(counts.shape[0], device=keys.device)[:, None]
    rows = keys[live].reshape(int(live.sum()), -1)
    rows = torch.cat([segs.expand(-1, seg)[live][:, None], rows], 1)
    uniq, inverse = torch.unique(rows, dim=0, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=torch.int64, device=keys.device)
    return uniq, sums.index_add_(0, inverse, weights[live])


def main(argv=None):
    ap = argparse.ArgumentParser(prog="timer_ab")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--tag", default="")
    ap.add_argument("--kernels", default=",".join(GROUPS))
    args = ap.parse_args(argv)
    wanted = set(args.kernels.split(","))
    if not wanted <= set(GROUPS):
        sys.exit(f"timer_ab: --kernels takes {','.join(GROUPS)}")
    if not torch.cuda.is_available():
        sys.exit("timer_ab: needs a CUDA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from kmer_denovo_filter_tpu_torch.ops import convert, extract, member
    from kmer_denovo_filter_tpu_torch.ops import device as dev
    from kmer_denovo_filter_tpu_torch.ops import directory as tdir
    from kmer_denovo_filter_tpu_torch.ops import keys as keys64
    from kmer_denovo_filter_tpu_torch.ops import probe, route, segsort
    from kmer_denovo_filter_tpu_torch.ops import sortcount
    timing = load_timing()
    print(f"timer_ab {args.tag}: package {os.path.dirname(dev.__file__)}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    cuda = torch.device("cuda", 0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    rows = []

    def time_it(name, shape, fn):
        if name.split()[0] not in wanted:
            return
        device_ms, loop_ms = timing.timings(fn, REPS)
        prof_ms = profiler_ms(fn, REPS)
        rows.append({"kernel": name, "shape": shape, "device_ms": device_ms,
                     "loop_ms": loop_ms, "profiler_ms": prof_ms})
        print(f"{args.tag:8s} {name:13s} {shape:24s} device "
              f"{device_ms:.4f} ms, loop {loop_ms:.4f} ms, profiler "
              f"{prof_ms:.4f} ms", flush=True)

    def check(what, got, ref):
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            sys.exit(f"timer_ab: {what} differs from its plain version")

    def table_of(flat, k, m=M):
        """(~m, Q) or (~m,) sorted table: half live rows of *flat*, half
        random."""
        wide = flat.dim() == 2
        live = flat[flat[:, 0] != keys64.SENTINEL] if wide else (
            flat[flat != keys64.SENTINEL])
        live = dev.unique_rows(live)[0] if wide else torch.unique(live)
        pick = live[torch.randperm(live.shape[0], generator=gen,
                                   device=cuda)[:m // 2]]
        if wide:
            rand = torch.stack([torch.randint(0, 4 ** nb, (m - m // 2,),
                                              generator=gen, device=cuda)
                                for nb in keys64.limb_bases(k)], 1)
            return dev.unique_rows(torch.cat([pick, rand]))[0]
        rand = torch.randint(0, 4 ** k, (m - pick.numel(),), generator=gen,
                             device=cuda)
        return torch.unique(torch.cat([pick, rand]))

    def wide_table(flat, k, m):
        """(m, Q) sorted unique limb rows: half the distinct live rows of
        *flat*, half random rows (``chip_smoke.make_table_wide``'s
        recipe)."""
        live = dev.unique_rows(flat[flat[:, 0] != keys64.SENTINEL])[0]
        pick = live[torch.randperm(live.shape[0], generator=gen,
                                   device=cuda)[:m // 2]]
        rand = torch.stack([torch.randint(0, 4 ** nb, (2 * m + 16,),
                                          generator=gen, device=cuda)
                            for nb in keys64.limb_bases(k)], 1)
        rand = dev.unique_rows(
            rand[~dev.member_wide(dev.unique_rows(pick)[0], rand)])[0]
        rand = rand[torch.randperm(rand.shape[0], generator=gen,
                                   device=cuda)[:m - pick.shape[0]]]
        table = dev.unique_rows(torch.cat([pick, rand]))[0]
        if table.shape[0] != m:
            sys.exit(f"timer_ab: wide table of {table.shape[0]} rows, "
                     f"wanted {m}")
        return table

    def wide_probes(k, flat):
        """K7 (unweighted on *flat*, weighted on its dedup) and K8 (found
        bytes, rows) at each of WIDE_MS[k] table rows, through the
        table's directory."""
        uniq, weights = dev.dedup_windows_wide(flat)
        for m in WIDE_MS[k]:
            table = wide_table(flat, k, m)
            ref = dev.small_table_tally_wide(table, flat)
            ref_found = dev.member_wide(table, flat)
            ref_rows = dev.find_rows_wide(table, flat)
            acc = torch.zeros(m, dtype=torch.int64, device=cuda)
            d = tdir.build_directory(table)
            shape = f"k={k} M={m}"
            live, max_key = m, int(table[-1, 0])
            time_it("dir wide", shape, lambda: tdir.build_directory(
                table, live, max_key))
            for form, keys, w in (("K7", flat, None),
                                  ("K7 weighted", uniq, weights)):
                acc.zero_()
                probe.probe_tally_wide(keys, table, acc, w, d)
                check(f"{form} {shape}", acc, ref)
                time_it(form, shape, lambda: probe.probe_tally_wide(
                    keys, table, acc, w, d))
            check(f"K8 {shape}", member.probe_member_wide(flat, table, d),
                  ref_found)
            check(f"K8 rows {shape}",
                  member.probe_rows_wide(flat, table, d), ref_rows)
            time_it("K8", shape, lambda: member.probe_member_wide(
                flat, table, d))
            time_it("K8 rows", shape, lambda: member.probe_rows_wide(
                flat, table, d))
            del table, acc, ref, ref_found, ref_rows, d

    def k9d(label, flat):
        """K9d on *flat*, checked against its plain version; its
        unordered form against the weight sums of the plain version's."""
        ref = dev.segment_runs(segsort.segments(flat, keys64.SENTINEL))
        got = segsort.seg_dedup(flat)
        check(f"K9d {label} counts", got[2], ref[2])
        for g, w in zip(dev.segment_compact(*got), dev.segment_compact(*ref)):
            check(f"K9d {label} rows", g, w)
        time_it("K9d", f"k=31 {label}", lambda: segsort.seg_dedup(flat))
        got = segsort.seg_dedup(flat, ordered=False)
        for g, w in zip(segment_sums(*got[:3]), segment_sums(*ref)):
            check(f"K9d unordered {label}", g, w)
        print(f"{args.tag:8s} K9d unordered k=31 {label}: "
              f"{int(got[3].sum())} of {got[3].numel()} segments "
              f"passed through", flush=True)
        time_it("K9d unordered", f"k=31 {label}",
                lambda: segsort.seg_dedup(flat, ordered=False))

    def probes(label, codes, lengths, flat, group):
        """K2, K3 (flat and slots) and K4 at k = 31 on *flat* (and K4 on
        *group*) at each of PROBE_MS table keys; K9d on *flat*; the step
        from *codes* to the tally at STEP_M keys."""
        uniq, weights = dev.dedup_windows(flat)
        slots = segsort.seg_dedup(flat)
        slots_u = segsort.seg_dedup(flat, ordered=False)[:3]
        for m in PROBE_MS if wanted & {"K2", "K3", "K4", "step"} else ():
            if m != STEP_M and not wanted & {"K2", "K3", "K4"}:
                continue
            table = table_of(flat, 31, m)
            d = tdir.build_directory(table)
            acc = torch.zeros(table.shape[0], dtype=torch.int64, device=cuda)
            ref = dev.small_table_tally(table, flat)
            probe.probe_tally(flat, table, acc, d)
            check(f"K2 {label} M={m}", acc, ref)
            shape = f"k=31 M={m} {label}"
            time_it("K2", shape,
                    lambda: probe.probe_tally(flat, table, acc, d))
            for form, keys in (("batch", flat), ("group", group)):
                if keys is None or "K4" not in wanted:
                    continue
                check(f"K4 {form} {label} M={m}",
                      member.probe_member(keys, table, d),
                      dev.member(table, keys))
                time_it(f"K4 {form}", shape,
                        lambda: member.probe_member(keys, table, d))
            acc = torch.zeros_like(acc)
            probe.probe_tally_weighted(uniq, weights, table, acc, d)
            check(f"K3 flat {label} M={m}", acc, ref)
            time_it("K3 flat", shape, lambda: probe.probe_tally_weighted(
                uniq, weights, table, acc, d))
            for form, (s_keys, s_weights, s_counts) in (
                    ("K3 slots", slots), ("K3 slots unordered", slots_u)):
                acc.zero_()
                probe.probe_tally_weighted(s_keys, s_weights, table, acc, d,
                                           s_counts)
                check(f"{form} {label} M={m}", acc, ref)
                time_it(form, shape, lambda: probe.probe_tally_weighted(
                    s_keys, s_weights, table, acc, d, s_counts))
            if m == STEP_M and "step" in wanted:
                steps(label, codes, lengths, table, d, ref)
            del table, acc, ref, d
        if "K9d" in wanted:
            k9d(label, flat)

    def steps(label, codes, lengths, table, d, ref):
        """K1's keys to the tally in each form, checked against *ref*."""

        def keys():
            return extract.extract_canonical(codes, lengths, 31).reshape(-1)

        def slots_step(acc):
            s_keys, s_weights, s_counts = segsort.seg_dedup(keys())
            return probe.probe_tally_weighted(s_keys, s_weights, table, acc,
                                              d, s_counts)

        def unordered_step(acc):
            s_keys, s_weights, s_counts, _ = segsort.seg_dedup(
                keys(), ordered=False)
            return probe.probe_tally_weighted(s_keys, s_weights, table, acc,
                                              d, s_counts)

        forms = {
            "K1->K2": lambda acc: probe.probe_tally(keys(), table, acc, d),
            "K1->dedup->K3": lambda acc: probe.probe_tally_weighted(
                *dev.dedup_windows(keys()), table, acc, d),
            "K1->K9d->K3": slots_step,
            "K1->K9d unordered->K3": unordered_step,
        }
        for name, step in forms.items():
            acc = torch.zeros_like(ref)
            step(acc)
            check(f"step {name} {label}", acc, ref)
            time_it("step", f"{name} M={table.shape[0]} {label}",
                    lambda: step(acc))

    def k9(label, flat):
        """K9 with and without its payload on *flat*, checked against its
        plain version (every (key, payload) pair once)."""
        from kmer_denovo_filter_tpu_torch.experiments.x_fused import (
            pair_order,
        )
        payload = torch.arange(flat.numel(), dtype=torch.int32, device=cuda)
        keys, pay = segsort.seg_sort(flat, payload)
        ref_keys, ref_pay = dev.segment_sort(
            segsort.segments(flat, keys64.SENTINEL),
            segsort.segments(payload, -1))
        check(f"K9 {label} keys", keys, ref_keys)
        for got, ref in zip(pair_order(keys, pay),
                            pair_order(ref_keys, ref_pay)):
            check(f"K9 {label} pairs", got, ref)
        time_it("K9", f"k=31 {label}", lambda: segsort.seg_sort(flat, payload))
        time_it("K9 keys", f"k=31 {label}", lambda: segsort.seg_sort(flat))

    def k10(k, flat):
        """K10 and the whole route of one source, as the module says."""
        from kmer_denovo_filter_tpu_torch.parallel import sharded
        for s in ROUTE_SHARDS:
            shape = f"k={k} S={s}"
            for part, g, r in zip(("order", "sizes", "rows"),
                                  route.route(flat, s),
                                  route.plain_route(flat, s)):
                check(f"K10 {shape} {part}", g, r)
            time_it("K10", shape, lambda: route.route(flat, s))
            time_it("K10 route", shape, lambda: sharded._gather_by_owner(
                [flat], [cuda] * s))

    def k11(k):
        """K11, and the host words to keys on the card through it."""
        w = -(-k // 16)
        for m in K11_MS:
            words = rng.integers(0, 1 << 32, (m, w), dtype=np.uint64)
            words = words.astype(np.uint32)
            shape = f"k={k} M={m}"
            dev_words = convert.words_tensor(words).to(cuda)
            check(f"K11 {shape}", convert.words_to_keys(dev_words, k),
                  convert.plain_words_to_keys(dev_words, k))
            time_it("K11", shape, lambda: convert.words_to_keys(dev_words, k))
            del dev_words
            time_it("K11 keys", shape, lambda: convert.words_to_keys(
                convert.words_tensor(words).to(cuda), k))

    def k12(label, k, flat):
        """K12 on the keys (rows) *flat*, checked against its plain
        version, and the plain version."""
        wide = flat.dim() == 2
        plain = dev.sort_count_wide if wide else dev.sort_count
        fn = sortcount.sort_count_wide if wide else sortcount.sort_count
        shape = f"k={k} {label}"
        for part, g, r in zip(("keys", "counts"), fn(flat, k), plain(flat)):
            check(f"K12 {shape} {part}", g, r)
        time_it("K12", shape, lambda: fn(flat, k))
        time_it("K12 plain", shape, lambda: plain(flat))

    def k9dw(label, k, flat):
        """K9dw on the (N, Q) rows *flat* in both forms, checked against
        its plain version; the whole-batch dedups."""
        got = segsort.seg_dedup_wide(flat)
        ref = dev.segment_runs_wide(segsort.segments(flat, keys64.SENTINEL))
        check(f"K9dw k={k} {label} counts", got[2], ref[2])
        for g, w in zip(dev.segment_compact(*got), dev.segment_compact(*ref)):
            check(f"K9dw k={k} {label} rows", g, w)
        time_it("K9dw", f"k={k} {label}",
                lambda: segsort.seg_dedup_wide(flat))
        got = segsort.seg_dedup_wide(flat, ordered=False)
        for g, w in zip(segment_sums(*got[:3]), segment_sums(*ref)):
            check(f"K9dw unordered k={k} {label}", g, w)
        print(f"{args.tag:8s} K9dw unordered k={k} {label}: "
              f"{int(got[3].sum())} of {got[3].numel()} segments "
              f"passed through", flush=True)
        time_it("K9dw unordered", f"k={k} {label}",
                lambda: segsort.seg_dedup_wide(flat, ordered=False))
        time_it("K9dw batch", f"k={k} {label}",
                lambda: dev.dedup_windows_wide(flat))
        time_it("K9dw unique", f"k={k} {label}", lambda: torch.unique(
            flat, dim=0, sorted=True, return_counts=True))

    def wide_step(label, k, codes, lengths):
        """K1w's rows to the tally at WSTEP_M[k] table rows in each form,
        checked against the plain tally."""
        flat = extract.extract_canonical_wide(codes, lengths, k).flatten(0, 1)
        m = WSTEP_M[k]
        table = wide_table(flat, k, m)
        d = tdir.build_directory(table)
        ref = dev.small_table_tally_wide(table, flat)

        def keys():
            return extract.extract_canonical_wide(codes, lengths,
                                                  k).flatten(0, 1)

        for form, ordered in (("K7 slots", True),
                              ("K7 slots unordered", False)):
            s_keys, s_weights, s_counts = segsort.seg_dedup_wide(
                flat, ordered=ordered)[:3]
            acc = torch.zeros_like(ref)
            probe.probe_tally_wide(s_keys, table, acc, s_weights, d, s_counts)
            check(f"{form} k={k} {label}", acc, ref)
            time_it("wstep", f"{form} k={k} M={m} {label}",
                    lambda: probe.probe_tally_wide(s_keys, table, acc,
                                                   s_weights, d, s_counts))

        def dedup_step(acc):
            uniq, weights = dev.dedup_windows_wide(keys())
            return probe.probe_tally_wide(uniq, table, acc, weights, d)

        def slots_step(acc, ordered=True):
            s_keys, s_weights, s_counts = segsort.seg_dedup_wide(
                keys(), ordered=ordered)[:3]
            return probe.probe_tally_wide(s_keys, table, acc, s_weights, d,
                                          s_counts)

        forms = {
            "K1w->K7": lambda acc: probe.probe_tally_wide(keys(), table, acc,
                                                          None, d),
            "K1w->dedup->K7w": dedup_step,
            "K1w->K9dw->K7": slots_step,
            "K1w->K9dw unordered->K7": lambda acc: slots_step(acc, False),
        }
        for name, step in forms.items():
            acc = torch.zeros_like(ref)
            step(acc)
            check(f"wstep {name} k={k} {label}", acc, ref)
            time_it("wstep", f"{name} k={k} M={m} {label}",
                    lambda: step(acc))
        del table, d, ref

    rng = np.random.default_rng(0)
    batches = {}
    for length in (L, L_K201):
        codes, lengths = random_batch(rng, length)
        batches[length] = (torch.from_numpy(codes).to(cuda),
                           torch.from_numpy(lengths).to(cuda))
    row_np = rng.integers(0, 4, (1, ROW), dtype=np.uint8)
    row_np[0, rng.random(ROW) < 0.005] = 4
    row = (torch.from_numpy(row_np).to(cuda),
           torch.tensor([ROW], dtype=torch.int32, device=cuda))

    narrow = {"K1", "K2", "K3", "K4", "K9", "K9d", "step", "K10", "K11",
              "K12"}
    wide = {"K1w", "K7", "K8", "K9dw", "wstep", "dir", "K10", "K11", "K12"}
    for k in (31, 33, 63, 127, 151, 201):
        if not wanted & (narrow if k <= 31 else wide):
            continue
        codes, lengths = batches[L_K201 if k == 201 else L]
        if k <= 31:
            name, kernel = "K1", extract.extract_canonical
            plain = dev.extract_canonical_windows
        else:
            name, kernel = "K1w", extract.extract_canonical_wide
            plain = dev.extract_canonical_windows_wide
        got = kernel(codes, lengths, k)
        check(f"{name} k={k}", got, plain(codes, lengths, k)[0])
        time_it(name, f"k={k} {codes.shape[1]} bp",
                lambda: kernel(codes, lengths, k))
        if k in (31, 63):
            check(f"{name} k={k} row", kernel(*row, k), plain(*row, k)[0])
            time_it(name, f"k={k} (1, 2**20) row", lambda: kernel(*row, k))
        if k == 31:
            group_codes = torch.full((GROUP * GROUP_B, L), 4,
                                     dtype=torch.uint8, device=cuda)
            for i in range(GROUP):
                part = slice(i * GROUP_B, (i + 1) * GROUP_B)
                group_codes[part, :L - 8 * i] = codes[part, :L - 8 * i]
            group_lengths = torch.cat([
                lengths[i * GROUP_B:(i + 1) * GROUP_B].clamp(max=L - 8 * i)
                for i in range(GROUP)])
            group = kernel(group_codes, group_lengths, k).reshape(-1)
            probes("random", codes, lengths, got.reshape(-1), group)
            if "K9" in wanted:
                k9("random", got.reshape(-1))
        if k in WIDE_MS and wanted & {"K7", "K8", "dir"}:
            wide_probes(k, got.flatten(0, 1))
        if k in (31, 63) and "K10" in wanted:
            k10(k, got.flatten(0, 1) if got.dim() == 3 else got.reshape(-1))
        if k in (31, 63) and "K11" in wanted:
            k11(k)
        if k in (31, 63, 201) and "K12" in wanted:
            k12("random", k,
                got.flatten(0, 1) if got.dim() == 3 else got.reshape(-1))
        if k in WSTEP_M and "K9dw" in wanted:
            k9dw("random", k, got.flatten(0, 1))
        if k in WSTEP_M and "wstep" in wanted:
            wide_step("random", k, codes, lengths)
    rng_40x = np.random.default_rng(4)
    genome = rng_40x.integers(0, 4, 4 << 20, dtype=np.uint8)
    codes = torch.from_numpy(synth_reads(rng_40x, genome, B, L)).to(cuda)
    lengths = torch.full((B,), L, dtype=torch.int32, device=cuda)
    if wanted & narrow:
        probes("40x", codes, lengths,
               extract.extract_canonical(codes, lengths, 31).reshape(-1),
               None)
    if "K9" in wanted:
        k9("40x", extract.extract_canonical(codes, lengths, 31).reshape(-1))
    if "K12" in wanted:
        k12("40x", 31,
            extract.extract_canonical(codes, lengths, 31).reshape(-1))
    if wanted & {"K9dw", "wstep", "K12"}:
        codes_256 = torch.from_numpy(
            synth_reads(rng_40x, genome, B, L_K201)).to(cuda)
        lengths_256 = torch.full((B,), L_K201, dtype=torch.int32,
                                 device=cuda)
        for k, (c, l) in ((63, (codes, lengths)),
                          (201, (codes_256, lengths_256))):
            if "K9dw" in wanted:
                k9dw("40x", k, extract.extract_canonical_wide(
                    c, l, k).flatten(0, 1))
            if "wstep" in wanted:
                wide_step("40x", k, c, l)
            if "K12" in wanted:
                k12("40x", k,
                    extract.extract_canonical_wide(c, l, k).flatten(0, 1))
    print(json.dumps({"timer_ab": args.tag, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
