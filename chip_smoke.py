#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kmer_denovo_filter_tpu_torch`` on the card, phase by phase;
any failure exits non-zero before the result line:

1. Card: ``nvidia-smi`` name and power limit, torch's device name.
2. Build: nvcc builds the kernels from ``kmer_denovo_filter_tpu_torch/csrc``.
3. Kernels against their plain PyTorch versions on the same card,
   exact equality, on 32,768 random reads x 152 bp with N bases and
   ragged lengths: K1 (extract_canonical) at k in {15, 17, 21, 31}, and
   on one (1, 2**20) row at k = 31 (a contig chunk of Module 0); K2
   (probe_tally) at each k and M in {1, 4,096, 262,144} table keys (half
   drawn from the batch), at k = 31 also 2**24; K3
   (probe_tally_weighted) through the table's directory at k = 31 and M
   in {1, 4,096, 262,144, 2**20, 2**24}, on the random batch and on one
   40x-coverage batch (the 3s batch), in both its forms: on the batch's
   whole dedup (``dedup_windows``) and on K9d's slots as they stand; the
   step K9d -> K3 once more with CUDA sync debugging set to raise (no
   host sync).  Times by CUDA events.
3p. The prefix-directory probes at k = 31, on the random batch and on
   one 40x-coverage batch (the 3s batch; its tables drawn from its own
   keys, so K2's atomics repeat as on real reads), at M in {1, 6,207,
   6,208, 10,367, 10,368} (the staged limits +- 1; checked only) and
   {4,096, 262,144, 2**20, 2**24} (timed): the directory
   (build_directory, kdf_build_directory) against its plain version and
   timed apart beside its library call (one ``torch.searchsorted`` of the
   shifted prefixes over the bucket numbers), K2 through it, K4 through it on the flat windows and (on
   the random batch) a stacked group of 8 x 4,096 reads; beside
   ``torch.isin`` for K4 and ``torch.searchsorted(table, keys)``, a
   search-only yardstick (not the same function) for both.
4. Main path, VCF mode: ``kmer-denovo-torch`` (``cli.vcf_main``) on the
   GIAB mini trio in ``tests/data/giab``; the three VCF-mode outputs
   must equal ``tests/goldens`` byte for byte, and K1, K2 and K11 (the
   tables' words to keys) must have been launched during that run.
4b. Main path, discovery: ``kmer-discovery-torch``
   (``cli.discovery_main``) on the same trio with the golden fixture's
   flags; the six text outputs must equal ``tests/goldens/giab_discovery.*``
   byte for byte, K1, K9d, K3, K4, K11 and K12 (the child count) must
   have been launched during that run, and nothing may be written into
   ``tests/data/giab``.
5. Scale: ``FilteredCounter`` on cuda over 16 batches x 32,768 reads x
   152 bp (synthetic 40x-coverage reads, 0.3 % error, seed 0) against
   4,096- and 262,144-key tables; counts must equal the plain path on
   the same card.  Reads/s for both.
5b. Discovery scale, same batches: the parent filter at M = 2**24,
   2**27 and 2**28 (all the batches' distinct keys, filled with random
   keys) in both engine forms, K1 -> K2 and K1 -> K9d -> K3 (the dedup
   form), each equal to the plain path; the anchoring scan
   (``scan_reads_for_hits_many``) over groups of 8 x 4,096 reads at
   M = 2**20, equal to the plain path.  Reads/s.
3s. Segment-local sort and dedup: K9 (seg_sort, with and without its
   payload) and K9d (seg_dedup) against their plain versions
   (``torch.sort(dim=1)`` with the payload gathered; a per-segment
   run-length count) on the phase-3 random batch and on one
   40x-coverage batch at k = 31 (488 segments of 8,192 windows each),
   beside ``torch.sort(dim=1)`` and ``dedup_windows`` (a whole-batch
   ``torch.unique``); K9dw (seg_dedup_wide) against its plain version
   at k = 63 and 201 on a random and a 40x batch (152 bp, 256 bp at
   k = 201), beside the whole-batch ``dedup_windows_wide`` and
   ``torch.unique(dim=0)``.  Exact; CUDA events.
3w. Wide keys (k = 33..207, rows of Q = ceil(k / 31) int64 limbs):
   K1w (extract_canonical_wide) at k in {33, 63, 127, 151, 201} on
   32,768 random reads of 152 bp (256 bp at k = 201), with N bases and
   ragged lengths, and on one (1, 2**20) row at k = 63; at k = 63 and M
   in {4,096, 262,144, 2**24}, and at k = 201 and M in {4,096, 2**22},
   the prefix directory over limb 0 (build_directory of the (M, Q)
   table, built once per table as ``KmerIndex`` builds it) against its
   plain version and timed, and through it K7 (probe_tally_wide)
   unweighted on the flat windows and weighted on their dedup and on
   K9dw's slots, K8 (probe_member_wide) found bytes and rows; the batch
   dedup both ways (Q stable sorts and ``torch.unique(dim=0)``); the
   step K1w -> K9dw -> K7 on the slots once with CUDA sync debugging set
   to raise (no host sync).  Exact; CUDA events.
3r. K10 (``route.route``, the sharded engine's route) against its plain
   version (order, sizes, routed rows) on rows of 1..7 limbs at N = 0,
   1, 4,097, 8,193 and 2**20, random, one key and all sentinels, to 1..
   1,023 shards with the sentinel bucket and 4 and 1,024 without, a
   strided view and the K1 / K1w keys of a batch; K11
   (``convert.words_to_keys``) against its plain version and the numpy
   conversion at every odd k 3..207 (also from a view one word into its
   storage, and no row), timed at 2**24 keys, k = 31 and 63, beside the
   words' pageable upload.  Exact.
3c. K12 (``sortcount.sort_count`` / ``sort_count_wide``, the stream
   count's sort-count: K9d or K9dw, then a merge tree over their sorted
   segments and a run combine) against its plain version
   (``torch.unique``; Q stable sorts): the phase-3 random batch and a
   40x batch at k = 15 and 31, random batches at k = 33, 63, 127, 201,
   207 (256 bp from k = 201) and 40x batches at k = 63 and 201, the (1,
   2**20) row at k = 31 and 63, N = 0, 1 and 8,193, one key repeated,
   all sentinels, 2**20 distinct keys; at k = 31, 63 and 201 one
   segment, S = 3 and 17, one read repeated, 40 copies of a batch.
   Timed at k = 31, 63 and 201 (the call with its one sync, its
   launches alone and K9d's / K9dw's share) beside the plain version
   and ``torch.unique`` (``dim=0`` for rows).  Exact.
4c. Main path, wide: ``kmer-denovo-torch`` and ``kmer-discovery-torch``
   with ``--kmer-size 63`` on the GIAB trio, each on a copy of
   ``mini_ref.fa`` (Module 0 counts the FASTA at k > 31 and caches it
   beside it); the same pipelines on ``device="cpu"`` (the plain
   versions) must give byte-equal outputs (3 + 6), and K1w, the
   directory builder, K7 in both forms, K9dw, K8 and K12 must have been
   launched during the card runs.
4d. Both CLIs as one process of a multi-host run: ``KDF_COORDINATOR``
   (127.0.0.1, a free port), ``KDF_NUM_PROCESSES=1``,
   ``KDF_PROCESS_ID=0``, so each joins an NCCL group on cuda:0; their
   3 + 6 outputs must equal phases 4 and 4b byte for byte, then
   ``kmer-report-torch`` (``cli.report_main``) writes its HTML from
   them.  The group is destroyed after.
5c. Wide scale, phase-5 recipe: the parent filter at k = 63, M = 2**24
   (every distinct key of the 16 batches plus random fill) and at
   k = 201, M = 2**22 on 3 batches of 256 bp reads, in three forms
   interleaved: the engine's two (K1w -> K7 and K1w -> K9dw -> K7 on the
   slots) and a whole-batch dedup (``experiments.x_join_variants.
   WideBatchDedupCounter``: K1w -> ``dedup_windows_wide`` -> K7
   weighted), each equal to the plain path; the anchoring scan at
   k = 63, M = 2**20, in groups of 8 x 4,096.  Reads/s.
5d. The parent filter of 5b in a third form, with a whole-batch dedup
   (``experiments.x_join_variants.BatchDedupCounter``: K1 ->
   ``dedup_windows``, a ``torch.unique`` -> K3 on the flat stream),
   interleaved with the two engine forms on the same batches at each M,
   all three equal to the plain path.  Reads/s.  K9d's launches are
   counted over the 5b/5d filter loops.
6. Profile: the phase-5, 5b, 5d and 5c loops (5c at k = 63, all three
   forms) once more under
   ``torch.profiler``; device busy time (union of kernel and copy
   spans), each device op's ms per batch, and the device's idle share
   against the loop's wall time with and without the profiler.

8. The sharded engine (``parallel.sharded``) on one card: the mesh
   ``[cuda:0] * S`` for S = 1, 2, 4, at k = 31 and 63, an M = 2**20
   table (half of it keys of the first phase-5 batch), the phase-5
   batches: ``ShardedFilteredCounter`` (both forms) equal to
   ``FilteredCounter``, ``ShardedKmerIndex.membership`` to
   ``KmerIndex.membership`` (2**20 windows of a batch, sentinels
   included), ``sharded_scan_reads_for_hits`` to ``scan_reads_for_hits``
   (8,192 reads), ``sharded_count`` to ``StreamCounter`` (a batch), on a
   homopolymer batch (one owner takes every key) and an empty batch;
   each shard's launches counted exactly (K10 a source and a table
   slice, K11 a slice and a query).  Reads/s of both forms at S = 1, 2, 4
   beside the single-device form's, interleaved, and the routing share
   of a batch's feed; the route of one batch split into the plain
   version's steps, beside K10 and the library pair (``argsort`` +
   ``bincount``).  The stream count over 2 and 4 shards equal to
   ``StreamCounter``'s, with both rates; K12 launched by every shard of
   a batch's ``sharded_count``.  The stream count's split
   (``phase_8_stream_split``, after 8b): ``StreamCounter`` over the 16
   phase-5 batches at k = 31 and 63 and 3 batches of 256 bp at k = 201,
   fed step by step (upload, K1 / K1w, the device sort-count, the call
   with its sync, DtoH, ``_add_chunk``, each merge with its rows,
   ``result()`` and its conversion to words), with the parent's step
   (the plain version) and with K12, at the 2**24 merge floor and at
   2**21, each equal to the engine's own loop, whose reads/s it prints.
   The index's build time, one
   device and S = 4, at M = 2**20, 2**22, 2**24 (k = 31) and 2**20,
   2**22 (k = 63), and its steps timed alone (the words' upload, K11,
   the table routed, the host gather of the shards' words).
8b. A one-process NCCL group (``multihost.initialize``, tcp://127.0.0.1,
   world size 1): ``sum_aligned`` on a CUDA tensor,
   ``sharded_count_multihost`` (its ``all_to_all_single`` on the card)
   and ``merge_counts_sharded`` of two halves at k = 31 and 63 equal to
   the single-process results, K12 launched; then
   ``destroy_process_group``.
7. Experiments: every command of ``experiments.x_fused`` (sort, prof,
   transposed, unroll2, anatomy, variants, steps, super, sprof) and
   ``experiments.x_join_variants`` (v5, kernel, xextract, xextract3,
   xmicro, sort, pieces5, prof5, xfloor, v5m, v5w) once, in this
   process, with 3 timed repetitions (the WGS table built once for all);
   a false parity line, or a command with none, fails the run.  The
   phase's seconds.
9. Entry points (``kmer_denovo_filter_tpu_torch.entry``): ``entry()``'s
   step K1 -> K2 on the card, on its example arguments and on a table of
   a third of the batch's window keys, equal to the same step on CPU
   copies (the plain versions), K1 and K2 launched; then
   ``dryrun_multichip`` over ``make_mesh()`` of every local card and,
   with one card, over ``[cuda:0] * 4`` through ``mesh=``.

The line before the last is ``{"kernels": [...]}`` with each kernel's
launches in phases 4 and 4b (phase 4c for the wide kernels and K9dw,
the directory builder, K11 and K12 in 4, 4b and 4c; phases 5d and 7
for K9;
phases 8 and 8b for K10, whose path is the sharded engine),
those of phases 4d, 8, 8b and 9 apart under ``launches_by_phase``, its
largest deviation from the plain version, its time beside the plain
version's, its bound (the larger of the bytes this run's data makes it
move over 3.35 TB/s and its operations over 67 T/s; the directory of a
wide table reads a 32-byte sector a row) and the time of a PyTorch call
that computes the same function where there is one; the
last line is ``{"ok": true, "device": {...}}``.
"""

import gzip
import json
import os
import shutil
import socket
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
BIG_M = 1 << 24
K3_MS = (1, 4096, 262144, 1 << 20, BIG_M)
FILTER_MS = (BIG_M, 1 << 27, 1 << 28)  # 128 MB, 1 GB and 2 GB tables
GROUP, GROUP_B = 8, 4096
SCAN_M = 1 << 20
SCALE_BATCHES = 16
SCALE_TABLE_MS = (4096, 262144)
KS_WIDE = (33, 63, 127, 151, 201)
L_K201 = 256  # 2 x 250 bp Illumina reads, as bench.py runs k = 201
ROW = 1 << 20  # the contig chunk of StreamCounter.feed_sequence
WIDE_TABLE_MS = {63: (4096, 262144, BIG_M), 201: (4096, 1 << 22)}
WIDE_FILTER_M = {63: BIG_M, 201: 1 << 22}
WIDE_BATCHES = {63: SCALE_BATCHES, 201: 3}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
# H100 SXM float32 peak outside the tensor cores: no integer rate is
# published, and an int64 compare is no cheaper, so the count over it is
# a floor
OPS_PER_S = 67e12
DISCOVERY_OUTPUTS = ("bed", "kmer_coverage.bedgraph", "read_coverage.bed",
                     "metrics.json", "summary.txt", "sv.bedpe")
COVERAGE = 40
ERROR_RATE = 0.003
GENOME_BASES = 4 << 20


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def max_abs_err(got, ref):
    if torch.equal(got, ref):
        return 0
    return float((got.double() - ref.double()).abs().max())


def bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least device time for work
    that moves *n_bytes* and does *n_ops* operations, at the card's
    peaks."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def probe_bound(key_bytes, row_bytes, keys, table, sentinel, extra_bytes=0):
    """Bound of a probe of *keys* into *table*: *key_bytes* per key
    (inputs and per-key outputs) plus *row_bytes* per distinct table row
    the keys hit plus *extra_bytes*, and ceil(log2(M + 1)) + 1 compares
    per live key."""
    rows_hit = int(torch.isin(table, keys).sum())
    n_ops = int((keys != sentinel).sum()) * (table.numel().bit_length() + 1)
    return bound(key_bytes * keys.numel() + row_bytes * rows_hit
                 + extra_bytes, n_ops)


def random_batch(rng, length=L):
    """Random codes with ~0.5 % N, 10 % ragged rows, some shorter than k."""
    codes = rng.integers(0, 4, (B, length), dtype=np.uint8)
    codes[rng.random((B, length)) < 0.005] = 4
    lengths = np.full(B, length, np.int32)
    ragged = rng.random(B) < 0.1
    lengths[ragged] = rng.integers(0, length + 1, int(ragged.sum()))
    return codes, lengths


def make_table(rng, batch_keys, m, k, sentinel, device, n_from=None):
    """Sorted unique (m,) int64 table: *n_from* (default half) of the
    distinct live batch keys, the rest random keys, drawn on *device*
    from a generator seeded by *rng*."""
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 62)))
    live = torch.unique(batch_keys[batch_keys != sentinel])
    n_from = max(1, m // 2) if n_from is None else n_from
    from_batch = live[torch.randperm(live.numel(), generator=gen,
                                     device=device)[:n_from]]
    n_rand = m - from_batch.numel()
    rand = torch.randint(0, 4 ** k, (2 * n_rand + 16,), generator=gen,
                         device=device)
    rand = torch.unique(rand[~torch.isin(rand, from_batch)])
    rand = rand[torch.randperm(rand.numel(), generator=gen,
                               device=device)[:n_rand]]
    table = torch.sort(torch.cat([from_batch, rand])).values
    if table.numel() != m or torch.unique(table).numel() != m:
        fail(f"table construction gave {table.numel()} keys, wanted {m}")
    return table


def stack_group(batches, fill=4):
    """(codes, lengths) of a group of batches stacked as the engine's
    scan_reads_for_hits_many does: rows concatenated, padded to the
    widest batch with code 4."""
    width = max(c.shape[1] for c, _ in batches)
    codes = np.full((sum(c.shape[0] for c, _ in batches), width), fill,
                    dtype=np.uint8)
    row = 0
    for c, _ in batches:
        codes[row:row + c.shape[0], :c.shape[1]] = c
        row += c.shape[0]
    return codes, np.concatenate([l for _, l in batches])


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


def describe_directory(label, index):
    """Prints the prefix directory *index* holds: bits, shift and the
    largest bucket (none on the CPU device)."""
    d = index.directory
    if d is None:
        return
    largest = int((d.offsets[1:] - d.offsets[:-1]).max())
    print(f"{label} directory of the {d.live}-row table: bits {d.bits}, "
          f"shift {d.shift}, largest bucket {largest} rows", flush=True)


def profile_loop(label, n_batches, run, wall_unprofiled, card):
    """Run *run* once more under torch.profiler and print the device's
    busy time, idle share and per-op device ms per batch."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f"[6] profile {label}: the profiler recorded no device "
              "events; device busy time not measured", flush=True)
        return
    busy_us, end = 0.0, float("-inf")
    per_op = {}
    for lo, hi, name in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        per_op[name] = per_op.get(name, 0.0) + (hi - lo)
    busy = busy_us / 1e6
    ops = "; ".join(f"{name} {us / 1e3 / n_batches:.4f}"
                    for name, us in sorted(per_op.items()))
    print(f"[6] profile {label}: device busy {busy * 1e3:.3f} ms; loop "
          f"wall {wall_prof * 1e3:.3f} ms profiled, "
          f"{wall_unprofiled * 1e3:.3f} ms unprofiled; idle share "
          f"{1 - busy / wall_prof:.4f} profiled, "
          f"{1 - busy / wall_unprofiled:.4f} against the unprofiled wall; "
          f"device ms per batch: {ops} ({card})", flush=True)


def make_table_wide(rng, flat, m, k, device, n_from=None):
    """Sorted unique (m, Q) limb-row table: *n_from* (default half) of the
    distinct live rows of *flat*, the rest random rows, drawn on
    *device* from a generator seeded by *rng*."""
    from kmer_denovo_filter_tpu_torch.ops import device as dev
    from kmer_denovo_filter_tpu_torch.ops import keys as keys64
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 62)))
    live = dev.unique_rows(flat[flat[:, 0] != keys64.SENTINEL])[0]
    n_from = max(1, m // 2) if n_from is None else n_from
    from_batch = live[torch.randperm(live.shape[0], generator=gen,
                                     device=device)[:n_from]]
    n_rand = m - from_batch.shape[0]
    rand = torch.stack([torch.randint(0, 4 ** nb, (2 * n_rand + 16,),
                                      generator=gen, device=device)
                        for nb in keys64.limb_bases(k)], 1)
    rand = dev.unique_rows(
        rand[~dev.member_wide(dev.unique_rows(from_batch)[0], rand)])[0]
    rand = rand[torch.randperm(rand.shape[0], generator=gen,
                               device=device)[:n_rand]]
    table = dev.unique_rows(torch.cat([from_batch, rand]))[0]
    if table.shape[0] != m:
        fail(f"wide table construction gave {table.shape[0]} rows, "
             f"wanted {m}")
    return table


def extract_row(cuda, check, times, k, label):
    """K1 (k <= 31) or K1w on one (1, 2**20) row with N bases, as
    ``StreamCounter.feed_sequence`` feeds a reference contig: exact
    against the plain version, timed beside it.  Its own generator, so
    the other phases draw what they drew before."""
    from kmer_denovo_filter_tpu_torch.ops import device as dev
    from kmer_denovo_filter_tpu_torch.ops import extract
    from kmer_denovo_filter_tpu_torch.ops.timing import device_ms
    rng = np.random.default_rng(k)
    codes_np = rng.integers(0, 4, (1, ROW), dtype=np.uint8)
    codes_np[0, rng.random(ROW) < 0.005] = 4
    codes = torch.from_numpy(codes_np).to(cuda)
    lengths = torch.tensor([ROW], dtype=torch.int32, device=cuda)
    if k <= 31:
        name, kernel = "extract_canonical", extract.extract_canonical
        plain = dev.extract_canonical_windows
    else:
        name, kernel = "extract_canonical_wide", extract.extract_canonical_wide
        plain = dev.extract_canonical_windows_wide
    got = kernel(codes, lengths, k)
    check(name, got, plain(codes, lengths, k)[0], f"k={k}, one row of {ROW}")
    ms = device_ms(lambda: kernel(codes, lengths, k))
    plain_ms = device_ms(lambda: plain(codes, lengths, k), reps=5)
    q = 1 if got.dim() == 2 else got.shape[2]
    n_win = got.shape[1]
    # as in phases 3 and 3w: 6 operations a K1 window, 5Q + 1 a K1w window
    lim = bound(codes.numel() + 4 + 8 * got.numel(),
                (6 if q == 1 else 5 * q + 1) * n_win)
    times[(name, k, "row")] = (ms, plain_ms, lim)
    print(f"[{label}] {'K1' if q == 1 else 'K1w'} k={k} one row of {ROW} "
          f"bases: equal ({n_win} windows); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {lim[0]:.4f} ms by {lim[1]}", flush=True)


def wide_probe_bound(key_bytes, row_bytes, keys, rows_hit, m,
                     extra_bytes=0):
    """Bound of a wide probe of (N, Q) *keys* into an M-row table:
    *key_bytes* per key plus *row_bytes* per distinct table row hit plus
    *extra_bytes*, and (ceil(log2(M + 1)) + 1) * Q compares per live
    key."""
    n_live = int((keys[:, 0] != torch.iinfo(torch.int64).max).sum())
    n_ops = n_live * (m.bit_length() + 1) * keys.shape[1]
    return bound(key_bytes * keys.shape[0] + row_bytes * rows_hit
                 + extra_bytes, n_ops)


def phase_3w(rng, cuda, check, times):
    """Wide kernels against their plain versions, timed beside them; K7
    and K8 through the directory over limb 0, built once per table as
    ``KmerIndex`` builds it."""
    from kmer_denovo_filter_tpu_torch.ops import device as dev
    from kmer_denovo_filter_tpu_torch.ops import directory as tdir
    from kmer_denovo_filter_tpu_torch.ops import extract, member, probe
    from kmer_denovo_filter_tpu_torch.ops import segsort
    from kmer_denovo_filter_tpu_torch.ops.timing import device_ms
    for k in KS_WIDE:
        length = L_K201 if k == 201 else L
        codes_np, lengths_np = random_batch(rng, length)
        codes = torch.from_numpy(codes_np).to(cuda)
        lengths = torch.from_numpy(lengths_np).to(cuda)
        got = extract.extract_canonical_wide(codes, lengths, k)
        check("extract_canonical_wide", got,
              dev.extract_canonical_windows_wide(codes, lengths, k)[0],
              f"k={k}")
        ms = device_ms(
            lambda: extract.extract_canonical_wide(codes, lengths, k))
        plain_ms = device_ms(
            lambda: dev.extract_canonical_windows_wide(codes, lengths, k))
        q = got.shape[2]
        n_win = got.shape[0] * got.shape[1]
        # codes and lengths read, limb rows written; per window a rolling
        # shift-or pair per limb and strand, a compare per limb, the
        # validity test: 5Q + 1 operations
        lim = bound(codes.numel() + 4 * B + 8 * got.numel(),
                    (5 * q + 1) * n_win)
        times[("extract_canonical_wide", k)] = (ms, plain_ms, lim)
        live = int((got[..., 0] != torch.iinfo(torch.int64).max).sum())
        print(f"[3w] K1w k={k} Q={q} ({length} bp): equal ({n_win} windows, "
              f"{live} live); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {lim[0]:.4f} ms by {lim[1]}", flush=True)
        if k == 63:
            extract_row(cuda, check, times, k, "3w")
        if k not in WIDE_TABLE_MS:
            continue
        flat = got.flatten(0, 1)
        uniq, weights = dev.dedup_windows_wide(flat)
        lib_uniq, lib_counts = torch.unique(flat, dim=0, sorted=True,
                                            return_counts=True)
        if not (torch.equal(uniq, lib_uniq)
                and torch.equal(weights, lib_counts)):
            fail(f"dedup_windows_wide differs from torch.unique at k={k}")
        slots = segsort.seg_dedup_wide(flat)
        live_slots = dev.segment_compact(*slots)[0]
        n_segs = slots[2].numel()
        sort_ms = device_ms(lambda: dev.dedup_windows_wide(flat), reps=5)
        unique_ms = device_ms(lambda: torch.unique(
            flat, dim=0, sorted=True, return_counts=True), reps=3)
        print(f"[3w] k={k} batch dedup of {flat.shape[0]} rows to "
              f"{uniq.shape[0]}: Q stable sorts {sort_ms:.4f} ms, "
              f"torch.unique(dim=0) {unique_ms:.4f} ms", flush=True)
        for m in WIDE_TABLE_MS[k]:
            table = make_table_wide(rng, flat, m, k, cuda)
            # as KmerIndex: live rows and the last live limb 0 are known
            # on the host (these tables hold no sentinel row)
            max_key = int(table[-1, 0])
            d = tdir.build_directory(table, m, max_key)
            check("build_directory", d.offsets,
                  tdir.plain_directory(table, m, d.bits, d.shift),
                  f"k={k}, M={m}, over limb 0")
            reps = 3 if m > 262144 else 20
            ref = dev.small_table_tally_wide(table, flat)
            acc = torch.zeros(m, dtype=torch.int64, device=cuda)
            probe.probe_tally_wide(flat, table, acc, directory=d)
            check("probe_tally_wide", acc, ref, f"k={k}, M={m}")
            acc_w = torch.zeros_like(acc)
            probe.probe_tally_wide(uniq, table, acc_w, weights, d)
            check("probe_tally_wide_weighted", acc_w, ref, f"k={k}, M={m}")
            acc_w.zero_()
            probe.probe_tally_wide(slots[0], table, acc_w, slots[1], d,
                                   slots[2])
            check("probe_tally_wide_weighted", acc_w, ref,
                  f"k={k}, M={m}, K9dw's slots")
            if m == WIDE_TABLE_MS[k][-1]:
                acc_w.zero_()
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    step = segsort.seg_dedup_wide(
                        extract.extract_canonical_wide(codes, lengths,
                                                       k).flatten(0, 1))
                    probe.probe_tally_wide(step[0], table, acc_w, step[1], d,
                                           step[2])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                check("probe_tally_wide_weighted", acc_w, ref,
                      f"k={k}, M={m}, K1w -> K9dw -> K7 with sync debugging "
                      "on")
                print(f"[3w] k={k} M={m}: K1w -> K9dw -> K7 on the slots "
                      "equal to plain with CUDA sync debugging set to "
                      "raise: no host sync", flush=True)
                del step
            found = member.probe_member_wide(flat, table, d)
            check("probe_member_wide", found, dev.member_wide(table, flat),
                  f"k={k}, M={m}")
            check("probe_member_wide", member.probe_rows_wide(flat, table, d),
                  dev.find_rows_wide(table, flat), f"k={k}, M={m}, rows")
            if not bool(found.any()):
                fail(f"probe_member_wide found nothing at k={k}, M={m}")
            largest = int((d.offsets[1:] - d.offsets[:-1]).max())
            print(f"[3w] k={k} M={m}: directory over limb 0 bits {d.bits}, "
                  f"shift {d.shift}, largest bucket {largest} rows; "
                  "directory, K7 both forms (weighted flat and on K9dw's "
                  "slots) and K8 equal to plain",
                  flush=True)
            n_dir = (1 << d.bits) + 1
            ms = device_ms(lambda: tdir.build_directory(table, m, max_key))
            plain_ms = device_ms(lambda: tdir.plain_directory(
                table, m, d.bits, d.shift))
            prefixes = (table[:m, 0] >> d.shift).contiguous()
            buckets = torch.arange(n_dir, dtype=torch.int64, device=cuda)
            lib_ms = device_ms(lambda: torch.searchsorted(prefixes, buckets))
            del prefixes, buckets
            # limb 0 of each live row read: rows lie 8Q B apart, so each
            # costs a 32-byte sector, or the whole row where 8Q < 32;
            # entries written; an entry or row a thread
            lim = bound(min(8 * q, 32) * m + 4 * n_dir, m + n_dir)
            times[("build_directory", "wide", k, m)] = (ms, plain_ms, lim,
                                                        lib_ms)
            print(f"[3w]   build_directory over limb 0: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, torch.searchsorted of the "
                  f"prefixes {lib_ms:.4f} ms, bound {lim[0]:.4f} ms by "
                  f"{lim[1]}", flush=True)
            rows_hit = int((ref > 0).sum())
            # keys (and weights) read; per row hit its limbs read and its
            # count read and written (K7), or found bytes written (K8)
            runs = {
                "probe_tally_wide": (
                    lambda: probe.probe_tally_wide(flat, table, acc,
                                                   directory=d),
                    lambda: acc.add_(dev.small_table_tally_wide(table,
                                                                flat)),
                    wide_probe_bound(8 * q, 8 * q + 16, flat, rows_hit, m)),
                "probe_tally_wide_weighted": (
                    lambda: probe.probe_tally_wide(uniq, table, acc_w,
                                                   weights, d),
                    lambda: dev.weighted_tally_wide(table, uniq, weights,
                                                    acc_w),
                    wide_probe_bound(8 * q + 8, 8 * q + 16, uniq, rows_hit,
                                     m)),
                "probe_tally_wide_slots": (
                    lambda: probe.probe_tally_wide(slots[0], table, acc_w,
                                                   slots[1], d, slots[2]),
                    lambda: dev.weighted_tally_wide(
                        table, *dev.segment_compact(*slots), acc_w),
                    wide_probe_bound(8 * q + 8, 8 * q + 16, live_slots,
                                     rows_hit, m, 4 * n_segs)),
                "probe_member_wide": (
                    lambda: member.probe_member_wide(flat, table, d),
                    lambda: dev.member_wide(table, flat),
                    wide_probe_bound(8 * q + 1, 8 * q, flat, rows_hit, m)),
            }
            for name, (kernel, plain, lim) in runs.items():
                ms = device_ms(kernel)
                plain_ms = device_ms(plain, reps=reps)
                times[(name, k, m)] = (ms, plain_ms, lim)
                print(f"[3w] {name} k={k} M={m}: equal ({rows_hit} rows "
                      f"hit, {int(ref.sum())} hits); kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, bound {lim[0]:.4f} ms by "
                      f"{lim[1]}", flush=True)
            del table, acc, acc_w, ref, d
        del slots, live_slots


def codes_40x(cuda, length=L):
    """(codes, lengths) of one 40x-coverage batch of B reads of *length*
    bp on the card (its own generator, seed 4)."""
    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, GENOME_BASES, dtype=np.uint8)
    return (torch.from_numpy(synth_reads(rng, genome, B, length)).to(cuda),
            torch.full((B,), length, dtype=torch.int32, device=cuda))


def batch_40x(cuda):
    """The flat k = 31 window keys of one 40x-coverage batch of B reads."""
    from kmer_denovo_filter_tpu_torch.ops import extract
    return extract.extract_canonical(*codes_40x(cuda), 31).reshape(-1)


def staged_budget():
    """Bytes of shared memory a block may use with two blocks an SM
    (``kdf::dir_probe_launch``; 1 KB reserved a block)."""
    props = torch.cuda.get_device_properties(0)
    return min(props.shared_memory_per_multiprocessor // 2 - 1024,
               props.shared_memory_per_block_optin)


def phase_3p(batches, cuda, check, times):
    """The directory, K2 and K4 through it at k = 31 against their plain
    versions, at the staged limits +- 1 and, timed beside ``torch.isin``
    and ``torch.searchsorted``, at 4,096, 262,144, 2**20 and 2**24 rows.
    *batches*: {label: (flat keys, stacked-group keys or None)}."""
    from kmer_denovo_filter_tpu_torch.ops import device as dev
    from kmer_denovo_filter_tpu_torch.ops import directory as tdir
    from kmer_denovo_filter_tpu_torch.ops import member, probe
    from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL
    from kmer_denovo_filter_tpu_torch.ops.timing import device_ms
    rng = np.random.default_rng(6)
    budget = staged_budget()
    for label, (flat, flat_g) in batches.items():
        forms = [("batch", flat)] + ([("group", flat_g)] if flat_g is not None
                                     else [])
        for m in (1, 6207, 6208, 10367, 10368, 4096, 262144, SCAN_M, BIG_M):
            timed = m in (4096, 262144, SCAN_M, BIG_M)
            table = make_table(rng, flat, m, 31, SENTINEL, cuda)
            max_key = int(table[-1])
            d = tdir.build_directory(table, m, max_key)
            check("build_directory", d.offsets,
                  tdir.plain_directory(table, m, d.bits, d.shift),
                  f"{label} batch, M={m}")
            largest = int((d.offsets[1:] - d.offsets[:-1]).max())
            s_bits = (m - 1).bit_length()
            # K2 and K4 stage the rows (K2 also 8 B of counts a row) and a
            # uint16 directory at ceil(log2(M)) bits when they fit
            staged = {name: row_bytes * m + 2 * ((1 << s_bits) + 1) <= budget
                      for name, row_bytes in (("K2", 16), ("K4", 8))}
            acc = torch.zeros(m, dtype=torch.int64, device=cuda)
            probe.probe_tally(flat, table, acc, d)
            ref = dev.small_table_tally(table, flat)
            check("probe_tally", acc, ref, f"{label} batch, M={m}")
            for form, keys in forms:
                got = member.probe_member(keys, table, d)
                check("probe_member", got, dev.member(table, keys),
                      f"{label} batch, M={m}, {form}")
                if timed and not bool(got.any()):
                    fail(f"probe_member found nothing at M={m}, {form}")
            print(f"[3p] {label} batch M={m}: directory bits {d.bits}, shift "
                  f"{d.shift}, largest bucket {largest} rows (staged: bits "
                  f"{s_bits}; K2 {'staged' if staged['K2'] else 'global'}, "
                  f"K4 {'staged' if staged['K4'] else 'global'}); "
                  f"directory, K2 ({int(ref.sum())} hits in "
                  f"{int((ref > 0).sum())} rows) and K4 equal to plain",
                  flush=True)
            if not timed:
                continue
            n_dir = (1 << d.bits) + 1
            ms = device_ms(lambda: tdir.build_directory(table, m, max_key))
            plain_ms = device_ms(lambda: tdir.plain_directory(
                table, m, d.bits, d.shift))
            # the library call: one torch.searchsorted of the shifted
            # prefixes over the bucket numbers
            prefixes = (table[:m] >> d.shift).contiguous()
            buckets = torch.arange(n_dir, dtype=torch.int64, device=cuda)
            lib_ms = device_ms(lambda: torch.searchsorted(prefixes, buckets))
            del prefixes, buckets
            # live rows read (8 B each, contiguous), entries written; an
            # entry or row a thread
            lim = bound(8 * m + 4 * n_dir, m + n_dir)
            times[("build_directory", label, m)] = (ms, plain_ms, lim, lib_ms)
            print(f"[3p]   build_directory: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, torch.searchsorted of the prefixes "
                  f"{lib_ms:.4f} ms, bound {lim[0]:.4f} ms by {lim[1]}",
                  flush=True)
            ms = device_ms(lambda: probe.probe_tally(flat, table, acc, d))
            plain_ms = device_ms(
                lambda: acc.add_(dev.small_table_tally(table, flat)))
            search_ms = device_ms(lambda: torch.searchsorted(table, flat))
            # keys read; each row hit: key read, count read and written
            lim = probe_bound(8, 24, flat, table, SENTINEL)
            times[("probe_tally", label, m)] = (ms, plain_ms, search_ms, lim)
            print(f"[3p]   K2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"torch.searchsorted {search_ms:.4f} ms, bound "
                  f"{lim[0]:.4f} ms by {lim[1]}", flush=True)
            for form, keys in forms:
                ms = device_ms(lambda: member.probe_member(keys, table, d))
                plain_ms = device_ms(lambda: dev.member(table, keys))
                isin_ms = device_ms(lambda: torch.isin(keys, table))
                search_ms = device_ms(lambda: torch.searchsorted(table, keys))
                # keys read, found bytes written; each row hit read
                lim = probe_bound(9, 8, keys, table, SENTINEL)
                times[("probe_member", form, label, m)] = (
                    ms, plain_ms, isin_ms, search_ms, lim)
                print(f"[3p]   K4 {form}: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, torch.isin {isin_ms:.4f} ms, "
                      f"torch.searchsorted {search_ms:.4f} ms, bound "
                      f"{lim[0]:.4f} ms by {lim[1]}", flush=True)
            del table, acc, ref, d


def phase_3s(flat_random, flat_40x, cuda, check, times):
    """K9 and K9d against their plain versions, timed beside them and
    the PyTorch calls nearest to them, on the phase-3 random batch and
    on one 40x batch."""
    from kmer_denovo_filter_tpu_torch.experiments.x_fused import pair_order
    from kmer_denovo_filter_tpu_torch.ops import device as dev
    from kmer_denovo_filter_tpu_torch.ops import segsort
    from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL
    from kmer_denovo_filter_tpu_torch.ops.timing import device_ms
    for label, flat in (("random", flat_random), ("40x", flat_40x)):
        payload = torch.arange(flat.numel(), dtype=torch.int32, device=cuda)
        segs = segsort.segments(flat, SENTINEL)
        pays = segsort.segments(payload, -1)
        keys, pay = segsort.seg_sort(flat, payload)
        ref_keys, ref_pay = dev.segment_sort(segs, pays)
        check("seg_sort", keys, ref_keys, f"{label} batch, keys")
        for got, want in zip(pair_order(keys, pay),
                             pair_order(ref_keys, ref_pay)):
            check("seg_sort", got, want,
                  f"{label} batch, (key, payload) pairs per segment")
        keys_only, none = segsort.seg_sort(flat)
        if none is not None:
            fail("seg_sort without a payload returned one")
        check("seg_sort", keys_only, ref_keys, f"{label} batch, no payload")
        raw = segsort.seg_dedup(flat)
        ref = dev.segment_runs(segs)
        check("seg_dedup", raw[2], ref[2], f"{label} batch, counts")
        for got, want in zip(dev.segment_compact(*raw),
                             dev.segment_compact(*ref)):
            check("seg_dedup", got, want, f"{label} batch, rows")
        rows = int(raw[2].sum())
        whole = dev.dedup_windows(flat)[0].numel()

        def library_sort(segs=segs, pays=pays):
            srt, order = torch.sort(segs, dim=1)
            return srt, torch.gather(pays, 1, order)

        n_rows, n_segs = segs.numel(), segs.shape[0]
        # keys and payloads read once and written once; 91 compare-
        # exchange stages of 4,096 pairs a segment
        sort_lim = bound(24 * n_rows, 91 * n_rows // 2)
        # keys read; a key and a weight written per distinct row and a
        # count per segment
        dedup_lim = bound(8 * n_rows + 16 * rows + 4 * n_segs,
                          91 * n_rows // 2)
        sort_ms = device_ms(lambda: segsort.seg_sort(flat, payload))
        keys_ms = device_ms(lambda: segsort.seg_sort(flat))
        sort_plain = device_ms(lambda: dev.segment_sort(segs, pays))
        sort_lib = device_ms(library_sort)
        dedup_ms = device_ms(lambda: segsort.seg_dedup(flat))
        dedup_plain = device_ms(lambda: dev.segment_runs(segs), reps=5)
        dedup_lib = device_ms(lambda: dev.dedup_windows(flat))
        times[("seg_sort", label)] = (sort_ms, sort_plain, sort_lib,
                                      sort_lim)
        times[("seg_dedup", label)] = (dedup_ms, dedup_plain, dedup_lib,
                                       dedup_lim)
        print(f"[3s] K9 {label} batch: equal ({n_segs} segments, "
              f"{flat.numel()} windows); kernel {sort_ms:.4f} ms (without "
              f"the payload {keys_ms:.4f} ms), plain {sort_plain:.4f} ms, "
              f"torch.sort(dim=1) + gather {sort_lib:.4f} ms, bound "
              f"{sort_lim[0]:.4f} ms by {sort_lim[1]}", flush=True)
        print(f"[3s] K9d {label} batch: equal ({rows} segment rows, "
              f"{whole} distinct keys in the whole batch); kernel "
              f"{dedup_ms:.4f} ms, plain {dedup_plain:.4f} ms, "
              f"dedup_windows (whole batch) {dedup_lib:.4f} ms, bound "
              f"{dedup_lim[0]:.4f} ms by {dedup_lim[1]}", flush=True)


def phase_3r(rng, cuda, check, times):
    """K10 (``route.route``) and K11 (``convert.words_to_keys``) against
    their plain versions on the card, exact.  K10: (N, Q) rows of Q = 1..7
    limbs (flat keys at Q = 1) at N = 0, 1, 4,097, 8,193 and 2**20,
    random (every 13th row a sentinel row), one key in every row and
    all sentinel rows, to S = 1, 2, 3, 4, 7, 64 and 1,023 shards with the
    sentinel bucket and to 4 and 1,024 without it; a strided view; the
    K1 / K1w keys of a random 32,768 x 152 bp batch at k = 31 and 63 to
    S = 1, 2, 4: order, sizes and routed rows.  K11: 4,097 random rows
    of words (every 5th the sentinel) at every odd k 3..207, also read
    from a view one word into its storage, and no row; then timed at
    2**24 keys, k = 31 and 63, beside its plain version and the words'
    pageable upload."""
    from kmer_denovo_filter_tpu_torch.ops import convert, extract, route
    from kmer_denovo_filter_tpu_torch.ops import encode as enc
    from kmer_denovo_filter_tpu_torch.ops import keys as keys64
    from kmer_denovo_filter_tpu_torch.ops.timing import device_ms

    def rows_of(n, q, kind):
        if kind == "homopolymer":
            rows = np.full((n, q), 12345, np.int64)
        elif kind == "sentinel":
            rows = np.full((n, q), keys64.SENTINEL, np.int64)
        else:
            rows = rng.integers(0, 1 << 62, (n, q), dtype=np.int64)
            rows[::13] = keys64.SENTINEL
        keys = torch.from_numpy(rows).to(cuda)
        return keys[:, 0].contiguous() if q == 1 else keys

    def check_route(keys, s, sentinel, what):
        got = route.route(keys, s, sentinel)
        ref = route.plain_route(keys, s, sentinel)
        for part, g, r in zip(("order", "sizes", "routed"), got, ref):
            check("route", g, r, f"{what}, S={s}, sentinel bucket "
                  f"{sentinel}: {part}")

    cases = 0
    for q in range(1, 8):
        for n in (0, 1, 4097, 8193, 1 << 20):
            for kind in ("random", "homopolymer", "sentinel"):
                keys = rows_of(n, q, kind)
                for s in (1, 2, 3, 4, 7, 64, 1023):
                    check_route(keys, s, True, f"Q={q} N={n} {kind}")
                for s in (4, 1024):
                    check_route(keys, s, False, f"Q={q} N={n} {kind}")
                cases += 9
        check_route(rows_of(2 * 8193, q, "random")[::2], 4, True,
                    f"Q={q} a strided view")
        cases += 1
    codes, lengths = (torch.from_numpy(a).to(cuda)
                      for a in random_batch(rng))
    for k in (31, 63):
        win = (extract.extract_canonical(codes, lengths, k) if k <= 31 else
               extract.extract_canonical_wide(codes, lengths, k))
        for s in (1, 2, 4):
            check_route(win.flatten(0, 1), s, True, f"k={k} batch")
            cases += 1
    print(f"[3r] K10 equal to its plain version in {cases} cases (order, "
          "sizes, routed rows)", flush=True)
    for k in range(3, keys64.MAX_K + 1, 2):
        w = enc.words_per_kmer(k)
        words = rng.integers(0, 1 << 32, (4097, w), dtype=np.uint64).astype(
            np.uint32)
        words[:, -1] &= np.uint32((0xFFFFFFFF << (32 * w - 2 * k))
                                  & 0xFFFFFFFF)
        words[::5] = keys64.SENTINEL32
        on_card = convert.words_tensor(words).to(cuda)
        got = convert.words_to_keys(on_card, k)
        check("words_to_keys", got, convert.plain_words_to_keys(on_card, k),
              f"k={k}")
        want = (keys64.words_to_keys64(words, k) if k <= 31
                else keys64.words_to_limbs(words, k))
        check("words_to_keys", got.cpu(), want, f"k={k}, numpy")
        store = torch.empty(on_card.numel() + 1, dtype=torch.int32,
                            device=cuda)
        view = store[1:].view(on_card.shape)
        view.copy_(on_card)
        check("words_to_keys", convert.words_to_keys(view, k), got,
              f"k={k}, a view one word into its storage")
        if convert.words_to_keys(on_card[:0], k).shape != want[:0].shape:
            fail(f"words_to_keys: k={k}, no row: wrong shape")
    print("[3r] K11 equal to its plain version and to the numpy "
          "conversion at every odd k 3..207", flush=True)
    m = BIG_M
    for k in (31, 63):
        w, q = enc.words_per_kmer(k), keys64.limbs_per_kmer(k)
        words = rng.integers(0, 1 << 32, (m, w), dtype=np.uint64).astype(
            np.uint32)
        host = convert.words_tensor(words)
        upload_ms = wall_ms(lambda: host.to(cuda), reps=3)
        on_card = host.to(cuda)
        got = convert.words_to_keys(on_card, k)
        check("words_to_keys", got, convert.plain_words_to_keys(on_card, k),
              f"k={k}, M={m}")
        ms = device_ms(lambda: convert.words_to_keys(on_card, k))
        plain_ms = device_ms(
            lambda: convert.plain_words_to_keys(on_card, k), reps=3)
        # words read once, limbs written once; ~8 operations a limb
        lim = bound(m * (4 * w + 8 * q), 8 * m * q)
        times[("words_to_keys", k)] = (ms, plain_ms, lim, upload_ms)
        print(f"[3r] K11 k={k} M={m}: equal; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {lim[0]:.4f} ms by {lim[1]}; the "
              f"words' pageable upload {upload_ms:.4f} ms", flush=True)
        del words, host, on_card, got


def phase_3s_wide(rng, cuda, check, times):
    """K9dw against its plain version at k = 63 and 201, on a random and
    a 40x batch, timed beside the whole-batch dedups."""
    from kmer_denovo_filter_tpu_torch.ops import device as dev
    from kmer_denovo_filter_tpu_torch.ops import extract, segsort
    from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL
    from kmer_denovo_filter_tpu_torch.ops.timing import device_ms
    for k in (63, 201):
        length = L_K201 if k == 201 else L
        codes, lengths = random_batch(rng, length)
        batches = {"random": (torch.from_numpy(codes).to(cuda),
                              torch.from_numpy(lengths).to(cuda)),
                   "40x": codes_40x(cuda, length)}
        for label, (c, l) in batches.items():
            flat = extract.extract_canonical_wide(c, l, k).flatten(0, 1)
            got = segsort.seg_dedup_wide(flat)
            ref = dev.segment_runs_wide(segsort.segments(flat, SENTINEL))
            check("seg_dedup_wide", got[2], ref[2], f"k={k}, {label} batch, "
                  "counts")
            for g, w in zip(dev.segment_compact(*got),
                            dev.segment_compact(*ref)):
                check("seg_dedup_wide", g, w, f"k={k}, {label} batch, rows")
            n_rows, q = flat.shape
            rows = int(got[2].sum())
            n_segs = got[2].numel()
            whole = dev.dedup_windows_wide(flat)[0].shape[0]
            ms = device_ms(lambda: segsort.seg_dedup_wide(flat))
            plain_ms = device_ms(lambda: dev.segment_runs_wide(
                segsort.segments(flat, SENTINEL)), reps=3)
            batch_ms = device_ms(lambda: dev.dedup_windows_wide(flat),
                                 reps=5)
            unique_ms = device_ms(lambda: torch.unique(
                flat, dim=0, sorted=True, return_counts=True), reps=3)
            # rows read; a row and a weight written per distinct row of
            # a segment and a count per segment; the fingerprint's
            # multiply-xorshift (3 operations a limb) and a compare a row
            lim = bound(8 * q * n_rows + (8 * q + 8) * rows + 4 * n_segs,
                        (3 * q + 1) * n_rows)
            # library: one PyTorch call that dedups the whole batch
            times[("seg_dedup_wide", k, label)] = (ms, plain_ms, unique_ms,
                                                   lim)
            print(f"[3s] K9dw k={k} {label} batch: equal ({n_rows} rows, "
                  f"{n_segs} segments, {rows} segment rows, {whole} "
                  f"distinct rows in the whole batch); kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, dedup_windows_wide (whole "
                  f"batch) {batch_ms:.4f} ms, torch.unique(dim=0) "
                  f"{unique_ms:.4f} ms, bound {lim[0]:.4f} ms by {lim[1]}",
                  flush=True)


def phase_3c(rng, codes, lengths, cuda, check, times):
    """K12 (``sortcount.sort_count`` / ``sort_count_wide``) against its
    plain version, exact: the phase-3 random batch and a 40x batch at
    k = 15 and 31; random batches at k = 33, 63, 127, 201 and 207 (256
    bp from k = 201) and 40x batches at k = 63 and 201; the (1, 2**20)
    contig row at k = 31 and 63; N = 0, 1 and 8,193 random keys; one key
    repeated; all sentinels; 2**20 distinct keys (K9d's hash gives up);
    the shapes of the merge tree at k = 31, 63 and 201: one segment (S =
    1), odd S (3), S = 2**4 + 1, one read repeated over a batch (its keys
    in every segment) and 40 copies of one batch.  Timed on the 40x and
    random batches at k = 31, 63 and 201: the call (its one sync
    included), its launches alone (no sync) and K9d's (K9dw's) share of
    them, beside the plain version and ``torch.unique`` (``dim=0`` for
    rows)."""
    from kmer_denovo_filter_tpu_torch.ops import device as dev
    from kmer_denovo_filter_tpu_torch.ops import extract, segsort, sortcount
    from kmer_denovo_filter_tpu_torch.ops import keys as keys64
    from kmer_denovo_filter_tpu_torch.ops.timing import device_ms

    def window_rows(c, l, k):
        if k <= keys64.NARROW_K:
            return extract.extract_canonical(c, l, k).reshape(-1)
        return extract.extract_canonical_wide(c, l, k).flatten(0, 1)

    def check_case(label, flat, k, timed=False):
        wide = flat.dim() == 2
        fn = sortcount.sort_count_wide if wide else sortcount.sort_count
        plain = dev.sort_count_wide if wide else dev.sort_count
        got, ref = fn(flat, k), plain(flat)
        check("sort_count", got[0], ref[0], f"{label}: keys")
        check("sort_count", got[1], ref[1], f"{label}: counts")
        if not timed:
            return
        n, q = flat.shape[0], 1 if not wide else flat.shape[1]
        distinct = ref[0].shape[0]
        ms = device_ms(lambda: fn(flat, k))
        launch_ms = device_ms(lambda: sortcount.launch(flat, k))
        dedup = segsort.seg_dedup_wide if wide else segsort.seg_dedup
        dedup_ms = device_ms(lambda: dedup(flat))
        plain_ms = device_ms(lambda: plain(flat), reps=5)
        unique = ((lambda: torch.unique(flat, dim=0, sorted=True,
                                        return_counts=True)) if wide else
                  (lambda: torch.unique(flat, sorted=True,
                                        return_counts=True)))
        lib_ms = device_ms(unique, reps=5)
        # the keys read once, each distinct row and its count written once
        lim = bound(8 * q * n + (8 * q + 8) * distinct, 0)
        times[("sort_count", label)] = (ms, plain_ms, lib_ms, lim, launch_ms)
        print(f"[3c] K12 {label}: equal ({n} rows, {distinct} distinct); "
              f"the call {ms:.4f} ms, its launches alone {launch_ms:.4f} "
              f"ms, of which {'K9dw' if wide else 'K9d'} {dedup_ms:.4f} ms "
              f"({dedup_ms / launch_ms:.3f} of the launches, "
              f"{dedup_ms / ms:.3f} of the call), plain {plain_ms:.4f} ms, "
              f"torch.unique {lib_ms:.4f} ms, bound {lim[0]:.4f} ms by "
              f"{lim[1]}", flush=True)

    cases = 0
    for k in (15, 31):
        for label, (c, l) in (("random", (codes, lengths)),
                              ("40x", codes_40x(cuda))):
            check_case(f"k={k} {label} batch", window_rows(c, l, k), k,
                       timed=k == 31)
            cases += 1
    for k in (33, 63, 127, 201, 207):
        length = L_K201 if k >= 201 else L
        c, l = (torch.from_numpy(a).to(cuda)
                for a in random_batch(rng, length))
        check_case(f"k={k} random batch", window_rows(c, l, k), k,
                   timed=k in (63, 201))
        cases += 1
        if k in (63, 201):
            check_case(f"k={k} 40x batch",
                       window_rows(*codes_40x(cuda, length), k), k,
                       timed=True)
            cases += 1
    row = torch.from_numpy(rng.integers(0, 4, (1, ROW), dtype=np.uint8)
                           ).to(cuda)
    row_len = torch.tensor([ROW], dtype=torch.int32, device=cuda)
    for k in (31, 63):
        check_case(f"k={k} the (1, 2**20) row", window_rows(row, row_len, k),
                   k)
        cases += 1
    for k in (31, 63):
        q = keys64.limbs_per_kmer(k)

        def keys_of(n, repeats=None, k=k, q=q):
            """n random keys at k (drawn from *repeats* keys if given),
            every 7th a sentinel when repeated."""
            tops = [1 << (2 * nb) for nb in keys64.limb_bases(k)]
            m = n if repeats is None else repeats
            rows = np.stack([rng.integers(0, top, m, dtype=np.int64)
                             for top in tops], axis=1)
            if repeats is not None:
                rows = rows[rng.integers(0, m, n)]
                rows[::7] = keys64.SENTINEL
            t = torch.from_numpy(rows).to(cuda)
            return t[:, 0].contiguous() if q == 1 else t

        for n in (0, 1, 8193):
            check_case(f"k={k} N={n}", keys_of(n, repeats=3000), k)
        check_case(f"k={k} one key", keys_of(1 << 20, repeats=1), k)
        sentinels = keys_of(1 << 16)
        sentinels.fill_(keys64.SENTINEL)
        check_case(f"k={k} all sentinels", sentinels, k)
        check_case(f"k={k} 2**20 distinct keys", keys_of(1 << 20), k)
        cases += 6
    segment = segsort.SEGMENT
    for k in (31, 63, 201):
        length = L_K201 if k >= 201 else L
        c, l = (torch.from_numpy(a).to(cuda)
                for a in random_batch(rng, length))
        batch = window_rows(c, l, k)
        # the merge tree's shapes: S = 1, S = 3, S = 2**4 + 1
        for label, n in (("S=1", segment - 5), ("S=3", 3 * segment - 7),
                         ("S=17", 16 * segment + 1)):
            check_case(f"k={k} {label}", batch[:n].contiguous(), k)
        # one read repeated (its keys in every segment), 40 copies of a
        # batch of B / 40 reads
        read = c[:1].expand(B, -1).contiguous()
        full = torch.full((B,), length, dtype=torch.int32, device=cuda)
        check_case(f"k={k} one read repeated", window_rows(read, full, k), k)
        part = B // 40
        copies = (c[:part].repeat(40, 1), l[:part].repeat(40))
        check_case(f"k={k} 40 copies of a batch", window_rows(*copies, k), k)
        cases += 5
    print(f"[3c] K12 equal to its plain version in {cases} cases",
          flush=True)


def phase_7(reset_counts, read_counts):
    """Every ported experiment command once; returns the launch counts
    of the whole phase.  ``x_fused transposed`` and ``unroll2`` run
    ``x_join_variants v5``, which runs here on its own: for them the
    phase checks that they reach ``run_v5`` and stops them there."""
    import contextlib
    import io
    from kmer_denovo_filter_tpu_torch.experiments import (
        x_fused,
        x_join_variants,
    )
    reset_counts()
    t_phase = time.perf_counter()
    run_v5 = x_join_variants.run_v5
    reached_v5 = []
    for mod in (x_fused, x_join_variants):
        name = mod.__name__.rsplit(".", 1)[1]
        for command in mod.COMMANDS:
            alias = mod is x_fused and command in x_fused.V5_LAYOUTS
            x_join_variants.run_v5 = (
                (lambda *a: reached_v5.append(command)) if alias else run_v5)
            out = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    mod.main([command, "--reps", "3"])
            except AssertionError as exc:
                print(out.getvalue(), end="")
                fail(f"{name} {command}: {exc}")
            finally:
                x_join_variants.run_v5 = run_v5
            text = out.getvalue()
            print("".join(f"    {line}\n" for line in text.splitlines()),
                  end="")
            if alias:
                said = "running x_join_variants v5" in text
                if reached_v5[-1:] != [command] or not said:
                    fail(f"{name} {command} did not run x_join_variants v5")
                print(f"[7] {name} {command}: runs x_join_variants v5 (run "
                      "on its own below)", flush=True)
                continue
            if "parity: False" in text or "parity: True" not in text:
                fail(f"{name} {command} printed no true parity line")
            print(f"[7] {name} {command}: every parity line true, "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
    print(f"[7] {sum(len(m.COMMANDS) for m in (x_fused, x_join_variants))} "
          f"commands in {time.perf_counter() - t_phase:.3f} s", flush=True)
    return read_counts()


def phase_9(cuda, reset_counts, read_counts):
    """The port's entry points: ``entry()``'s step on the card equal to
    the same step on CPU copies of its arguments (the plain versions),
    on its example table and on a third of the batch's window keys, with
    K1 and K2 launched; then ``dryrun_multichip`` over every local card
    and, with one, over four shards of it.  Returns the phase's
    launches."""
    from kmer_denovo_filter_tpu_torch import entry
    from kmer_denovo_filter_tpu_torch.ops import extract
    from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL
    reset_counts()
    t0 = time.perf_counter()
    fn, (table, _acc, codes, lengths) = entry.entry()
    flat = extract.extract_canonical(codes.cpu(), lengths.cpu(),
                                     entry.K).reshape(-1)
    tables = {"the example table": table,
              "a third of the windows": torch.unique(
                  flat[flat != SENTINEL])[::3].contiguous().to(cuda)}
    hits = {}
    for label, t in tables.items():
        acc = torch.zeros(t.shape[0], dtype=torch.int64, device=cuda)
        cpu = (t.cpu(), acc.cpu(), codes.cpu(), lengths.cpu())
        got_acc, got_n = fn(t, acc, codes, lengths)
        ref_acc, ref_n = fn(*cpu)
        torch.cuda.synchronize()
        if not (torch.equal(got_acc.cpu(), ref_acc)
                and int(got_n) == int(ref_n)):
            fail(f"9: entry()'s step on {label} differs on the card from "
                 "the CPU")
        hits[label] = int(ref_acc.sum())
    step = read_counts()
    for name in ("extract_canonical", "probe_tally"):
        if step[name] <= 0:
            fail(f"9: entry()'s step did not launch {name}")
    n_cards = torch.cuda.device_count()
    entry.dryrun_multichip(n_cards)
    meshes = [f"make_mesh({n_cards})"]
    if n_cards == 1:
        entry.dryrun_multichip(4, mesh=[cuda] * 4)
        meshes.append("[cuda:0] * 4")
    launched = {name: step[name] for name in ("extract_canonical",
                                              "probe_tally",
                                              "build_directory")}
    print(f"[9] entry(): the step K1 -> K2 equal on the card and the CPU "
          f"({int(ref_n)} valid windows; hits {hits}), its launches "
          f"{launched}; dryrun_multichip passed over "
          f"{' and '.join(meshes)}; {time.perf_counter() - t0:.3f} s",
          flush=True)
    return read_counts()


def phase_4c(cuda, reset_counts, read_counts):
    """The wide main path on the card, held byte for byte against the
    same pipelines on the CPU; returns each run's launch counts."""
    from kmer_denovo_filter_tpu_torch import cli
    from kmer_denovo_filter_tpu_torch.pipeline import (
        run_discovery_pipeline,
        run_pipeline,
    )
    giab = os.path.join(REPO, "tests", "data", "giab")
    giab_files = sorted(os.listdir(giab))
    k = "63"
    trio = ["--child", os.path.join(giab, "HG002_child.bam"),
            "--mother", os.path.join(giab, "HG004_mother.bam"),
            "--father", os.path.join(giab, "HG003_father.bam")]

    def vcf_argv(out):
        return trio + [
            "--vcf", os.path.join(giab, "candidates.vcf.gz"),
            "--output", os.path.join(out, "annotated.vcf.gz"),
            "--metrics", os.path.join(out, "metrics.json"),
            "--summary", os.path.join(out, "summary.txt"),
            "--proband-id", "HG002", "--kmer-size", k]

    def discovery_argv(out):
        return trio + [
            "--ref-fasta", os.path.join(out, "mini_ref.fa"),
            "--out-prefix", os.path.join(out, "giab_discovery"),
            "--min-child-count", "3", "--kmer-size", k,
            "--candidate-summary", os.path.join(out, "summary.txt")]

    root = tempfile.mkdtemp(prefix="kdf_chip_smoke_")
    try:
        outs = {}
        for where in ("card", "cpu"):
            outs[where] = os.path.join(root, where)
            os.makedirs(outs[where])
            for name in ("mini_ref.fa", "mini_ref.fa.fai"):
                shutil.copy(os.path.join(giab, name), outs[where])
        reset_counts()
        t0 = time.perf_counter()
        cli.vcf_main(vcf_argv(outs["card"]))
        torch.cuda.synchronize()
        wall_vcf = time.perf_counter() - t0
        launches_vcf = read_counts()
        reset_counts()
        t0 = time.perf_counter()
        cli.discovery_main(discovery_argv(outs["card"]))
        torch.cuda.synchronize()
        wall_disc = time.perf_counter() - t0
        launches_disc = read_counts()
        cpu = torch.device("cpu")
        t0 = time.perf_counter()
        run_pipeline(cli.parse_vcf_args(vcf_argv(outs["cpu"])), cpu)
        run_discovery_pipeline(
            cli.parse_discovery_args(discovery_argv(outs["cpu"])), cpu)
        wall_cpu = time.perf_counter() - t0
        names = ["annotated.vcf.gz", "metrics.json", "summary.txt"] + [
            f"giab_discovery.{suffix}" for suffix in DISCOVERY_OUTPUTS]
        for name in names:
            opener = gzip.open if name.endswith(".gz") else open
            with opener(os.path.join(outs["card"], name), "rb") as a, \
                    opener(os.path.join(outs["cpu"], name), "rb") as b:
                if a.read() != b.read():
                    fail(f"k=63 {name}: the card run differs from the "
                         "plain CPU run")
        for where in outs:
            if not os.path.isfile(os.path.join(outs[where],
                                               "mini_ref.fa.k63.kdx.npz")):
                fail("Module 0 wrote no k=63 reference cache")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name, launches in (("extract_canonical_wide", launches_vcf),
                           ("build_directory", launches_vcf),
                           ("probe_tally_wide", launches_vcf),
                           ("words_to_keys", launches_vcf),
                           ("extract_canonical_wide", launches_disc),
                           ("build_directory", launches_disc),
                           ("words_to_keys", launches_disc),
                           ("probe_tally_wide_weighted", launches_disc),
                           ("seg_dedup_wide", launches_disc),
                           ("sort_count", launches_disc),
                           ("probe_member_wide", launches_disc)):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the k=63 main path")
    if sorted(os.listdir(giab)) != giab_files:
        fail("the k=63 main paths wrote into tests/data/giab")
    print(f"[4c] k=63: kmer-denovo-torch {wall_vcf:.3f} s, "
          f"kmer-discovery-torch {wall_disc:.3f} s on the card; 3 + 6 "
          f"outputs byte-equal to the plain CPU run ({wall_cpu:.3f} s); "
          f"launches {launches_vcf} / {launches_disc}", flush=True)
    return launches_vcf, launches_disc


def free_port():
    """A free TCP port on 127.0.0.1 for a one-process group."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_4d(outputs_4, reset_counts, read_counts):
    """Both CLIs as one process of a multi-host run (``KDF_COORDINATOR``
    set, world size 1: the CLI joins an NCCL group on cuda:0); outputs
    byte-equal to phases 4 and 4b; then ``kmer-report-torch`` on them.
    Returns the launch counts of the two runs."""
    from kmer_denovo_filter_tpu_torch import cli
    from kmer_denovo_filter_tpu_torch.parallel import multihost
    giab = os.path.join(REPO, "tests", "data", "giab")
    goldens = os.path.join(REPO, "tests", "goldens")
    trio = ["--child", os.path.join(giab, "HG002_child.bam"),
            "--mother", os.path.join(giab, "HG004_mother.bam"),
            "--father", os.path.join(giab, "HG003_father.bam")]
    env = {"KDF_COORDINATOR": f"127.0.0.1:{free_port()}",
           "KDF_NUM_PROCESSES": "1", "KDF_PROCESS_ID": "0"}
    out = tempfile.mkdtemp(prefix="kdf_chip_smoke_")
    os.environ.update(env)
    try:
        reset_counts()
        t0 = time.perf_counter()
        cli.vcf_main(trio + [
            "--vcf", os.path.join(giab, "candidates.vcf.gz"),
            "--output", os.path.join(out, "annotated.vcf.gz"),
            "--metrics", os.path.join(out, "metrics.json"),
            "--summary", os.path.join(out, "summary.txt"),
            "--proband-id", "HG002"])
        torch.cuda.synchronize()
        wall_vcf = time.perf_counter() - t0
        launches_vcf = read_counts()
        if not multihost.joined() or multihost.device() != torch.device(
                "cuda", 0) or torch.distributed.get_backend() != "nccl":
            fail("kmer-denovo-torch did not join an NCCL group on cuda:0")
        prefix = os.path.join(out, "giab_discovery")
        reset_counts()
        t0 = time.perf_counter()
        cli.discovery_main(trio + [
            "--ref-fasta", os.path.join(giab, "mini_ref.fa"),
            "--ref-jf", os.path.join(giab, "mini_ref.fa.k31.jf"),
            "--out-prefix", prefix, "--min-child-count", "3",
            "--kmer-size", "31",
            "--candidate-summary", os.path.join(goldens, "summary.txt")])
        torch.cuda.synchronize()
        wall_disc = time.perf_counter() - t0
        launches_disc = read_counts()
        for name, want in outputs_4.items():
            opener = gzip.open if name.endswith(".gz") else open
            with opener(os.path.join(out, name), "rb") as fh:
                if fh.read() != want:
                    fail(f"4d: {name} differs from phases 4 and 4b")
        html = os.path.join(out, "report.html")
        cli.report_main([
            "--output", html,
            "--vcf-metrics", os.path.join(out, "metrics.json"),
            "--vcf-summary", os.path.join(out, "summary.txt"),
            "--vcf", os.path.join(out, "annotated.vcf.gz"),
            "--discovery-metrics", f"{prefix}.metrics.json",
            "--discovery-summary", f"{prefix}.summary.txt"])
        with open(html) as fh:
            size = len(fh.read())
        if size < 1000:
            fail(f"kmer-report-torch wrote {size} characters")
    finally:
        multihost.shutdown()
        for name in env:
            os.environ.pop(name, None)
        shutil.rmtree(out, ignore_errors=True)
    for name, launches in (("extract_canonical", launches_vcf),
                           ("probe_tally", launches_vcf),
                           ("extract_canonical", launches_disc),
                           ("seg_dedup", launches_disc),
                           ("probe_tally_weighted", launches_disc),
                           ("probe_member", launches_disc)):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched in phase 4d")
    print(f"[4d] one-process NCCL run: kmer-denovo-torch {wall_vcf:.3f} s, "
          f"kmer-discovery-torch {wall_disc:.3f} s, {len(outputs_4)} "
          f"outputs byte-equal to phases 4 and 4b; kmer-report-torch wrote "
          f"{size} characters of HTML; launches {launches_vcf} / "
          f"{launches_disc}", flush=True)
    return launches_vcf, launches_disc


def table_words(rng, flat, m, k, cuda):
    """(M, W) uint32 words of a sorted table of *m* keys, half of them
    distinct live keys of *flat*, as ``make_table`` draws them."""
    from kmer_denovo_filter_tpu_torch.ops import keys as keys64
    if k > keys64.NARROW_K:
        return keys64.limbs_to_words(make_table_wide(rng, flat, m, k, cuda),
                                     k)
    return keys64.keys64_to_words(
        make_table(rng, flat, m, k, keys64.SENTINEL, cuda), k)


def phase_8(batches, cuda, card, reset_counts, read_counts, times):
    """The sharded engine on one card, mesh [cuda:0] * S, S = 1, 2, 4, at
    k = 31 and 63 against an M = 2**20 table on the phase-5 batches: every
    sharded result equal to its single-device counterpart, every shard's
    launches counted, and the feed's reads/s beside the single-device
    form's.  Returns the launch counts of the sharded runs."""
    from kmer_denovo_filter_tpu_torch import engine as eng
    from kmer_denovo_filter_tpu_torch.ops import keys as keys64
    from kmer_denovo_filter_tpu_torch.parallel import (
        ShardedFilteredCounter,
        ShardedKmerIndex,
        sharded_count,
        sharded_scan_reads_for_hits,
    )
    from kmer_denovo_filter_tpu_torch.parallel.sharded import (
        _gather_by_owner,
        _window_keys_by_source,
    )
    rng = np.random.default_rng(8)
    lens = np.full(B, L, np.int32)
    n_reads = len(batches) * B
    total = {}

    def counted(run):
        """run() with the launch counts reset before it; adds them to the
        phase's total and returns (result, counts)."""
        reset_counts()
        result = run()
        torch.cuda.synchronize()
        got = read_counts()
        for name, n in got.items():
            total[name] = total.get(name, 0) + n
        return result, got

    def feed_all(fc):
        for c in batches:
            fc.feed(c, lens)
        torch.cuda.synchronize()
        return fc

    def rate(fc):
        """reads/s of the feed loop (the counter is built before)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        feed_all(fc)
        return n_reads / (time.perf_counter() - t)

    homopolymer = np.zeros((GROUP_B, L), np.uint8)
    hlens = np.full(GROUP_B, L, np.int32)
    for k in (31, 63):
        wide = k > keys64.NARROW_K
        x = "_wide" if wide else ""
        extract_name = "extract_canonical" + x
        tally_name = "probe_tally" + x
        weighted_name = ("probe_tally_wide_weighted" if wide
                         else "probe_tally_weighted")
        dedup_name = "seg_dedup_wide" if wide else "seg_dedup"
        member_name = "probe_member" + x
        flat = eng._window_keys(batches[0], lens, k, cuda).flatten(0, 1)
        words = table_words(rng, flat, SCAN_M, k, cuda)
        index = eng.KmerIndex(words, k, device=cuda)
        singles = {}
        for dedup in (False, True):
            fc = feed_all(eng.FilteredCounter(index, dedup=dedup))
            singles[dedup] = fc.result()
        if not singles[False].any() or not np.array_equal(singles[False],
                                                          singles[True]):
            fail(f"8: k={k} single-device forms disagree or find nothing")
        q_words = (keys64.limbs_to_words(flat[:1 << 20], k) if wide
                   else keys64.keys64_to_words(flat[:1 << 20], k))
        q_member = index.membership(q_words)
        scan_codes, scan_lens = batches[1][:2 * GROUP_B], lens[:2 * GROUP_B]
        scan_ref = eng.scan_reads_for_hits(index, scan_codes, scan_lens)
        sc = eng.StreamCounter(k, device=cuda)
        sc.feed(batches[2], lens)
        count_ref = sc.result()
        sc = eng.StreamCounter(k, device=cuda)
        sc.feed(homopolymer, hlens)
        homo_count_ref = sc.result()
        homo_tally_ref = eng.FilteredCounter(index)
        homo_tally_ref.feed(homopolymer, hlens)
        homo_tally_ref = homo_tally_ref.result()
        for s in (1, 2, 4):
            mesh = [cuda] * s
            for dedup in (False, True):
                fc, got = counted(lambda: feed_all(ShardedFilteredCounter(
                    words, k, mesh, dedup=dedup)))
                if not np.array_equal(fc.result(), singles[dedup]):
                    fail(f"8: k={k} S={s} ShardedFilteredCounter "
                         f"(dedup={dedup}) differs from FilteredCounter")
                # the build: K11 and K10 a slice; the feed: K10 a source
                want = {extract_name: s * len(batches),
                        "build_directory": s, "words_to_keys": s,
                        "route": s * len(batches) + s}
                if dedup:
                    want.update({dedup_name: s * len(batches),
                                 weighted_name: s * len(batches)})
                else:
                    want[tally_name] = s * len(batches)
                for name, n in want.items():
                    if got[name] != n:
                        fail(f"8: k={k} S={s} dedup={dedup}: {name} "
                             f"launched {got[name]} times, not {n}")
            sharded, got = counted(lambda: ShardedKmerIndex(words, k, mesh))
            for name, n in (("words_to_keys", s), ("route", s),
                            ("build_directory", s)):
                if got[name] != n:
                    fail(f"8: k={k} S={s} build: {name} launched "
                         f"{got[name]} times, not {n}")
            member, got_m = counted(lambda: sharded.membership(q_words))
            if not np.array_equal(member, q_member):
                fail(f"8: k={k} S={s} ShardedKmerIndex.membership differs")
            hits, got_s = counted(lambda: sharded_scan_reads_for_hits(
                sharded, scan_codes, scan_lens))
            if not np.array_equal(hits, scan_ref):
                fail(f"8: k={k} S={s} sharded_scan_reads_for_hits differs")
            (keys_s, counts_s), got_c = counted(
                lambda: sharded_count(batches[2], lens, k, mesh))
            if not (np.array_equal(keys_s, count_ref[0])
                    and np.array_equal(counts_s, count_ref[1])):
                fail(f"8: k={k} S={s} sharded_count differs from "
                     "StreamCounter")
            for name, n in ((member_name, s), (extract_name, 0),
                            ("words_to_keys", 1), ("route", 1)):
                if got_m[name] != n:
                    fail(f"8: k={k} S={s} membership: {name} launched "
                         f"{got_m[name]} times, not {n}")
            for name, n in ((member_name, s), (extract_name, s),
                            ("route", s)):
                if got_s[name] != n:
                    fail(f"8: k={k} S={s} scan: {name} launched "
                         f"{got_s[name]} times, not {n}")
            for name in (extract_name, "route", "sort_count"):
                if got_c[name] != s:
                    fail(f"8: k={k} S={s} sharded_count: {name} launched "
                         f"{got_c[name]} times, not {s}")
            fc, _ = counted(lambda: ShardedFilteredCounter(words, k, mesh))
            counted(lambda: fc.feed(homopolymer, hlens))
            counted(lambda: fc.feed(homopolymer[:0], hlens[:0]))
            (hk, hc), _ = counted(
                lambda: sharded_count(homopolymer, hlens, k, mesh))
            if not (np.array_equal(fc.result(), homo_tally_ref)
                    and np.array_equal(hk, homo_count_ref[0])
                    and np.array_equal(hc, homo_count_ref[1])
                    and hc.tolist() == [GROUP_B * (L - k + 1)]):
                fail(f"8: k={k} S={s} the homopolymer batch differs")
            (ek, ec), _ = counted(
                lambda: sharded_count(homopolymer[:0], hlens[:0], k, mesh))
            empty = counted(lambda: sharded_scan_reads_for_hits(
                sharded, homopolymer[:0], hlens[:0]))[0]
            if ek.shape[0] or ec.shape[0] or empty.shape != (0, L - k + 1):
                fail(f"8: k={k} S={s} an empty batch gave a result")
            del sharded, fc
        print(f"[8] k={k} M={SCAN_M}: S = 1, 2, 4 on [cuda:0] * S, "
              "ShardedFilteredCounter (both forms), membership, scan, "
              "sharded_count, a homopolymer and an empty batch equal to "
              "the single-device engine; every shard's launches counted",
              flush=True)
        # reads/s of the feed loop, interleaved: single, S = 1, 2, 4, 4,
        # 2, 1, single; each counter built before its loop (the sharded
        # one's build, a host hash and S directories, timed apart)
        for dedup in (False, True):
            rates, builds = {}, {}
            for form in ("one", 1, 2, 4, 4, 2, 1, "one"):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fc = (eng.FilteredCounter(index, dedup=dedup) if form == "one"
                      else ShardedFilteredCounter(words, k, [cuda] * form,
                                                  dedup=dedup))
                torch.cuda.synchronize()
                builds.setdefault(form, []).append(time.perf_counter() - t)
                rates.setdefault(form, []).append(rate(fc))
                del fc
            line = "; ".join(
                f"{'one device' if f == 'one' else f'S={f}'} "
                f"{rates[f][0]:.1f} / {rates[f][1]:.1f}"
                for f in ("one", 1, 2, 4))
            built = ", ".join(f"S={f} {1e3 * min(builds[f]):.1f}"
                              for f in (1, 2, 4))
            print(f"[8] k={k} M={SCAN_M} {'dedup' if dedup else 'plain'} "
                  f"filter reads/s: {line}; the sharded counter's build "
                  f"ms: {built} ({card})", flush=True)
        # the routing share of a batch: extraction alone, extraction and
        # routing, the whole feed (host clock, synchronized)
        for s in (1, 2, 4):
            mesh = [cuda] * s
            fc = ShardedFilteredCounter(words, k, mesh)
            walls = {}
            for label, run in (
                    ("extract", lambda c: _window_keys_by_source(
                        c, lens, k, mesh)),
                    ("route", lambda c: _gather_by_owner(
                        [kk for kk, _ in _window_keys_by_source(
                            c, lens, k, mesh)], mesh)),
                    ("feed", lambda c: fc.feed(c, lens))):
                run(batches[0])
                torch.cuda.synchronize()
                t = time.perf_counter()
                for c in batches:
                    run(c)
                torch.cuda.synchronize()
                walls[label] = (time.perf_counter() - t) * 1e3 / len(batches)
            share = (walls["route"] - walls["extract"]) / walls["feed"]
            print(f"[8] k={k} S={s} ms a batch: extraction {walls['extract']:.3f}, "
                  f"+ routing {walls['route']:.3f}, whole feed "
                  f"{walls['feed']:.3f}; routing share {share:.4f} ({card})",
                  flush=True)
        del index
    phase_8_route_split(batches[0], lens, cuda, card, times)
    phase_8_stream_count(batches[:4], lens, cuda, card)
    phase_8_build(batches[0], lens, rng, cuda, card)
    return total


def wall_ms(run, reps=5):
    """Best host milliseconds of *run* over *reps* calls, each between
    two synchronizations."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return min(walls)


def phase_8_route_split(codes, lens, cuda, card, times):
    """The routing of one phase-5 batch to the mesh [cuda:0] * S, S = 1,
    2, 4, at k = 31 and 63: K10 (``route.route``) beside its plain
    version, split into its steps, each timed alone (the owner hash, the
    sentinel bucket's ``torch.where``, the stable ``argsort``,
    ``bincount`` with ``.tolist()``: host wall, it syncs; the gather and
    ``split``; the ``.to(d)`` copies), and beside the library pair
    ``argsort(stable=True)`` + ``bincount`` of the owners; then one
    source's whole route with its sizes' sync (``_gather_by_owner``,
    host wall).  K10 must equal the plain version.  Device times by
    ``ops.timing.device_ms``."""
    from kmer_denovo_filter_tpu_torch import engine as eng
    from kmer_denovo_filter_tpu_torch.ops import keys as keys64
    from kmer_denovo_filter_tpu_torch.ops import route
    from kmer_denovo_filter_tpu_torch.ops.timing import device_ms
    from kmer_denovo_filter_tpu_torch.parallel import sharded
    for k in (31, 63):
        keys = eng._window_keys(codes, lens, k, cuda).flatten(0, 1)
        first = keys if keys.dim() == 1 else keys[:, 0]
        for s in (1, 2, 4):
            mesh = [cuda] * s
            got = route.route(keys, s)
            ref = route.plain_route(keys, s)
            torch.cuda.synchronize()
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                fail(f"8: route k={k} S={s} differs from its plain version")
            owner = route.hash_owner(keys, s)
            owner = torch.where(first != keys64.SENTINEL, owner, s)
            order = torch.argsort(owner, stable=True)
            sizes = torch.bincount(owner, minlength=s + 1).tolist()
            parts = keys[order].split(sizes)
            split = {
                "K10": device_ms(lambda: route.route(keys, s)),
                "plain": device_ms(lambda: route.plain_route(keys, s)),
                "library": device_ms(lambda: (
                    torch.argsort(owner, stable=True),
                    torch.bincount(owner, minlength=s + 1))),
                "hash_owner": device_ms(
                    lambda: route.hash_owner(keys, s)),
                "where": device_ms(lambda: torch.where(
                    first != keys64.SENTINEL, owner, s)),
                "argsort": device_ms(
                    lambda: torch.argsort(owner, stable=True)),
                "bincount_tolist": wall_ms(lambda: torch.bincount(
                    owner, minlength=s + 1).tolist()),
                "gather_split": device_ms(
                    lambda: keys[order].split(sizes)),
                "copies": device_ms(
                    lambda: [p.to(d) for p, d in zip(parts, mesh)]),
                "gather_by_owner": wall_ms(
                    lambda: sharded._gather_by_owner([keys], mesh)),
            }
            # rows read once, routed rows and their indices written once
            lim = bound(16 * keys.numel() + 8 * keys.shape[0], 0)
            times[("route", k, s)] = (split["K10"], split["plain"],
                                      split["library"], lim)
            print(f"[8] route k={k} S={s}, {keys.shape[0]} rows: equal; "
                  + ", ".join(f"{name} {ms:.4f}"
                              for name, ms in split.items())
                  + f" ms; bound {lim[0]:.4f} ms by {lim[1]} ({card})",
                  flush=True)


def phase_8_stream_count(batches, lens, cuda, card):
    """The stream count over the mesh (``engine.ShardedStreamCounter``,
    taken under ``KDF_SHARDED=1``) beside ``StreamCounter``, at k = 31
    and 63: equal results, and reads/s of the feeds and the result,
    interleaved."""
    from kmer_denovo_filter_tpu_torch import engine as eng
    for k in (31, 63):
        rates, results = {}, {}
        for form in ("one", 2, 4, 4, 2, "one"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sc = (eng.StreamCounter(k, device=cuda) if form == "one"
                  else eng.ShardedStreamCounter(k, [cuda] * form))
            for c in batches:
                sc.feed(c, lens)
            got = sc.result()
            rates.setdefault(form, []).append(
                len(batches) * B / (time.perf_counter() - t))
            results.setdefault(form, got)
        for form, (keys, counts) in results.items():
            if not (np.array_equal(keys, results["one"][0])
                    and np.array_equal(counts, results["one"][1])):
                fail(f"8: k={k} ShardedStreamCounter on {form} shards "
                     "differs from StreamCounter")
        line = "; ".join(
            f"{'one device' if f == 'one' else f'S={f}'} "
            f"{rates[f][0] / 1e6:.2f}M / {rates[f][1] / 1e6:.2f}M"
            for f in ("one", 2, 4))
        print(f"[8] k={k} stream count, {len(batches)} batches, feeds and "
              f"result: reads/s {line}; equal ({card})", flush=True)


STREAM_SPLIT_FLOOR = 1 << 21  # a merge floor the 16 batches cross


def stream_split(k, batches, floor, sort_count, cuda):
    """The engine's stream count (``StreamCounter(k, device=cuda)``)
    over *batches*, its feed taken apart step by step, with the merge
    floor *floor* and the device sort-count *sort_count(flat, k)*.
    Returns ({step: [ms a batch]}, [(merge ms, rows merged)], result ms,
    conversion ms, the result)."""
    from kmer_denovo_filter_tpu_torch import engine as eng
    from kmer_denovo_filter_tpu_torch.ops import extract
    from kmer_denovo_filter_tpu_torch.ops import keys as keys64
    from kmer_denovo_filter_tpu_torch.ops.timing import device_ms
    wide = k > keys64.NARROW_K
    extract_fn = (extract.extract_canonical_wide if wide
                  else extract.extract_canonical)
    lens = np.full(B, batches[0].shape[1], np.int32)
    sc = eng.StreamCounter(k, device=cuda)
    sc._merge_floor = floor
    merges = []
    consolidate = sc._consolidate

    def timed_consolidate():
        rows = sum(c[0].shape[0] for c in sc._chunks) + (
            sc._merged[0].shape[0] if sc._merged is not None else 0)
        t = time.perf_counter()
        consolidate()
        merges.append(((time.perf_counter() - t) * 1e3, rows))

    sc._consolidate = timed_consolidate
    steps = {name: [] for name in ("upload", "K1", "sort_count", "wall",
                                   "dtoh", "add_chunk")}

    def clock(name, run):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        steps[name].append((time.perf_counter() - t) * 1e3)
        return out

    for c in batches:
        codes, lengths = clock("upload", lambda: eng._to_device(c, lens,
                                                                cuda))
        steps["K1"].append(device_ms(lambda: extract_fn(codes, lengths, k),
                                     reps=3))
        win = extract_fn(codes, lengths, k)
        flat = win.flatten(0, 1) if wide else win.reshape(-1)
        steps["sort_count"].append(device_ms(lambda: sort_count(flat, k),
                                             reps=3))
        uk, counts = clock("wall", lambda: sort_count(flat, k))
        uk, counts = clock("dtoh", lambda: (uk.cpu().numpy(),
                                            counts.cpu().numpy()))
        n_merges = len(merges)
        clock("add_chunk", lambda: sc._add_chunk(
            uk if wide else uk[:, None], counts))
        steps["add_chunk"][-1] -= sum(ms for ms, _ in merges[n_merges:])
        del codes, lengths, win, flat
    t = time.perf_counter()
    result = sc.result()
    result_ms = (time.perf_counter() - t) * 1e3
    merged = sc._merged[0]
    t = time.perf_counter()
    if wide:
        keys64.limbs_to_words(merged, k)
    else:
        keys64.keys64_to_words(merged[:, 0], k)
    convert_ms = (time.perf_counter() - t) * 1e3
    return steps, merges, result_ms, convert_ms, result


def phase_8_stream_split(genome, batches, cuda, card, forms):
    """The stream count's split, step by step a batch, at k = 31 and 63
    (the phase-5 batches) and k = 201 (3 batches of 256 bp): the
    pageable upload (host wall), K1 / K1w and the device sort-count
    (``ops.timing.device_ms``), one sort-count call between two syncs
    (host wall: the device work and the sync that reads its size), the
    pageable DtoH of the unique rows and counts, ``_add_chunk`` (host,
    merges apart), each ``_consolidate`` (host ms and rows merged) and
    ``result()`` with its conversion to words timed alone; beside it the
    engine's own loop (``StreamCounter.feed`` batch by batch, then
    ``result()``), reads/s.  At the default merge floor
    (``KDF_MERGE_ROWS``, 2**24 rows) and, where the batches do not
    cross it, at :data:`STREAM_SPLIT_FLOOR`.  *forms*: {label:
    sort_count(flat, k)}; every form's result must equal the engine's."""
    from kmer_denovo_filter_tpu_torch import engine as eng
    rng = np.random.default_rng(201)
    sets = {31: batches, 63: batches,
            201: [synth_reads(rng, genome, B, L_K201)
                  for _ in range(WIDE_BATCHES[201])]}
    for k, batches_k in sets.items():
        lens = np.full(B, batches_k[0].shape[1], np.int32)
        n_reads = len(batches_k) * B
        torch.cuda.synchronize()
        t = time.perf_counter()
        sc = eng.StreamCounter(k, device=cuda)
        for c in batches_k:
            sc.feed(c, lens)
        want = sc.result()
        engine_rate = n_reads / (time.perf_counter() - t)
        del sc
        floors = [1 << 24]
        for floor in floors:
            for label, sort_count in forms.items():
                steps, merges, result_ms, convert_ms, got = stream_split(
                    k, batches_k, floor, sort_count, cuda)
                if not (np.array_equal(got[0], want[0])
                        and np.array_equal(got[1], want[1])):
                    fail(f"8: the stream split k={k} {label} differs from "
                         "StreamCounter")
                if not merges[:-1] and len(floors) == 1:
                    floors.append(STREAM_SPLIT_FLOOR)
                total = (sum(sum(v) for name, v in steps.items()
                             if name not in ("K1", "sort_count"))
                         + sum(ms for ms, _ in merges[:-1]) + result_ms)
                per = {name: sum(v) / len(v) for name, v in steps.items()}
                feed_merges = [(round(ms, 3), r) for ms, r in merges[:-1]]
                print(f"[8] stream split k={k} {label}, {len(batches_k)} "
                      f"batches, floor {floor}: ms a batch upload "
                      f"{per['upload']:.4f}, K1 {per['K1']:.4f}, device "
                      f"sort-count {per['sort_count']:.4f}, one call with "
                      f"its sync {per['wall']:.4f}, DtoH {per['dtoh']:.4f}, "
                      f"_add_chunk {per['add_chunk']:.4f}; merges in the "
                      f"feed (ms, rows) {feed_merges}; "
                      f"result() {result_ms:.3f} ms (its merge of "
                      f"{merges[-1][1]} rows {merges[-1][0]:.3f}, words "
                      f"{convert_ms:.3f}); {got[0].shape[0]} keys; the "
                      f"split's host wall {total:.3f} ms; the engine's "
                      f"loop {engine_rate / 1e6:.4f}M reads/s ({card})",
                      flush=True)


def phase_8_build(codes, lens, rng, cuda, card):
    """The index's build against the table's size: one device and the
    sharded index at S = 4 on the card, k = 31 up to 2**24 keys and
    k = 63 up to 2**22, and the build's steps timed alone (best of two):
    the words' pageable upload, K11 on them, the table routed slice by
    slice (``_route_table``: K11 and K10 a slice, one copy back) and the
    host gather of each shard's words."""
    from kmer_denovo_filter_tpu_torch import engine as eng
    from kmer_denovo_filter_tpu_torch.ops import convert
    from kmer_denovo_filter_tpu_torch.ops.timing import device_ms
    from kmer_denovo_filter_tpu_torch.parallel import ShardedKmerIndex
    from kmer_denovo_filter_tpu_torch.parallel.sharded import _route_table

    def best_ms(run):
        return wall_ms(run, reps=2)

    mesh = [cuda] * 4
    for k, sizes in ((31, (1 << 20, 1 << 22, 1 << 24)),
                     (63, (1 << 20, 1 << 22))):
        flat = eng._window_keys(codes, lens, k, cuda).flatten(0, 1)
        for m in sizes:
            words = table_words(rng, flat, m, k, cuda)
            index = ShardedKmerIndex(words, k, mesh)
            if sum(s.n for s in index.shards) != m:
                fail(f"8: k={k} M={m} the shards do not hold the table")
            del index
            one = best_ms(lambda: eng.KmerIndex(words, k, device=cuda))
            sharded = best_ms(lambda: ShardedKmerIndex(words, k, mesh))
            host = convert.words_tensor(words)
            upload = best_ms(lambda: host.to(cuda))
            on_card = host.to(cuda)
            k11 = device_ms(lambda: convert.words_to_keys(on_card, k),
                            reps=5)
            routed = best_ms(lambda: _route_table(words, k, mesh))
            _tables, rows, ordered = _route_table(words, k, mesh)
            if not ordered:
                fail(f"8: k={k} M={m} a sorted table seen as unsorted")
            gather = best_ms(lambda: [words[r] for r in rows])
            print(f"[8] build k={k} M={m}: one device {one:.1f} ms, "
                  f"S=4 {sharded:.1f} ms ({1e6 * sharded / m:.1f} ns a "
                  f"key); alone: the words' upload {upload:.1f}, K11 "
                  f"{k11:.4f}, the table routed {routed:.1f}, the "
                  f"shards' host word gather {gather:.1f} ({card})",
                  flush=True)
            del words, host, on_card, rows, _tables


def phase_8b(batches, cuda, reset_counts, read_counts):
    """A one-process NCCL group (tcp://127.0.0.1, world size 1): the
    multi-host collectives on CUDA tensors equal the single-process
    results; the group is destroyed after.  Returns the launch counts."""
    from kmer_denovo_filter_tpu_torch import engine as eng
    from kmer_denovo_filter_tpu_torch.parallel import multihost
    lens = np.full(B, L, np.int32)
    port = free_port()
    if not multihost.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda"):
        fail("8b: multihost.initialize did not join")
    try:
        if (torch.distributed.get_backend() != "nccl"
                or multihost.device() != cuda):
            fail("8b: the group is not NCCL on cuda:0")
        t = torch.arange(1 << 20, dtype=torch.int64, device=cuda)
        got = multihost.sum_aligned(t)
        if got.device != t.device or not torch.equal(got, t):
            fail("8b: sum_aligned of a CUDA tensor differs")
        if multihost.sum_aligned(np.arange(7)).tolist() != list(range(7)):
            fail("8b: sum_aligned of a host array differs")
        reset_counts()
        for k in (31, 63):
            keys, counts = multihost.sharded_count_multihost(
                batches[0], lens, k)
            sc = eng.StreamCounter(k, device=cuda)
            sc.feed(batches[0], lens)
            ref_k, ref_c = sc.result()
            if not (np.array_equal(keys, ref_k)
                    and np.array_equal(counts, ref_c)):
                fail(f"8b: k={k} sharded_count_multihost differs from "
                     "StreamCounter")
            half = B // 2
            parts = [multihost.sharded_count_multihost(
                batches[0][rows], lens[rows], k, per_process=True)
                for rows in (slice(0, half), slice(half, B))]
            mk, mc = multihost.merge_counts_sharded(
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))
            if not (np.array_equal(mk, ref_k) and np.array_equal(mc, ref_c)):
                fail(f"8b: k={k} merge_counts_sharded differs")
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        multihost.shutdown()
    if torch.distributed.is_initialized():
        fail("8b: the process group outlived destroy_process_group")
    for name in ("extract_canonical", "extract_canonical_wide", "route",
                 "sort_count"):
        if launches[name] <= 0:
            fail(f"8b: kernel {name} was not launched")
    print(f"[8b] one-process NCCL group: sum_aligned, "
          f"sharded_count_multihost (all_to_all_single) and "
          f"merge_counts_sharded at k = 31 and 63 equal to the "
          f"single-process results; group destroyed; launches {launches}",
          flush=True)
    return launches


def phase_5c(rng, genome, batches_152, cuda, card):
    """Wide scale: the parent filter at k = 63 and 201 in three forms and
    the anchoring scan at k = 63, each equal to the plain path.  Returns
    the profiled loops for phase 6."""
    from kmer_denovo_filter_tpu_torch import engine as eng
    from kmer_denovo_filter_tpu_torch.experiments.x_join_variants import (
        WideBatchDedupCounter,
    )
    from kmer_denovo_filter_tpu_torch.ops import device as dev
    from kmer_denovo_filter_tpu_torch.ops import extract
    from kmer_denovo_filter_tpu_torch.ops import keys as keys64
    profiles = []
    # the engine's two forms, then the whole-batch dedup it replaced
    forms = {"K1w->K7": lambda index: eng.FilteredCounter(index),
             "K1w->K9dw->K7": lambda index: eng.FilteredCounter(
                 index, dedup=True),
             "K1w->dedup->K7w": WideBatchDedupCounter}
    for k in (63, 201):
        if k == 201:
            batches = [synth_reads(rng, genome, B, L_K201)
                       for _ in range(WIDE_BATCHES[k])]
        else:
            batches = batches_152[:WIDE_BATCHES[k]]
        width = batches[0].shape[1]
        lens = np.full(B, width, np.int32)
        lens_t = torch.from_numpy(lens).to(cuda)
        n_reads = len(batches) * B
        seen = dev.unique_rows(torch.cat([
            dev.unique_rows(extract.extract_canonical_wide(
                torch.from_numpy(c).to(cuda), lens_t, k).flatten(0, 1))[0]
            for c in batches]))[0]
        seen = seen[seen[:, 0] != keys64.SENTINEL]
        m = WIDE_FILTER_M[k]
        table = make_table_wide(rng, seen, m, k, cuda,
                                n_from=seen.shape[0])
        index = eng.KmerIndex(keys64.limbs_to_words(table, k), k,
                              device=cuda)
        if not torch.equal(index.table, table):
            fail("KmerIndex table does not round-trip the limb rows")
        del table

        def feed_all(fc, batches=batches, lens=lens):
            for c in batches:
                fc.feed(c, lens)
            torch.cuda.synchronize()
            return fc

        def run_feed(name, index=index, n_reads=n_reads, feed_all=feed_all):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fc = feed_all(forms[name](index))
            return fc.acc, n_reads / (time.perf_counter() - t)

        torch.cuda.synchronize()
        t = time.perf_counter()
        plain = torch.zeros(index.n, dtype=torch.int64, device=cuda)
        for c in batches:
            win = dev.extract_canonical_windows_wide(
                torch.from_numpy(c).to(cuda), lens_t, k)[0]
            plain += dev.small_table_tally_wide(index.table,
                                                win.flatten(0, 1))
        torch.cuda.synchronize()
        plain_rate = n_reads / (time.perf_counter() - t)
        for name in forms:  # warm-up
            run_feed(name)
        rates = {name: [] for name in forms}
        order = list(forms) + list(forms)[::-1]
        for name in order:
            acc, rate = run_feed(name)
            rates[name].append(rate)
            if not torch.equal(acc, plain):
                fail(f"parent filter {name} at k={k}, M={m} differs from "
                     "the plain path")
            del acc
        fc = eng.FilteredCounter(index, dedup=True)
        t = time.perf_counter()
        fc.result()
        result_ms = (time.perf_counter() - t) * 1e3
        feeds = ", ".join(f"{name} {rates[name][0]:.1f} / "
                          f"{rates[name][1]:.1f}" for name in forms)
        print(f"[5c] parent filter k={k} M={m} ({seen.shape[0]} batch keys, "
              f"{8 * index.table.numel() >> 20} MB table): {n_reads} reads x "
              f"{width} bp, {int(plain.sum())} hits, all three forms equal "
              f"to plain; feed reads/s {feeds}, plain {plain_rate:.1f}; "
              f"result() of the {8 * m >> 20} MB accumulator "
              f"{result_ms:.3f} ms ({card})", flush=True)
        del plain, fc, seen
        if k == 63:
            for name in forms:
                profiles.append((
                    f"parent filter k=63 M={m} {name} (feed)", len(batches),
                    lambda name=name, index=index, feed_all=feed_all:
                    feed_all(forms[name](index)),
                    n_reads / max(rates[name])))
        else:
            del index

    k = 63
    batches = batches_152
    lens = np.full(B, L, np.int32)
    n_reads = len(batches) * B
    flat = torch.cat([extract.extract_canonical_wide(
        torch.from_numpy(c).to(cuda), torch.from_numpy(lens).to(cuda),
        k).flatten(0, 1) for c in batches[:2]])
    scan_index = eng.KmerIndex(keys64.limbs_to_words(
        make_table_wide(rng, flat, SCAN_M, k, cuda), k), k, device=cuda)
    del flat
    small = [(c[i:i + GROUP_B], lens[i:i + GROUP_B])
             for c in batches for i in range(0, B, GROUP_B)]
    groups = [small[i:i + GROUP] for i in range(0, len(small), GROUP)]
    scan_many = eng.make_scanner_many(scan_index)

    def run_scan():
        torch.cuda.synchronize()
        t = time.perf_counter()
        masks = [scan_many(g) for g in groups]
        return masks, n_reads / (time.perf_counter() - t)

    def run_scan_plain():
        torch.cuda.synchronize()
        t = time.perf_counter()
        masks = []
        for g in groups:
            gc, gl = stack_group(g)
            win = dev.extract_canonical_windows_wide(
                torch.from_numpy(gc).to(cuda), torch.from_numpy(gl).to(cuda),
                k)[0]
            found = dev.member_wide(scan_index.table, win.flatten(0, 1))
            masks.append(np.split(found.reshape(win.shape[:2]).cpu().numpy(),
                                  len(g)))
        return masks, n_reads / (time.perf_counter() - t)

    run_scan()  # warm-up
    ref_masks, plain_a = run_scan_plain()
    got_a, scan_a = run_scan()
    got_b, scan_b = run_scan()
    _ref_b, plain_b = run_scan_plain()
    n_found = 0
    for got in (got_a, got_b):
        for g_got, g_ref in zip(got, ref_masks):
            for mask, ref in zip(g_got, g_ref):
                if not np.array_equal(mask, ref):
                    fail("k=63 anchoring scan differs from the plain path")
                n_found += int(mask.sum())
    if not n_found:
        fail("k=63 anchoring scan found nothing")
    print(f"[5c] anchoring scan k=63 M={SCAN_M}: {len(groups)} groups of "
          f"{GROUP} x {GROUP_B} reads, {n_found // 2} windows found, equal "
          f"to plain; reads/s kernel {scan_a:.1f} / {scan_b:.1f}, plain "
          f"{plain_a:.1f} / {plain_b:.1f} ({card})", flush=True)
    profiles.append((f"anchoring scan k=63 M={SCAN_M}", len(groups),
                     run_scan, n_reads / max(scan_a, scan_b)))
    return profiles


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA GPU")
    from kmer_denovo_filter_tpu_torch import cli, engine as eng, tracing
    from kmer_denovo_filter_tpu_torch.experiments.x_join_variants import (
        BatchDedupCounter,
    )
    from kmer_denovo_filter_tpu_torch.ops import (
        _cuda,
        extract,
        probe,
        segsort,
        sortcount,
    )
    from kmer_denovo_filter_tpu_torch.ops import device as dev
    from kmer_denovo_filter_tpu_torch.ops import directory as tdir
    from kmer_denovo_filter_tpu_torch.ops import keys as keys64
    from kmer_denovo_filter_tpu_torch.ops.timing import device_ms

    cuda = torch.device("cuda", 0)
    sentinel = keys64.SENTINEL
    # every kernel's launch counter (tracing's launches.<kernel>); K1 cut
    # at a stage (extract_canonical_stage, the xmicro probes) is not in
    # the JSON
    reset_counts, read_counts = tracing.reset, tracing.launches

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
            if ("ptxas info" in line and ("Used" in line or "entry" in line)
                    or "spill" in line):
                print("    " + line.strip())

    # ── 3. kernels against their plain versions ────────────────────
    rng = np.random.default_rng(0)
    codes_np, lengths_np = random_batch(rng)
    codes = torch.from_numpy(codes_np).to(cuda)
    lengths = torch.from_numpy(lengths_np).to(cuda)
    err = {name: 0.0 for name in tracing.KERNELS}
    times = {}

    def check(name, got, ref, what):
        torch.cuda.synchronize()
        e = max_abs_err(got, ref)
        err[name] = max(err[name], e)
        if e:
            fail(f"{name} differs from plain at {what}")

    for k in KS:
        got = extract.extract_canonical(codes, lengths, k)
        check("extract_canonical", got,
              dev.extract_canonical_windows(codes, lengths, k)[0], f"k={k}")
        ms = device_ms(lambda: extract.extract_canonical(codes, lengths, k))
        plain_ms = device_ms(
            lambda: dev.extract_canonical_windows(codes, lengths, k))
        # codes and lengths read, keys written; ~6 operations a window
        # (two shift-ors, the min, the validity test)
        lim = bound(codes.numel() + 4 * B + 8 * got.numel(), 6 * got.numel())
        times[("extract_canonical", k)] = (ms, plain_ms, lim)
        live = int((got != sentinel).sum())
        print(f"[3] K1 k={k}: equal ({got.numel()} windows, {live} live); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{lim[0]:.4f} ms by {lim[1]}", flush=True)
        flat = got.reshape(-1)
        for m in TABLE_MS + ((BIG_M,) if k == 31 else ()):
            table = make_table(rng, flat, m, k, sentinel, cuda)
            d = tdir.build_directory(table)
            acc = torch.zeros(m, dtype=torch.int64, device=cuda)
            probe.probe_tally(flat, table, acc, d)
            ref = dev.small_table_tally(table, flat)
            check("probe_tally", acc, ref, f"k={k}, M={m}")
            ms = device_ms(lambda: probe.probe_tally(flat, table, acc, d))
            plain_ms = device_ms(
                lambda: acc.add_(dev.small_table_tally(table, flat)))
            # keys read; each row hit: key read, count read and written
            lim = probe_bound(8, 24, flat, table, sentinel)
            times[("probe_tally", k, m)] = (ms, plain_ms, lim)
            print(f"[3] K2 k={k} M={m}: equal ({int(ref.sum())} hits); "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{lim[0]:.4f} ms by {lim[1]}", flush=True)

    extract_row(cuda, check, times, 31, "3")

    # K3 at k = 31: the batch above, its dedup; K2 and K4 through the
    # directory (3p) also on a stacked group of 8 x 4,096 reads of widths
    # 152, 144, ..., 96 and on a 40x batch
    k = 31
    flat = extract.extract_canonical(codes, lengths, k).reshape(-1)
    uniq, weights = dev.dedup_windows(flat)
    group_np = stack_group([
        (codes_np[i * GROUP_B:(i + 1) * GROUP_B, :L - 8 * i],
         np.minimum(lengths_np[i * GROUP_B:(i + 1) * GROUP_B], L - 8 * i))
        for i in range(GROUP)])
    flat_g = extract.extract_canonical(
        *(torch.from_numpy(a).to(cuda) for a in group_np), k).reshape(-1)
    flat_40x = batch_40x(cuda)
    print(f"[3] k=31 batch: {flat.numel()} windows, {uniq.numel()} distinct "
          f"after dedup; group of {GROUP} x {GROUP_B} reads: "
          f"{flat_g.numel()} windows; 40x batch: {flat_40x.numel()} windows, "
          f"{torch.unique(flat_40x).numel()} distinct", flush=True)
    # K3 through the directory, flat (the whole-batch dedup) and on K9d's
    # slots, on the random and the 40x batch; K9d -> K3 must make no host
    # sync (CUDA sync debugging set to raise around it)
    k3_batches = {"random": (flat, uniq, weights),
                  "40x": (flat_40x, *dev.dedup_windows(flat_40x))}
    for label, (keys_b, uniq_b, weights_b) in k3_batches.items():
        slots = segsort.seg_dedup(keys_b)
        live_slots = dev.segment_compact(*slots)[0]
        n_segs = slots[0].shape[0]
        for m in K3_MS:
            table = make_table(rng, keys_b, m, k, sentinel, cuda)
            d = tdir.build_directory(table)
            ref = dev.small_table_tally(table, keys_b)
            acc = torch.zeros(m, dtype=torch.int64, device=cuda)
            probe.probe_tally_weighted(uniq_b, weights_b, table, acc, d)
            check("probe_tally_weighted", acc, ref, f"{label} batch, M={m}, "
                  "flat")
            acc.zero_()
            probe.probe_tally_weighted(slots[0], slots[1], table, acc, d,
                                       slots[2])
            check("probe_tally_weighted", acc, ref, f"{label} batch, M={m}, "
                  "slots")
            if m == BIG_M:
                acc.zero_()
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got = segsort.seg_dedup(keys_b)
                    probe.probe_tally_weighted(got[0], got[1], table, acc, d,
                                               got[2])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                check("probe_tally_weighted", acc, ref, f"{label} batch, "
                      f"M={m}, K9d -> K3 with sync debugging on")
            ms = device_ms(lambda: probe.probe_tally_weighted(
                uniq_b, weights_b, table, acc, d))
            slots_ms = device_ms(lambda: probe.probe_tally_weighted(
                slots[0], slots[1], table, acc, d, slots[2]))
            plain_ms = device_ms(lambda: dev.weighted_tally(
                table, uniq_b, weights_b, acc))
            plain_slots_ms = device_ms(lambda: dev.weighted_tally(
                table, *dev.segment_compact(*slots), acc))
            # keys read, the weight of each key found, each row hit as
            # for K2; the slots form also reads the counts
            lim = probe_bound(8, 24, uniq_b, table, sentinel,
                              8 * int(torch.isin(uniq_b, table).sum()))
            slots_lim = probe_bound(
                8, 24, live_slots, table, sentinel,
                8 * int(torch.isin(live_slots, table).sum()) + 4 * n_segs)
            times[("probe_tally_weighted", label, m)] = (
                ms, plain_ms, lim, slots_ms, plain_slots_ms, slots_lim)
            print(f"[3] K3 {label} batch M={m}: flat and slots equal "
                  f"({int(ref.sum())} hits; {uniq_b.numel()} flat keys, "
                  f"{live_slots.numel()} live slots); kernel flat "
                  f"{ms:.4f} ms, slots {slots_ms:.4f} ms; plain flat "
                  f"{plain_ms:.4f} ms, slots (compaction + tally) "
                  f"{plain_slots_ms:.4f} ms; bound flat {lim[0]:.4f} ms by "
                  f"{lim[1]}, slots {slots_lim[0]:.4f} ms by {slots_lim[1]}",
                  flush=True)
            del table, d, ref, acc
        dedup_ms = device_ms(lambda: dev.dedup_windows(keys_b))
        k9d_ms = device_ms(lambda: segsort.seg_dedup(keys_b))
        print(f"[3] {label} batch: the dedups in front of K3: "
              f"dedup_windows {dedup_ms:.4f} ms, K9d {k9d_ms:.4f} ms; K9d -> "
              "K3 made no host sync", flush=True)

    # ── 3p. K2 and K4 through the prefix directory ─────────────────
    phase_3p({"random": (flat, flat_g), "40x": (flat_40x, None)}, cuda,
             check, times)

    # ── 3s. segment-local sort and dedup against their plain versions
    phase_3s(flat, flat_40x, cuda, check, times)

    phase_3s_wide(rng, cuda, check, times)

    # ── 3w. wide kernels against their plain versions ──────────────
    phase_3w(rng, cuda, check, times)

    # ── 3r. K10 and K11 against their plain versions ───────────────
    phase_3r(rng, cuda, check, times)

    # ── 3c. K12 against its plain version ──────────────────────────
    phase_3c(rng, codes, lengths, cuda, check, times)

    # ── 4. main path, VCF mode: kmer-denovo-torch on the GIAB trio ──
    giab = os.path.join(REPO, "tests", "data", "giab")
    goldens = os.path.join(REPO, "tests", "goldens")
    giab_files = sorted(os.listdir(giab))
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
        reset_counts()
        t0 = time.perf_counter()
        cli.vcf_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_vcf = read_counts()
        outputs_4 = {}
        with gzip.open(os.path.join(out, "annotated.vcf.gz")) as fh:
            outputs_4["annotated.vcf.gz"] = fh.read()
        with gzip.open(os.path.join(goldens, "annotated.vcf.gz")) as fh:
            if outputs_4["annotated.vcf.gz"] != fh.read():
                fail("annotated.vcf.gz differs from tests/goldens")
        for name in ("metrics.json", "summary.txt"):
            with open(os.path.join(out, name), "rb") as a, \
                    open(os.path.join(goldens, name), "rb") as b:
                outputs_4[name] = a.read()
                if outputs_4[name] != b.read():
                    fail(f"{name} differs from tests/goldens")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for name in ("extract_canonical", "probe_tally", "build_directory",
                 "words_to_keys"):
        if launches_vcf[name] <= 0:
            fail(f"kernel {name} was not launched on the VCF main path")
    print(f"[4] kmer-denovo-torch: 3 goldens byte-equal in {wall:.3f} s; "
          f"launches {launches_vcf}", flush=True)

    # ── 4b. main path, discovery: kmer-discovery-torch ─────────────
    out = tempfile.mkdtemp(prefix="kdf_chip_smoke_")
    try:
        prefix = os.path.join(out, "giab_discovery")
        argv = [
            "--child", os.path.join(giab, "HG002_child.bam"),
            "--mother", os.path.join(giab, "HG004_mother.bam"),
            "--father", os.path.join(giab, "HG003_father.bam"),
            "--ref-fasta", os.path.join(giab, "mini_ref.fa"),
            "--ref-jf", os.path.join(giab, "mini_ref.fa.k31.jf"),
            "--out-prefix", prefix,
            "--min-child-count", "3",
            "--kmer-size", "31",
            "--candidate-summary", os.path.join(goldens, "summary.txt"),
        ]
        reset_counts()
        t0 = time.perf_counter()
        cli.discovery_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_disc = read_counts()
        for suffix in DISCOVERY_OUTPUTS:
            with open(f"{prefix}.{suffix}", "rb") as a, open(os.path.join(
                    goldens, f"giab_discovery.{suffix}"), "rb") as b:
                got = outputs_4[f"giab_discovery.{suffix}"] = a.read()
                if got != b.read():
                    fail(f"giab_discovery.{suffix} differs from "
                         "tests/goldens")
        if not os.path.isfile(f"{prefix}.informative.bam.bai"):
            fail("the informative BAM was not written and indexed")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for name in ("extract_canonical", "seg_dedup", "probe_tally_weighted",
                 "probe_member", "build_directory", "words_to_keys",
                 "sort_count"):
        if launches_disc[name] <= 0:
            fail(f"kernel {name} was not launched on the discovery path")
    if sorted(os.listdir(giab)) != giab_files:
        fail("the main paths wrote into tests/data/giab")
    print(f"[4b] kmer-discovery-torch: 6 goldens byte-equal in {wall:.3f} s; "
          f"launches {launches_disc}", flush=True)

    # ── 4c. main path, wide: both CLIs at k = 63 ──────────────────
    launches_wide = phase_4c(cuda, reset_counts, read_counts)

    # ── 4d. both CLIs as one process of a multi-host run; the report ─
    launches_4d = phase_4d(outputs_4, reset_counts, read_counts)

    # ── 5. scale: FilteredCounter on cuda vs the plain path ────────
    k = 31
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, GENOME_BASES, dtype=np.uint8)
    batches = [synth_reads(rng, genome, B, L)
               for _ in range(SCALE_BATCHES)]
    lens = np.full(B, L, np.int32)
    lens_t = torch.from_numpy(lens).to(cuda)
    seen = torch.unique(torch.cat([
        extract.extract_canonical(torch.from_numpy(c).to(cuda), lens_t,
                                  k).reshape(-1).unique()
        for c in batches]))
    n_reads = SCALE_BATCHES * B

    def feed_all(fc):
        for c in batches:
            fc.feed(c, lens)
        torch.cuda.synchronize()
        return fc

    def run_counter(fc):
        """(counts, reads/s of the feed loop; the one result() copy a
        real scan makes per BAM is not timed)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        feed_all(fc)
        rate = n_reads / (time.perf_counter() - t)
        return fc.result(), rate

    def run_plain_path(index):
        """(the plain path's accumulator on the card, reads/s)."""
        acc = torch.zeros(index.n, dtype=torch.int64, device=cuda)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for c in batches:
            dev.small_tally_step(index.table, acc,
                                 torch.from_numpy(c).to(cuda), lens_t, k)
        torch.cuda.synchronize()
        return acc, n_reads / (time.perf_counter() - t)

    for m in SCALE_TABLE_MS:
        table = make_table(rng, seen, m, k, sentinel, cuda)
        index = eng.KmerIndex(keys64.keys64_to_words(table, k), k,
                              device=cuda)
        if not torch.equal(index.table, table):
            fail("KmerIndex table does not round-trip the int64 keys")
        describe_directory("[5]", index)
        run_counter(eng.FilteredCounter(index))  # warm-up
        run_plain_path(index)
        p1, plain_a = run_plain_path(index)
        r1, kern_a = run_counter(eng.FilteredCounter(index))
        r2, kern_b = run_counter(eng.FilteredCounter(index))
        p2, plain_b = run_plain_path(index)
        for other in (r2, p1.cpu().numpy(), p2.cpu().numpy()):
            if not np.array_equal(r1, other):
                fail(f"scale M={m}: FilteredCounter differs from plain")
        print(f"[5] scale M={m}: {n_reads} reads x {L} bp, "
              f"{int(r1.sum())} hits, equal to plain; reads/s kernel "
              f"{kern_a:.1f} / {kern_b:.1f}, plain {plain_a:.1f} / "
              f"{plain_b:.1f} ({card})", flush=True)
        profile_loop(f"M={m}", SCALE_BATCHES,
                     lambda: feed_all(eng.FilteredCounter(index)),
                     n_reads / max(kern_a, kern_b), card)

    # ── 5b, 5d. discovery scale: the parent filter in three forms ──
    forms = {"K1->K2": False, "K1->K9d->K3": True}
    batch_form = "K1->dedup->K3"

    def counter(name, index):
        return (BatchDedupCounter(index) if name == batch_form
                else eng.FilteredCounter(index, dedup=forms[name]))

    def run_feed(name, index):
        """(the form's accumulator on the card, reads/s of its feeds)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        fc = feed_all(counter(name, index))
        return fc.acc, n_reads / (time.perf_counter() - t)

    reset_counts()
    for m in FILTER_MS:
        table = make_table(rng, seen, m, k, sentinel, cuda,
                           n_from=seen.numel())
        index = eng.KmerIndex(keys64.keys64_to_words(table, k), k,
                              device=cuda)
        del table
        describe_directory("[5b]", index)
        for name in list(forms) + [batch_form]:  # warm-up
            run_feed(name, index)
        plain, plain_rate = run_plain_path(index)
        rates = {name: [] for name in list(forms) + [batch_form]}
        for name in ("K1->K2", "K1->K9d->K3", batch_form, batch_form,
                     "K1->K9d->K3", "K1->K2"):
            acc, rate = run_feed(name, index)
            rates[name].append(rate)
            if not torch.equal(acc, plain):
                fail(f"parent filter {name} at M={m} differs from the "
                     "plain path")
            del acc
        fc = eng.FilteredCounter(index, dedup=True)
        t = time.perf_counter()
        fc.result()
        result_ms = (time.perf_counter() - t) * 1e3
        print(f"[5b] parent filter M={m} ({seen.numel()} batch keys): "
              f"{n_reads} reads, {int(plain.sum())} hits, both forms equal "
              f"to plain; feed reads/s K1->K2 {rates['K1->K2'][0]:.1f} / "
              f"{rates['K1->K2'][1]:.1f}, K1->K9d->K3 "
              f"{rates['K1->K9d->K3'][0]:.1f} / "
              f"{rates['K1->K9d->K3'][1]:.1f}, plain {plain_rate:.1f}; "
              f"result() of the {8 * m >> 20} MB accumulator "
              f"{result_ms:.3f} ms ({card})", flush=True)
        print(f"[5d] parent filter M={m}: the whole-batch form {batch_form} "
              f"equal to plain; feed reads/s {rates[batch_form][0]:.1f} / "
              f"{rates[batch_form][1]:.1f}, interleaved with K1->K2 and "
              f"K1->K9d->K3 above ({card})", flush=True)
        del plain, fc
        if m in (BIG_M, FILTER_MS[-1]):
            for name in list(forms) + [batch_form]:
                profile_loop(
                    f"parent filter M={m} {name} (feed)", SCALE_BATCHES,
                    lambda: feed_all(counter(name, index)),
                    n_reads / max(rates[name]), card)
        del index
    launches_5d = read_counts()
    if launches_5d["seg_dedup"] <= 0:
        fail("kernel seg_dedup was not launched by the 5d filter loops")
    print(f"[5d] launches over the 5b/5d filter loops: {launches_5d}",
          flush=True)

    scan_table = make_table(rng, seen, SCAN_M, k, sentinel, cuda)
    scan_index = eng.KmerIndex(keys64.keys64_to_words(scan_table, k), k,
                               device=cuda)
    describe_directory("[5b] scan", scan_index)
    small = [(c[i:i + GROUP_B], lens[i:i + GROUP_B])
             for c in batches for i in range(0, B, GROUP_B)]
    groups = [small[i:i + GROUP] for i in range(0, len(small), GROUP)]
    scan_many = eng.make_scanner_many(scan_index)

    def run_scan():
        torch.cuda.synchronize()
        t = time.perf_counter()
        masks = [scan_many(g) for g in groups]
        return masks, n_reads / (time.perf_counter() - t)

    def run_scan_plain():
        torch.cuda.synchronize()
        t = time.perf_counter()
        masks = []
        for g in groups:
            gc, gl = stack_group(g)
            found = dev.small_scan_hits_step(
                scan_index.table, torch.from_numpy(gc).to(cuda),
                torch.from_numpy(gl).to(cuda), k).cpu().numpy()
            masks.append(np.split(found, len(g)))
        return masks, n_reads / (time.perf_counter() - t)

    run_scan()  # warm-up
    run_scan_plain()
    ref_masks, plain_a = run_scan_plain()
    got_a, scan_a = run_scan()
    got_b, scan_b = run_scan()
    _ref_b, plain_b = run_scan_plain()
    n_found = 0
    for got in (got_a, got_b):
        for g_got, g_ref in zip(got, ref_masks):
            for mask, ref in zip(g_got, g_ref):
                if not np.array_equal(mask, ref):
                    fail("anchoring scan differs from the plain path")
                n_found += int(mask.sum())
    print(f"[5b] anchoring scan M={SCAN_M}: {len(groups)} groups of "
          f"{GROUP} x {GROUP_B} reads, {n_found // 2} windows found, equal "
          f"to plain; reads/s kernel {scan_a:.1f} / {scan_b:.1f}, plain "
          f"{plain_a:.1f} / {plain_b:.1f} ({card})", flush=True)
    profile_loop(f"anchoring scan M={SCAN_M}", len(groups),
                 run_scan, n_reads / max(scan_a, scan_b), card)
    del scan_index, scan_table, seen

    # ── 5c. wide scale: parent filter at k = 63 and 201, scan ──────
    for label, n_batches, run, wall in phase_5c(rng, genome, batches, cuda,
                                                card):
        profile_loop(label, n_batches, run, wall, card)

    # ── 8, 8b. the sharded engine on one card; a one-process group ─
    launches_8 = phase_8(batches, cuda, card, reset_counts, read_counts,
                         times)
    launches_8b = phase_8b(batches, cuda, reset_counts, read_counts)
    phase_8_stream_split(genome, batches, cuda, card, {
        "plain (the parent's step)": lambda flat, k: (
            dev.sort_count_wide(flat) if flat.dim() == 2
            else dev.sort_count(flat)),
        "K12": lambda flat, k: (
            sortcount.sort_count_wide(flat, k) if flat.dim() == 2
            else sortcount.sort_count(flat, k))})
    del batches

    # ── 7. the ported experiment commands ─────────────────────────
    launches_7 = phase_7(reset_counts, read_counts)
    print(f"[7] launches over the experiments: {launches_7}", flush=True)
    for name in ("seg_sort", "seg_dedup"):
        if launches_7[name] <= 0:
            fail(f"kernel {name} was not launched by the experiments")

    # ── 9. the entry points ───────────────────────────────────────
    launches_9 = phase_9(cuda, reset_counts, read_counts)

    if "jax" in sys.modules or any(
            m == "kmer_denovo_filter_tpu"
            or m.startswith("kmer_denovo_filter_tpu.") for m in sys.modules):
        fail("jax or the JAX package was imported")

    # ── the kernels' line: main-path launches, errors, times, bounds ─
    k1_ms, k1_plain, k1_lim = times[("extract_canonical", 31)]
    k2_ms, k2_plain, _k2_search, k2_lim = times[("probe_tally", "random",
                                                   BIG_M)]
    # K3 on K9d's slots of the 40x batch: the main path's form and data
    _ms, _plain, _lim, k3_ms, k3_plain, k3_lim = times[(
        "probe_tally_weighted", "40x", BIG_M)]
    k4_ms, k4_plain, k4_isin, _k4_search, k4_lim = times[(
        "probe_member", "group", "random", BIG_M)]
    dir_ms, dir_plain, dir_lim, dir_lib = times[("build_directory", "random",
                                                 BIG_M)]
    launches = {name: launches_vcf[name] + launches_disc[name]
                for name in tracing.KERNELS}
    for name in ("extract_canonical_wide", "probe_tally_wide",
                 "probe_tally_wide_weighted", "probe_member_wide",
                 "seg_dedup_wide"):
        launches[name] = sum(run[name] for run in launches_wide)
    # the directory and K11: narrow tables in 4 and 4b, wide ones in 4c;
    # K12: the child count of 4b (k = 31) and 4c (k = 63)
    for name in ("build_directory", "words_to_keys", "sort_count"):
        launches[name] += sum(run[name] for run in launches_wide)
    # K10's path is the sharded engine: its launches in 8 and 8b
    launches["route"] = launches_8["route"] + launches_8b["route"]
    # K9 is on no main path: its launches in 5d and 7
    launches["seg_sort"] = launches_5d["seg_sort"] + launches_7["seg_sort"]
    # the multi-host CLIs (4d), the sharded engine on [cuda:0] * S (8),
    # the one-process group (8b) and the entry points (9) are other
    # paths: their launches stand apart, a count for each
    other_paths = {"4d": launches_4d, "8": (launches_8,),
                   "8b": (launches_8b,), "9": (launches_9,)}
    wide = {name: times[(name, 63, BIG_M)]
            for name in ("probe_tally_wide", "probe_member_wide")}
    # K7 weighted on K9dw's slots: the main path's form
    wide["probe_tally_wide_weighted"] = times[("probe_tally_wide_slots", 63,
                                               BIG_M)]
    wide["extract_canonical_wide"] = times[("extract_canonical_wide", 63)]
    wide_replaces = {
        "extract_canonical_wide": "kmer_denovo_filter_tpu/ops/device.py:33",
        "probe_tally_wide": "kmer_denovo_filter_tpu/ops/pallas_join.py:1905",
        "probe_tally_wide_weighted":
            "kmer_denovo_filter_tpu/ops/pallas_join.py:1905",
        "probe_member_wide":
            "kmer_denovo_filter_tpu/ops/pallas_join.py:1997"}
    wide_source = {
        "extract_canonical_wide":
            "kmer_denovo_filter_tpu_torch/csrc/extract_wide.cu",
        "probe_tally_wide": "kmer_denovo_filter_tpu_torch/csrc/probe_wide.cu",
        "probe_tally_wide_weighted":
            "kmer_denovo_filter_tpu_torch/csrc/probe_wide.cu",
        "probe_member_wide":
            "kmer_denovo_filter_tpu_torch/csrc/probe_wide.cu"}
    report = {"kernels": [
        {"name": "extract_canonical", "route": "cuda",
         "source": "kmer_denovo_filter_tpu_torch/csrc/extract_canonical.cu",
         "replaces": "kmer_denovo_filter_tpu/ops/pallas_extract.py:54",
         "launches": launches["extract_canonical"],
         "max_abs_err": err["extract_canonical"],
         "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_lim[0], "bound_by": k1_lim[1], "library_ms": None},
        {"name": "probe_tally", "route": "cuda",
         "source": "kmer_denovo_filter_tpu_torch/csrc/probe_tally.cu",
         "replaces": "kmer_denovo_filter_tpu/ops/pallas_probe.py:99",
         "launches": launches["probe_tally"],
         "max_abs_err": err["probe_tally"],
         "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_lim[0], "bound_by": k2_lim[1], "library_ms": None},
        {"name": "probe_tally_weighted", "route": "cuda",
         "source": "kmer_denovo_filter_tpu_torch/csrc/probe_tally.cu",
         "replaces": "kmer_denovo_filter_tpu/ops/pallas_join.py:679",
         "launches": launches["probe_tally_weighted"],
         "max_abs_err": err["probe_tally_weighted"],
         "ms": k3_ms, "plain_ms": k3_plain,
         "bound_ms": k3_lim[0], "bound_by": k3_lim[1], "library_ms": None},
        {"name": "probe_member", "route": "cuda",
         "source": "kmer_denovo_filter_tpu_torch/csrc/probe_member.cu",
         "replaces": "kmer_denovo_filter_tpu/ops/pallas_join.py:223",
         "launches": launches["probe_member"],
         "max_abs_err": err["probe_member"],
         "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": k4_lim[0], "bound_by": k4_lim[1],
         "library_ms": k4_isin},
        {"name": "build_directory", "route": "cuda",
         "source": "kmer_denovo_filter_tpu_torch/csrc/directory.cu",
         "replaces": "kmer_denovo_filter_tpu/ops/device.py:572",
         "launches": launches["build_directory"],
         "max_abs_err": err["build_directory"],
         "ms": dir_ms, "plain_ms": dir_plain,
         "bound_ms": dir_lim[0], "bound_by": dir_lim[1],
         "library_ms": dir_lib},
    ] + [
        {"name": name, "route": "cuda", "source": wide_source[name],
         "replaces": wide_replaces[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
         "bound_ms": lim[0], "bound_by": lim[1], "library_ms": None}
        for name, (ms, plain_ms, lim) in wide.items()]}
    # K9dw: the 40x batch at k = 63
    times[("seg_dedup_wide", "40x")] = times[("seg_dedup_wide", 63, "40x")]
    for name, replaces, source in (
            ("seg_sort", "scripts/x_fused.py:133", "seg_sort.cu"),
            ("seg_dedup", "kmer_denovo_filter_tpu/ops/pallas_join.py:600",
             "seg_sort.cu"),
            ("seg_dedup_wide",
             "kmer_denovo_filter_tpu/ops/pallas_join.py:1494",
             "seg_dedup_wide.cu")):
        ms, plain_ms, library_ms, lim = times[(name, "40x")]
        report["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"kmer_denovo_filter_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": lim[0], "bound_by": lim[1],
            "library_ms": library_ms})
    route_ms, route_plain, route_lib, route_lim = times[("route", 31, 4)]
    # K12 on the 40x batch at k = 31, the call with its sync
    k12_ms, k12_plain, k12_lib, k12_lim, _launch_ms = times[(
        "sort_count", "k=31 40x batch")]
    k11_ms, k11_plain, k11_lim, _upload = times[("words_to_keys", 31)]
    report["kernels"] += [
        {"name": "route", "route": "cuda",
         "source": "kmer_denovo_filter_tpu_torch/csrc/route.cu",
         "replaces": "kmer_denovo_filter_tpu/parallel/sharded.py:61",
         "launches": launches["route"], "max_abs_err": err["route"],
         "ms": route_ms, "plain_ms": route_plain,
         "bound_ms": route_lim[0], "bound_by": route_lim[1],
         "library_ms": route_lib},
        {"name": "words_to_keys", "route": "cuda",
         "source": "kmer_denovo_filter_tpu_torch/csrc/words_to_keys.cu",
         "replaces": "kmer_denovo_filter_tpu_torch/ops/keys.py:85",
         "launches": launches["words_to_keys"],
         "max_abs_err": err["words_to_keys"], "ms": k11_ms,
         "plain_ms": k11_plain, "bound_ms": k11_lim[0],
         "bound_by": k11_lim[1], "library_ms": None},
        {"name": "sort_count", "route": "cuda",
         "source": "kmer_denovo_filter_tpu_torch/csrc/sort_count.cu",
         "replaces": "kmer_denovo_filter_tpu/ops/device.py:121",
         "launches": launches["sort_count"],
         "max_abs_err": err["sort_count"], "ms": k12_ms,
         "plain_ms": k12_plain, "bound_ms": k12_lim[0],
         "bound_by": k12_lim[1], "library_ms": k12_lib}]
    for entry in report["kernels"]:
        entry["launches_by_phase"] = {
            phase: sum(run.get(entry["name"], 0) for run in runs)
            for phase, runs in other_paths.items()}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
