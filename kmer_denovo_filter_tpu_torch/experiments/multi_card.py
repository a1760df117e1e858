"""The sharded engine and N-process runs over every card of one host.

    python -m kmer_denovo_filter_tpu_torch.experiments.multi_card [--batches N]

Needs 2 or more CUDA devices; with C of them:

1. ``mesh``: the ``chip_smoke.py`` phase-8 recipe (N batches of 32,768
   synthetic 40x reads of 152 bp, an M = 2**20 table, k = 31 and 63) on
   the mesh of all C cards: ``ShardedFilteredCounter`` (both forms),
   ``ShardedKmerIndex.membership``, ``sharded_scan_reads_for_hits`` and
   ``sharded_count`` equal to the single-card engine on cuda:0; then the
   plain filter's reads/s on one card, on the C-card mesh and on C
   shards of one card, interleaved (each counter built before its loop).
2. ``processes``: C processes joined over ``KDF_COORDINATOR`` (NCCL, one
   card each): ``sharded_count_multihost`` (each process its own rows)
   and ``merge_counts_sharded`` against the single-process count on
   cuda:0, the merge's owner partition against ``_owner_of_keys``; then
   ``kmer-denovo-torch`` and ``kmer-discovery-torch`` as C processes on
   the GIAB trio of ``tests/data/giab``, process 0's outputs equal to
   ``tests/goldens`` byte for byte.

Every comparison is exact; a mismatch raises.  Run from a checkout (the
trio and the goldens are read from ``tests/``).
"""

import argparse
import gzip
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch import steps
from kmer_denovo_filter_tpu_torch.experiments._common import (
    BATCH_READS,
    GENOME_BASES,
    READ_LEN,
    parity,
    synth_reads,
)
from kmer_denovo_filter_tpu_torch.ops import keys as keys64

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GIAB = os.path.join(REPO, "tests", "data", "giab")
GOLD = os.path.join(REPO, "tests", "goldens")
TABLE_M = 1 << 20
DISCOVERY_OUTPUTS = ("bed", "kmer_coverage.bedgraph", "read_coverage.bed",
                     "metrics.json", "summary.txt", "sv.bedpe")


def _batches(n):
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, GENOME_BASES, dtype=np.uint8)
    return [synth_reads(rng, genome, BATCH_READS) for _ in range(n)]


def _table_words(flat, k, seed):
    """(M, W) words: half distinct live keys of *flat*, half random."""
    gen = torch.Generator(device=flat.device).manual_seed(seed)
    if flat.dim() == 1:
        flat = flat[:, None]
    live = torch.unique(flat[flat[:, 0] != keys64.SENTINEL], dim=0)
    live = live[torch.randperm(live.shape[0], generator=gen,
                               device=flat.device)[:TABLE_M // 2]]
    rand = torch.stack([torch.randint(0, 4 ** nb, (TABLE_M,), generator=gen,
                                      device=flat.device)
                        for nb in keys64.limb_bases(k)], 1)
    rows = torch.unique(torch.cat([live, rand]), dim=0)[:TABLE_M]
    if k > keys64.NARROW_K:
        return keys64.limbs_to_words(rows, k)
    return keys64.keys64_to_words(rows[:, 0], k)


def run_mesh(batches, cards):
    from kmer_denovo_filter_tpu_torch.parallel import (
        ShardedFilteredCounter,
        ShardedKmerIndex,
        make_mesh,
        sharded_count,
        sharded_scan_reads_for_hits,
    )
    one = torch.device("cuda", 0)
    mesh = make_mesh()
    lens = np.full(BATCH_READS, READ_LEN, np.int32)
    n_reads = len(batches) * BATCH_READS

    def feed_all(fc):
        for c in batches:
            fc.feed(c, lens)
        for d in range(cards):
            torch.cuda.synchronize(d)
        return fc

    for k in (31, 63):
        flat = steps.window_keys(batches[0], lens, k, one).flatten(0, 1)
        words = _table_words(flat, k, k)
        index = eng.KmerIndex(words, k, device=one)
        for dedup in (False, True):
            want = feed_all(eng.FilteredCounter(index, dedup=dedup)).result()
            got = feed_all(ShardedFilteredCounter(words, k, mesh,
                                                  dedup=dedup)).result()
            parity(f"k={k} {cards}-card ShardedFilteredCounter "
                   f"(dedup={dedup})", np.array_equal(got, want)
                   and bool(want.any()))
        sharded = ShardedKmerIndex(words, k, mesh)
        q = (keys64.limbs_to_words(flat[:1 << 20], k) if flat.dim() == 2
             else keys64.keys64_to_words(flat[:1 << 20], k))
        parity(f"k={k} {cards}-card membership",
               np.array_equal(sharded.membership(q), index.membership(q)))
        codes, lengths = batches[1][:8192], lens[:8192]
        parity(f"k={k} {cards}-card scan", np.array_equal(
            sharded_scan_reads_for_hits(sharded, codes, lengths),
            eng.scan_reads_for_hits(index, codes, lengths)))
        sc = eng.StreamCounter(k, device=one)
        sc.feed(batches[2], lens)
        want_k, want_c = sc.result()
        got_k, got_c = sharded_count(batches[2], lens, k, mesh)
        parity(f"k={k} {cards}-card sharded_count",
               np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c))
        rates = {}
        forms = ("one card", f"{cards} cards", f"{cards} shards on one card")
        for form in forms + forms[::-1]:
            fc = (eng.FilteredCounter(index) if form == forms[0] else
                  ShardedFilteredCounter(words, k, mesh if form == forms[1]
                                         else [one] * cards))
            for d in range(cards):
                torch.cuda.synchronize(d)
            t = time.perf_counter()
            feed_all(fc)
            rates.setdefault(form, []).append(
                n_reads / (time.perf_counter() - t))
            del fc
        print(f"k={k} M={TABLE_M} plain filter reads/s, {len(batches)} "
              "batches, interleaved: " + "; ".join(
                  f"{f} {r[0]:.1f} / {r[1]:.1f}" for f, r in rates.items()),
              flush=True)


_WORKER = r"""
import os, sys
import numpy as np
import torch
from kmer_denovo_filter_tpu_torch import cli, engine as eng
from kmer_denovo_filter_tpu_torch.experiments import multi_card as mc
from kmer_denovo_filter_tpu_torch.parallel import multihost

rank, what, out = int(os.environ["KDF_PROCESS_ID"]), sys.argv[1], sys.argv[2]
if what == "vcf":
    cli.vcf_main(mc.vcf_argv(out))
elif what == "discovery":
    cli.discovery_main(mc.discovery_argv(out))
else:
    assert multihost.initialize()
    n = multihost.process_count()
    batches = mc._batches(2)
    lens = np.full(len(batches[0]), mc.READ_LEN, np.int32)
    rows = slice(rank * len(lens) // n, (rank + 1) * len(lens) // n)
    got = {}
    for k in (31, 63):
        keys, counts = multihost.sharded_count_multihost(
            batches[1][rows], lens[rows], k)
        part = multihost.sharded_count_multihost(
            batches[1][rows], lens[rows], k, per_process=True)
        sc = eng.StreamCounter(k, device=multihost.device())
        sc.feed(batches[1][rows], lens[rows])
        mk, mcount = multihost.merge_counts_sharded(*sc.result())
        got.update({f"k{k}_keys": keys, f"k{k}_counts": counts,
                    f"k{k}_part": part[0], f"k{k}_merge_keys": mk,
                    f"k{k}_merge_counts": mcount})
    np.savez(os.path.join(out, f"prims_{rank}.npz"), **got)
print(f"[{rank}] {what} done on {multihost.device()}", flush=True)
"""


def vcf_argv(out):
    return [
        "--child", os.path.join(GIAB, "HG002_child.bam"),
        "--mother", os.path.join(GIAB, "HG004_mother.bam"),
        "--father", os.path.join(GIAB, "HG003_father.bam"),
        "--vcf", os.path.join(GIAB, "candidates.vcf.gz"),
        "--output", os.path.join(out, "annotated.vcf.gz"),
        "--metrics", os.path.join(out, "metrics.json"),
        "--summary", os.path.join(out, "summary.txt"),
        "--proband-id", "HG002"]


def discovery_argv(out):
    return [
        "--child", os.path.join(GIAB, "HG002_child.bam"),
        "--mother", os.path.join(GIAB, "HG004_mother.bam"),
        "--father", os.path.join(GIAB, "HG003_father.bam"),
        "--ref-fasta", os.path.join(GIAB, "mini_ref.fa"),
        "--ref-jf", os.path.join(GIAB, "mini_ref.fa.k31.jf"),
        "--out-prefix", os.path.join(out, "giab_discovery"),
        "--min-child-count", "3", "--kmer-size", "31",
        "--candidate-summary", os.path.join(GOLD, "summary.txt")]


def _launch(what, n, out):
    """Run *what* as *n* joined processes; each must exit 0."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(n):
        env = dict(os.environ, KDF_COORDINATOR=f"127.0.0.1:{port}",
                   KDF_NUM_PROCESSES=str(n), KDF_PROCESS_ID=str(rank),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, what, out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t = time.perf_counter()
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{what} process {rank} exited "
                               f"{p.returncode}:\n{text[-4000:]}")
    return wall


def run_processes(cards):
    out = tempfile.mkdtemp(prefix="kdf_multi_card_")
    wall = _launch("prims", cards, out)
    batches = _batches(2)
    lens = np.full(BATCH_READS, READ_LEN, np.int32)
    parts = [dict(np.load(os.path.join(out, f"prims_{r}.npz")))
             for r in range(cards)]
    from kmer_denovo_filter_tpu_torch.parallel import multihost
    for k in (31, 63):
        sc = eng.StreamCounter(k, device=torch.device("cuda", 0))
        sc.feed(batches[1], lens)
        want_k, want_c = sc.result()
        parity(f"k={k} {cards}-process sharded_count_multihost", all(
            np.array_equal(p[f"k{k}_keys"], want_k)
            and np.array_equal(p[f"k{k}_counts"], want_c) for p in parts)
            and sum(p[f"k{k}_part"].shape[0] for p in parts)
            == want_k.shape[0])
        mk = np.concatenate([p[f"k{k}_merge_keys"] for p in parts])
        mc = np.concatenate([p[f"k{k}_merge_counts"] for p in parts])
        order = np.lexsort(mk.T[::-1])
        parity(f"k={k} {cards}-process merge_counts_sharded", np.array_equal(
            mk[order], want_k) and np.array_equal(mc[order], want_c) and all(
            (multihost._owner_of_keys(p[f"k{k}_merge_keys"], cards)
             == r).all() for r, p in enumerate(parts)))
    print(f"{cards} NCCL processes, the collectives: {wall:.3f} s",
          flush=True)
    wall = _launch("vcf", cards, out)
    with gzip.open(os.path.join(out, "annotated.vcf.gz")) as a, \
            gzip.open(os.path.join(GOLD, "annotated.vcf.gz")) as b:
        ok = a.read() == b.read()
    for name in ("metrics.json", "summary.txt"):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(GOLD, name), "rb") as b:
            ok = ok and a.read() == b.read()
    parity(f"kmer-denovo-torch, {cards} processes ({wall:.3f} s), the "
           "3 goldens", ok)
    wall = _launch("discovery", cards, out)
    ok = True
    for suffix in DISCOVERY_OUTPUTS:
        with open(os.path.join(out, f"giab_discovery.{suffix}"), "rb") as a, \
                open(os.path.join(GOLD, f"giab_discovery.{suffix}"),
                     "rb") as b:
            ok = ok and a.read() == b.read()
    parity(f"kmer-discovery-torch, {cards} processes ({wall:.3f} s), the "
           "6 goldens", ok)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="multi_card")
    ap.add_argument("--batches", type=int, default=16)
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count()
    if cards < 2:
        raise SystemExit("multi_card needs 2 or more CUDA devices")
    names = {torch.cuda.get_device_name(d) for d in range(cards)}
    print(f"{cards} cards: {', '.join(sorted(names))}; torch "
          f"{torch.__version__}", flush=True)
    run_mesh(_batches(max(3, args.batches)), cards)
    run_processes(cards)


if __name__ == "__main__":
    main()
