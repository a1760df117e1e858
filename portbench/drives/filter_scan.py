"""Drive: the discovery parent filter's whole-BAM scan, minus its decode.

The entry ``_count_parent_device`` (``discovery/pipeline.py``) runs, with
its ``prefetch_batches(packed_batches(...))`` decode replaced by batches
already in host memory in the form the decoder yields them: pageable
(B, L) ``uint8`` codes and (B,) ``int32`` lengths, the table as sorted,
unique, canonical (M, W) ``uint32`` words.

* Set-up: the pool and the table are made on the device from the seed
  (:mod:`portbench.recipes`) and copied to host memory; a few batches go
  through a counter on a small table of the same k (the kernels load from
  the package's build cache); then
  ``engine.make_parent_filter_counter(words, k, device)`` builds the
  counter, timed as the span ``build``.
* Window: ``feed`` of each pool batch in turn, round-robin, until the
  window's seconds have passed (span ``feed`` each), then ``result()``
  once (span ``result``).
* Check: the plain reference (:mod:`portbench.reference.filter_scan`)
  recounts from the same pool, table and feed counts; every table row's
  count has to agree.
"""

import os
import time

import numpy as np
import torch

from portbench import kmerwords as kw
from portbench import recipes
from portbench.reference import filter_scan as reference

# a cell of this drive cut to a size the CPU tests hold: 4 batches of 128
# reads over a 1,920 bp slice, SNVs every 100 bp so the table is hit,
# 4,096 table rows (overrides of the configuration and of the traffic)
TINY = {"config": {"filter_table_keys": 4096, "pool_reads": 512},
        "traffic": {"batch_reads": 128, "het_snv_every_bp": 100}}
# rows of the warm-up table: a stride over the real one
WARM_ROWS = 1 << 16
WARM_FEEDS = 4
# the window's pace is logged over spans of this many seconds
PACE_SECONDS = 5.0


class FilterScan:
    """One run of the filter scan on *device*."""

    def __init__(self, cfg, traffic, seed, device, spans, log):
        self.cfg, self.traffic = cfg, traffic
        self.k = cfg["k"]
        self.device = torch.device(device)
        self.spans, self.log = spans, log
        self.pool = []
        self.words = None
        self.counter = None
        self.feeds = []
        self.result = None
        self._make_inputs(seed)

    def _make_inputs(self, seed):
        start = time.perf_counter()
        cfg, traffic, dev = self.cfg, self.traffic, self.device
        b = traffic["batch_reads"]
        if cfg["pool_reads"] % b:
            raise ValueError("pool_reads has to be whole batches")
        parent, child, child_sites = recipes.make_trio(cfg, traffic, seed,
                                                       dev)
        table, own = recipes.make_table(child, child_sites, self.k,
                                        cfg["filter_table_keys"], seed, dev)
        self.words = kw.to_uint32_words(table, self.k).cpu().numpy().view(
            np.uint32)
        del table, child
        codes = recipes.make_reads(parent, cfg, traffic, seed, dev)
        del parent
        codes_np = codes.cpu().numpy()
        del codes
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        length = traffic["read_length"]
        self.pool = [(codes_np[lo:lo + b],
                      np.full(b, length, dtype=np.int32))
                     for lo in range(0, codes_np.shape[0], b)]
        self.log(f"inputs: {len(self.pool)} batches of {b} x {length} bp "
                 f"({traffic['order']} order), a table of "
                 f"{self.words.shape[0]} keys at k={self.k}, {own} of them "
                 "the child's non-reference keys, made and copied to the host "
                 f"in {time.perf_counter() - start} s")

    def _check_counter(self, counter):
        """Raise unless *counter* is the single-card dedup FilteredCounter
        with its table on the run's device."""
        from kmer_denovo_filter_tpu_torch import engine
        kind = f"{type(counter).__module__}.{type(counter).__qualname__}"
        index = getattr(counter, "index", None)
        where = getattr(index, "device", None)
        self.log(f"counter: {kind}, dedup={getattr(counter, 'dedup', None)}, "
                 f"table on {where}, KDF_SHARDED="
                 f"{os.environ.get('KDF_SHARDED', 'unset')}")
        if (type(counter) is not engine.FilteredCounter or not counter.dedup
                or where != self.device):
            raise RuntimeError(
                f"the parent filter gave {kind} (table on {where}), not the "
                f"single-card dedup FilteredCounter on {self.device}")

    def setup(self):
        """Warm up on a small table of the same k, then build the counter."""
        from kmer_denovo_filter_tpu_torch import engine
        start = time.perf_counter()
        step = max(1, self.words.shape[0] // WARM_ROWS)
        warm = engine.make_parent_filter_counter(
            np.ascontiguousarray(self.words[::step]), self.k,
            device=self.device)
        for codes, lengths in self.pool[:WARM_FEEDS]:
            warm.feed(codes, lengths)
        warm.result()
        del warm
        self._sync()
        self.log(f"warm-up on a {len(range(0, self.words.shape[0], step))}-"
                 f"key table: {time.perf_counter() - start} s")
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        with self.spans.span("build"):
            self.counter = engine.make_parent_filter_counter(
                self.words, self.k, device=self.device)
            self._sync()
        self._check_counter(self.counter)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds):
        """Feed the pool round-robin for *seconds*, then ``result()``.
        ``scan_reads_per_s`` is every read fed over the whole window,
        first ``feed`` to ``result()`` returned; ``attempted`` counts the
        batches fed."""
        counter, pool, span = self.counter, self.pool, self.spans.span
        n_pool = len(pool)
        fed = 0
        marks, mark = [], PACE_SECONDS
        start = time.perf_counter()
        with span("window"):
            while True:
                codes, lengths = pool[fed % n_pool]
                with span("feed"):
                    counter.feed(codes, lengths)
                fed += 1
                elapsed = time.perf_counter() - start
                if elapsed >= mark:
                    marks.append(fed)
                    mark += PACE_SECONDS
                if elapsed >= seconds:
                    break
            with span("result"):
                self.result = counter.result()
                self._sync()
        wall = time.perf_counter() - start
        paces = [b - a for a, b in zip([0] + marks, marks)]
        self.log(f"batches fed in each {PACE_SECONDS} s of the window: "
                 f"{paces}")
        self._fed(fed)
        reads = sum(pool[i][0].shape[0] * t for i, t in enumerate(self.feeds))
        return {"attempted": fed, "failed": 0,
                "metrics": {"scan_reads_per_s": reads / wall}}

    def release(self):
        """Free the program's state on the device."""
        self.counter = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """(checks {name: (value, limit)}, work {name: number}) from the
        plain reference's recount."""
        expected, per_batch = reference.expected_counts(
            self.words, self.k, self.pool, self.feeds, self.device)
        checks = reference.compare(self.result, expected)
        hits = int(expected.sum())
        del expected
        if not hits:
            raise RuntimeError("no read fed hit the table: the comparison "
                               "would hold any program that counts nothing")
        least = sum(times * (codes.nbytes + lengths.nbytes + 32 * distinct
                             + 16 * rows)
                    for (codes, lengths), times, (distinct, rows)
                    in zip(self.pool, self.feeds, per_batch))
        self.log(f"reference: {hits} windows of the fed reads hit the table; "
                 f"distinct keys a pool batch {min(d for d, _ in per_batch)}"
                 f"..{max(d for d, _ in per_batch)}, table rows hit a pool "
                 f"batch {min(r for _, r in per_batch)}.."
                 f"{max(r for _, r in per_batch)}")
        return checks, {"least_bytes": least}

    def _fed(self, fed):
        """Record how many times *fed* batches, round-robin from the
        first, fed each pool batch."""
        n_pool = len(self.pool)
        self.feeds = [fed // n_pool + (i < fed % n_pool)
                      for i in range(n_pool)]

    def control(self, fed):
        """The checks of the control: the plain reference with the
        canonical form dropped (each window counted under its forward
        string), in the program's place for *fed* batches fed
        round-robin."""
        self._fed(fed)
        got, _ = reference.expected_counts(self.words, self.k, self.pool,
                                           self.feeds, self.device,
                                           canonical=False)
        self.result = got.cpu().numpy()
        del got
        return self.check()[0]


def make(cfg, traffic, seed, device, spans, log):
    """The drive's run object (see :class:`FilterScan`)."""
    return FilterScan(cfg, traffic, seed, device, spans, log)
