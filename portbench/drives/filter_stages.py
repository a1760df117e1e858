"""Drive: the filter scan of :mod:`portbench.drives.filter_scan`, read
stage by stage.

Set-up, window and timing are :class:`~portbench.drives.filter_scan.FilterScan`'s,
so ``scan_reads_per_s`` and ``setup_s`` mean what they mean there.  Three
things more:

* The path check (on a card): the set-up and the window must launch the
  three kernels of the cell's width (:data:`PATH`: K1, K9d, K3 weighted
  for k <= 31; K1w, K9dw, K7 weighted past it) and none of the other
  width's, read from the port's launch counters
  (``tracing.launches()``, which count always); otherwise the run raises.
* In a traced run only, the port's tracing is on over the window
  (``tracing.reset()`` and ``enable()`` just before it, ``disable()`` and
  ``collect()`` after ``result()``), and its counters
  :data:`COUNTERS` go into the run's ``work``.  Untraced runs leave it
  off, so the end-to-end metrics pay nothing for it.
* Check: :class:`~portbench.drives.filter_scan.FilterScan`'s recount
  (:func:`portbench.reference.filter_scan.expected_counts`) and its
  checks; the plain reference :mod:`portbench.reference.filter_stages`
  counts each pool batch's stages beside it.  ``work`` gets the step's
  least bytes (``least_bytes``, as ``FilterScan`` gives them) and each
  stage's (``extract_bytes``, ``dedup_bytes``, ``tally_bytes``), summed
  over the batches fed.
"""

import time

from portbench.drives import filter_scan
from portbench.reference import filter_scan as scan_reference
from portbench.reference import filter_stages as reference

TINY = filter_scan.TINY
# the port keys k <= 31 as one int64, wider k as rows of int64 limbs
NARROW_K = 31
# the kernels (tracing.KERNELS) of the extract, dedup and tally stages
PATH = {
    "narrow": ("extract_canonical", "seg_dedup", "probe_tally_weighted"),
    "wide": ("extract_canonical_wide", "seg_dedup_wide",
             "probe_tally_wide_weighted"),
}
# the port's counters a traced run reports in ``work``
COUNTERS = ("filter.windows", "filter.distinct_keys")


def check_path(launches, k, when):
    """Raise unless *launches* ({kernel: launches}) hold every kernel of
    k's width in :data:`PATH` and none of the other width's."""
    width = "narrow" if k <= NARROW_K else "wide"
    other = "wide" if width == "narrow" else "narrow"
    missing = [n for n in PATH[width] if not launches.get(n)]
    foreign = [n for n in PATH[other] if launches.get(n)]
    if missing or foreign:
        raise RuntimeError(
            f"{when} at k={k} did not run the {width} filter path: "
            f"missing {missing}, {other} kernels launched {foreign}")


def _since(before, after):
    return {name: n - before.get(name, 0) for name, n in after.items()}


def _on_card(device):
    """Whether the port's kernels run on *device* (and count launches)."""
    return device.type == "cuda"


class FilterStages(filter_scan.FilterScan):
    """One run of the filter scan on *device*, with its stages' work."""

    def __init__(self, cfg, traffic, seed, device, spans, log):
        super().__init__(cfg, traffic, seed, device, spans, log)
        self.program = {}

    def setup(self):
        from kmer_denovo_filter_tpu_torch import tracing
        before = tracing.launches()
        super().setup()
        if _on_card(self.device):
            check_path(_since(before, tracing.launches()), self.k,
                       "the set-up")

    def window(self, seconds):
        from kmer_denovo_filter_tpu_torch import tracing
        if self.spans.traced:
            tracing.reset()
            tracing.enable()
            before = tracing.launches()
            try:
                out = super().window(seconds)
            finally:
                tracing.disable()
            counters = tracing.collect()["counters"]
            self.program = {name: counters.get(name, 0)
                            for name in COUNTERS}
        else:
            before = tracing.launches()
            out = super().window(seconds)
        if _on_card(self.device):
            launched = _since(before, tracing.launches())
            self.log(f"kernels launched in the window: "
                     f"{ {n: c for n, c in launched.items() if c} }")
            check_path(launched, self.k, "the window")
        return out

    def check(self):
        """(checks, work): the table's counts against the plain
        reference's recount, the step's and each stage's least bytes over
        the batches fed and, traced, the port's counters."""
        start = time.perf_counter()
        expected, per_batch = scan_reference.expected_counts(
            self.words, self.k, self.pool, self.feeds, self.device)
        checks = scan_reference.compare(self.result, expected)
        hits = int(expected.sum())
        del expected
        if not hits:
            raise RuntimeError("no read fed hit the table: the comparison "
                               "would hold any program that counts nothing")
        stages = reference.stage_counts(self.pool, self.k, self.device)
        work = reference.fed_bytes(stages, per_batch, self.feeds, self.k)
        fed = {name: sum(t * b[name] for t, b in zip(self.feeds, stages))
               for name in ("windows", "segment_keys")}
        self.log(f"reference ({time.perf_counter() - start} s): {hits} "
                 f"windows of the fed reads hit the table; windows fed "
                 f"{fed['windows']}, distinct keys of their segments "
                 f"{fed['segment_keys']}; least bytes {work}")
        if self.program:
            self.log(f"the port's counters: {self.program}")
        work.update(self.program)
        return checks, work


def make(cfg, traffic, seed, device, spans, log):
    """The drive's run object (see :class:`FilterStages`)."""
    return FilterStages(cfg, traffic, seed, device, spans, log)
