"""The per-stage filter drive (``drives/filter_stages.py``) and its plain
reference: each stage's counts and least bytes against a hand count, the
reference's segments against the port's own dedup counters, the path
check, the stage readers, and the planted faults in its cells."""

import numpy as np
import pytest
import torch

from portbench import kmerwords as kw
from portbench import spec
from portbench import trace as tr
from portbench.reference import filter_scan as scan_reference
from portbench.reference import filter_stages as reference
from portbench.tests.conftest import CELLS, SEED, drive_of, run_tiny, tiny_cell
from portbench.tests.test_portbench_filter import (
    _altered_result,
    _half_feed,
    _no_feed,
)

STAGE_CELLS = [c for c in CELLS if drive_of(c) == "filter_stages"]
READERS = ("extract_roofline.stages", "dedup_roofline.stages",
           "tally_roofline.stages", "dedup_keep_share.stages")
COMPLEMENT = str.maketrans("ACGT", "TGCA")


def _codes(s):
    return ["ACGT".index(b) for b in s]


def _hand_batch(k):
    """Three reads of L = k + 9 codes (10 window slots each): read 0 a
    fixed random string, read 1 the same string, read 2 its reverse
    complement cut to k + 4 bases (5 valid windows, the canonical keys of
    read 0's windows 9..5).  A table of read 0's windows 0..2 and of 5
    strings no read holds."""
    rng = np.random.default_rng(k)
    read0 = "".join(rng.choice(list("ACGT"), k + 9))
    rc = read0.translate(COMPLEMENT)[::-1]
    codes = torch.tensor([_codes(read0), _codes(read0), _codes(rc)],
                         dtype=torch.uint8)
    lengths = torch.tensor([k + 9, k + 9, k + 4], dtype=torch.int32)
    windows = [read0[s:s + k] for s in range(10)]
    canon = [min(w, w.translate(COMPLEMENT)[::-1]) for w in windows]
    assert len(set(canon)) == 10  # the hand count below assumes it
    others = ["".join(rng.choice(list("ACGT"), k)) for _ in range(5)]
    others = [min(w, w.translate(COMPLEMENT)[::-1]) for w in others]
    table_keys = kw.window_keys(
        torch.tensor([_codes(s) for s in canon[:3] + others],
                     dtype=torch.uint8),
        torch.full((8,), k), k)[0][:, 0]
    table_keys = kw.unique_counts(table_keys)[0]
    words = kw.to_uint32_words(table_keys, k).numpy().view(np.uint32)
    return codes, lengths, words


@pytest.mark.parametrize("k", [31, 63])
@pytest.mark.parametrize("segment", [reference.SEGMENT, 16])
def test_hand_counted_batch(k, segment):
    """30 window slots, 25 valid windows, 10 distinct keys.  One segment
    of 8,192 holds all 30 slots: 10 distinct keys.  Segments of 16 cut
    them at slot 16: slots 0..15 (read 0, read 1's windows 0..5) hold 10
    distinct keys; slots 16..29 (read 1's windows 6..9, read 2's valid
    windows = read 0's 9..5) hold 5."""
    codes, lengths, words = _hand_batch(k)
    table = scan_reference.Table(words, k, torch.device("cpu"))
    rows, counts, distinct = scan_reference.batch_tally(table, codes,
                                                        lengths)
    work = reference.batch_stages(codes, lengths, k, segment)
    segments, segment_keys = (1, 10) if segment > 30 else (2, 15)
    assert work == {"slots": 30, "windows": 25, "segments": segments,
                    "segment_keys": segment_keys,
                    "code_bytes": 3 * (k + 9) + 3 * 4}
    # read 0's windows 0..2 are in the table, twice each (reads 0 and 1)
    assert (distinct, rows.shape[0]) == (10, 3)
    assert sorted(counts.tolist()) == [2, 2, 2]
    key = 8 * (1 if k == 31 else 2)
    assert reference.stage_bytes(work, 3, k) == {
        "extract_bytes": 3 * (k + 9) + 12 + key * 30,
        "dedup_bytes": key * 30 + (key + 8) * segment_keys + 4 * segments,
        "tally_bytes": (key + 8 + 32) * segment_keys + 16 * 3}
    fed = reference.fed_bytes([work, work], [(10, 3), (10, 3)], [2, 0], k)
    assert fed == dict({name: 2 * n for name, n
                        in reference.stage_bytes(work, 3, k).items()},
                       least_bytes=2 * (3 * (k + 9) + 12 + 32 * 10 + 16 * 3))


def _cpu_run(name, traced=True, seconds=0.2):
    """A tiny run of the cell *name* on the CPU; *traced*, with the port's
    tracing on over the window, as a traced run on a card has it; (run,
    checks, work)."""
    _, _, cfg, traffic = tiny_cell(name)
    run = spec.drive(traffic["drive"]).make(
        cfg, traffic, SEED, torch.device("cpu"), tr.Spans(traced=traced),
        lambda msg: None)
    run.setup()
    run.window(seconds)
    run.release()
    checks, work = run.check()
    return run, checks, work


@pytest.mark.parametrize("name", STAGE_CELLS)
def test_reference_segments_are_the_ports(name):
    """The port's own counters over a traced window agree with the
    reference's counts: every valid window fed, and the distinct keys of
    each 8,192-window segment (the port's dedup, exact on the CPU)."""
    from kmer_denovo_filter_tpu_torch import tracing
    run, checks, work = _cpu_run(name)
    assert not tracing.enabled()
    assert all(value <= limit for value, limit in checks.values())
    _, per_batch = scan_reference.expected_counts(run.words, run.k, run.pool,
                                                  run.feeds, run.device)
    stages = reference.stage_counts(run.pool, run.k, run.device)
    fed = lambda key: sum(t * b[key]  # noqa: E731
                          for t, b in zip(run.feeds, stages))
    assert work["filter.windows"] == fed("windows") > 0
    assert work["filter.distinct_keys"] == fed("segment_keys") > 0
    assert work == dict(reference.fed_bytes(stages, per_batch, run.feeds,
                                            run.k),
                        **{"filter.windows": fed("windows"),
                           "filter.distinct_keys": fed("segment_keys")})


@pytest.mark.parametrize("name", STAGE_CELLS)
def test_work_feeds_every_reader(name):
    """What a traced run puts in its spans and ``work`` is what the
    cell's readers read, the whole step's among them: with a trace
    summary that holds the cell's kernels, every metric the cell lists
    reads a number; the step's least bytes are ``FilterScan``'s; an
    untraced run's ``work`` has no counters."""
    from portbench.drives import filter_scan
    bench = spec.load_benchmark()
    listed = {m["name"] for m in spec.cell_metrics(bench, name, "per_layer")}
    assert set(READERS) <= listed
    run, _, work = _cpu_run(name)
    kernels = (["extract_wide_kernel<3>", "seg_dedup_wide_kernel<3>",
                "probe_tally_wide_slots_kernel<3>"] if run.k > 31 else
               ["extract_canonical_kernel<5>", "seg_dedup_kernel",
                "probe_tally_weighted_slots<256>"])
    state = {"spans": run.spans.seconds, "work": work,
             "peaks": {"hbm_bytes_per_s": 3.35e12},
             "trace": {"window_s": 1.0, "busy_s": 0.5, "htod_s": 0.2,
                       "kernel_s": 3e-3,
                       "device_ops": [[f"void ns::{n}(long*)", 1e-3]
                                      for n in kernels]}}
    for m in listed:
        value = spec.metric_reader(m).read(state)
        assert value is not None, m
        if m in READERS:
            assert 0 < value <= 100, m
    keep = spec.metric_reader("dedup_keep_share.stages").read(state)
    assert keep == pytest.approx(work["filter.distinct_keys"]
                                 / work["filter.windows"] * 100)
    assert work["least_bytes"] == filter_scan.FilterScan.check(run)[1][
        "least_bytes"] > 0
    _, _, untraced = _cpu_run(name, traced=False)
    assert set(untraced) == set(work) - {"filter.windows",
                                         "filter.distinct_keys"}


@pytest.mark.parametrize("reader", READERS[:3])
def test_stage_reader_reads_only_its_kernels(reader):
    """A roofline reader sums its own stage's kernels, both widths, and
    reads None where none of them ran, whatever else did."""
    module = spec.metric_reader(reader)
    stage = reader.split("_roofline")[0]
    state = {"work": {f"{stage}_bytes": 3.35e9},
             "peaks": {"hbm_bytes_per_s": 3.35e12},
             "trace": {"device_ops": [["Memcpy HtoD (Pinned -> Device)", 1.0],
                                      ["void at::native::reduce_kernel", 1.0]]}}
    assert module.read(state) is None
    state["trace"]["device_ops"] += [[f"void ns::{n}<2>(long*)", 5e-3]
                                     for n in module.KERNELS]
    assert module.read(state) == pytest.approx(
        100 / (5 * len(module.KERNELS)))


@pytest.mark.parametrize("k", [31, 63])
def test_path_check(k):
    from portbench.drives import filter_stages as drive
    own = "narrow" if k == 31 else "wide"
    other = "wide" if k == 31 else "narrow"
    launches = {n: 3 for n in drive.PATH[own]}
    drive.check_path(dict(launches, words_to_keys=1), k, "test")
    with pytest.raises(RuntimeError, match="launched"):
        drive.check_path(dict(launches, **{drive.PATH[other][1]: 1}), k,
                         "test")
    for name in drive.PATH[own]:
        with pytest.raises(RuntimeError, match="missing"):
            drive.check_path(dict(launches, **{name: 0}), k, "test")


@pytest.mark.parametrize("name", STAGE_CELLS)
def test_other_widths_kernels_raise(name, monkeypatch):
    """A run whose launch counters show the other width's kernels raises
    in its set-up, as a counter of the wrong width would on a card."""
    from kmer_denovo_filter_tpu_torch import tracing
    _, _, cfg, traffic = tiny_cell(name)
    drive = spec.drive(traffic["drive"])
    other = drive.PATH["wide" if cfg["k"] <= 31 else "narrow"]
    calls = []

    def launches():
        calls.append(1)
        return {n: len(calls) for n in other}

    monkeypatch.setattr(drive, "_on_card", lambda device: True)
    monkeypatch.setattr(tracing, "launches", launches)
    run = drive.make(cfg, traffic, SEED, torch.device("cpu"), tr.Spans(),
                     lambda msg: None)
    with pytest.raises(RuntimeError, match="did not run the"):
        run.setup()


@pytest.mark.parametrize("name", STAGE_CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_planted_faults_are_not_correct(fault, name, monkeypatch):
    from kmer_denovo_filter_tpu_torch import engine
    feed, result = engine.FilteredCounter.feed, engine.FilteredCounter.result
    if fault == "state_unchanged":
        monkeypatch.setattr(engine.FilteredCounter, "feed", _no_feed)
    elif fault == "half_batch":
        monkeypatch.setattr(engine.FilteredCounter, "feed",
                            lambda s, c, l: _half_feed(s, c, l, feed))
    else:
        monkeypatch.setattr(engine.FilteredCounter, "result",
                            lambda s: _altered_result(s, result))
    out = run_tiny(name)
    assert out["correct"] is False
    assert out["checks"]["rows_differing"]["value"] > 0
