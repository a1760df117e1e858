"""The program's spans over a traced window (:mod:`portbench.program_spans`):
on the benchmark's spans alone its summary is the trace's; nested spans
name a gap by the innermost; each span's share of the idle time; the
readings of the program's spans and counters."""

import pytest

from portbench import program_spans as ps
from portbench import trace as tr

HTOD = "Memcpy HtoD (Pageable -> Device)"
DEVICE = [(tr.COPY, HTOD, 10.0, 30.0),
          (tr.KERNEL, "k1", 30.0, 35.0), (tr.KERNEL, "k2", 33.0, 40.0),
          (tr.COPY, HTOD, 60.0, 70.0),
          (tr.FILL, "Memset (Device)", 70.0, 72.0),
          (tr.COPY, "Memcpy DtoH (Device -> Pageable)", 95.0, 99.0),
          (tr.KERNEL, "late", 120.0, 130.0)]
BENCH = [("window", 0.0, 100.0), ("feed", 0.0, 40.0), ("feed", 50.0, 80.0),
         ("result", 90.0, 100.0)]


def test_the_benchmarks_spans_alone_read_as_before():
    before = tr.summarize(DEVICE, BENCH)
    got = ps.summarize(DEVICE, BENCH)
    assert {k: got[k] for k in before} == before
    assert got["idle_s"] == pytest.approx(54e-6)
    assert got["idle_in"]["feed"] == pytest.approx(28 / 54 * 100)
    assert got["kernels"] == {"k1": pytest.approx(5e-6),
                              "k2": pytest.approx(7e-6)}
    assert ps.summarize(DEVICE, [("feed", 0.0, 1.0)]) is None


def test_a_nested_gap_takes_the_innermost_name():
    """The program's spans inside the benchmark's ``feed``: a gap is named
    by the innermost span open where it starts, a closed child's parent
    once the child has ended; each span's share of the idle time is the
    part of it inside that span."""
    program = [("filter.feed", 1.0, 39.0), ("filter.feed.htod", 1.0, 20.0),
               ("filter.feed.extract", 20.0, 21.0),
               ("filter.feed.dedup", 21.0, 22.0),
               ("filter.feed.tally", 22.0, 23.0),
               ("filter.feed", 51.0, 79.0), ("filter.feed.htod", 51.0, 70.0)]
    device = [(tr.COPY, HTOD, 10.0, 20.0), (tr.KERNEL, "k", 21.0, 30.0),
              (tr.COPY, HTOD, 60.0, 70.0), (tr.KERNEL, "k", 71.0, 75.0),
              (tr.COPY, "Memcpy DtoH (Device -> Pageable)", 95.0, 99.0)]
    got = ps.summarize(device, BENCH + program)
    assert [(n, round(v * 1e6)) for n, v in got["idle_gaps"]] == [
        ("filter.feed", 30), ("filter.feed", 20), ("feed", 10),
        ("filter.feed.extract", 1), ("filter.feed", 1), ("result", 1)]
    # idle 0..10, 20..21, 30..60, 70..71, 75..95, 99..100: 63 µs
    assert got["idle_s"] == pytest.approx(63e-6)
    assert got["idle_in"]["filter.feed.htod"] == pytest.approx(18 / 63 * 100)
    assert got["idle_in"]["filter.feed"] == pytest.approx(33 / 63 * 100)
    assert got["idle_in"]["feed"] == pytest.approx(37 / 63 * 100)
    assert got["idle_in"]["filter.feed.dedup"] == 0.0
    plain = ps.summarize(device, BENCH)
    assert [n for n, _ in plain["idle_gaps"]] == [
        "feed", "feed", "feed", "feed", "feed", "result"]
    assert plain["idle_gaps"] == tr.summarize(device, BENCH)["idle_gaps"]


def test_innermost_and_overlap():
    spans = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 70, "d")]
    assert ps._innermost([5, 25, 35, 55, 65, 150], spans) == [
        "a", "c", "b", "a", "d", None]
    assert ps._overlap([(0, 10), (25, 65)], [(5, 30), (28, 40), (60, 90)]) \
        == pytest.approx(5 + 15 + 5)


def test_readings():
    setup = {"records": [
        {"name": "index.upload", "start_ns": 0, "end_ns": 2_000_000},
        {"name": "index.upload", "start_ns": 5_000_000,
         "end_ns": 155_000_000}]}
    window = {"spans": {"filter.feed": {"count": 4, "total_s": 0.004},
                        "filter.feed.htod": {"count": 4, "total_s": 0.003},
                        "filter.feed.extract": {"count": 4, "total_s": 1e-4},
                        "filter.feed.dedup": {"count": 4, "total_s": 1e-4},
                        "filter.feed.tally": {"count": 4, "total_s": 2e-4}},
              "counters": {"filter.windows": 1000,
                           "filter.distinct_keys": 990}}
    got = ps.readings(setup, window, {"idle_in": {"filter.feed.htod": 61.5}})
    assert got == {"htod_host_ms": pytest.approx(0.75),
                   "launch_host_ms": pytest.approx(0.1),
                   "idle_in_htod_share": 61.5,
                   "dedup_keep_share": pytest.approx(99.0),
                   "build_upload_ms": pytest.approx(150.0)}
    assert set(ps.readings(None, None, None).values()) == {None}
    summary = {"kernel_s": 2.0, "kernels": {
        "void at::native::reduce_kernel<512, 1>": 0.01, "seg_dedup": 1.99}}
    assert ps.counter_kernel_share(summary) == pytest.approx(0.5)
