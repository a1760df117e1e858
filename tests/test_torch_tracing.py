"""The port's tracing registry (:mod:`kmer_denovo_filter_tpu_torch.tracing`):
off it records nothing and enters no ``record_function``; on, the
engine's spans nest by layer and share their ``filter.feed`` call's
batch id, the filter's counters are exact, the launch counters count as
the ops modules' globals did, and a span lies on the profiler's clock."""

import ast
import json
import os
import re
import threading

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch import tracing
from kmer_denovo_filter_tpu_torch.kmer import canonicalize
from kmer_denovo_filter_tpu_torch.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops.segsort import SEGMENT
from kmer_denovo_filter_tpu_torch.utils import prefetch_batches

CPU = torch.device("cpu")
K = 31
PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "kmer_denovo_filter_tpu_torch")
# the kernel names of chip_smoke.py's kernels line, as the ops modules'
# launch globals had them
KERNELS = ["extract_canonical", "probe_tally", "probe_tally_weighted",
           "probe_member", "build_directory", "extract_canonical_wide",
           "probe_tally_wide", "probe_tally_wide_weighted",
           "probe_member_wide", "seg_sort", "seg_dedup", "seg_dedup_wide",
           "route", "words_to_keys", "sort_count",
           "extract_canonical_stage"]
FEED_CHILDREN = ["filter.feed.htod", "filter.feed.extract",
                 "filter.feed.dedup", "filter.feed.tally"]


@pytest.fixture(autouse=True)
def _tracing_off(monkeypatch):
    """Each test starts and ends with tracing off and nothing recorded;
    tables stay on the CPU device (no host-resident table)."""
    monkeypatch.delenv("KDF_DEVICE_TABLE_BYTES", raising=False)
    monkeypatch.delenv("KDF_SHARDED", raising=False)
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _batches(seed, sizes, length=150):
    """Host (codes, lengths) batches of *sizes* reads; every third read
    repeats the one before it (so a segment holds repeats), some reads are
    shorter than k or empty, and some windows hold an N."""
    rng = np.random.default_rng(seed)
    out = []
    for b in sizes:
        codes = rng.integers(0, 4, (b, length), dtype=np.uint8)
        codes[2::3] = codes[1::3][:len(codes[2::3])]
        codes[rng.random((b, length)) < 0.002] = 4
        lengths = np.full(b, length, dtype=np.int32)
        lengths[::7] = rng.integers(0, length + 1, len(lengths[::7]))
        lengths[5::11] = K - 1
        out.append((codes, lengths))
    return out


def _window_strings(codes, lengths):
    """The flat window stream of a batch, row by row as K1 lays it out:
    each window's canonical k-mer, or None (past the read, or an N)."""
    out = []
    for row, n in zip(codes, lengths):
        read = "".join("ACGTN"[c] for c in row)
        for s in range(codes.shape[1] - K + 1):
            kmer = read[s:s + K]
            out.append(canonicalize(kmer)
                       if s + K <= n and "N" not in kmer else None)
    return out


def _table(batches, every=5):
    """Sorted unique (M, W) words of every *every*-th valid window key."""
    keys = sorted({w for c, l in batches
                   for w in _window_strings(c, l)[::every] if w})
    return enc.unique_with_counts(enc.kmers_to_keys(keys, K))[0]


def _by_name(records, name):
    return sorted((r for r in records if r["name"] == name),
                  key=lambda r: r["start_ns"])


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    batches = _batches(1, [40, 40])
    fc = eng.make_parent_filter_counter(_table(batches), K, device=CPU)
    for codes, lengths in prefetch_batches(iter(batches)):
        fc.feed(codes, lengths)
    fc.result()
    sc = eng.StreamCounter(K, device=CPU)
    sc.feed(*batches[0])
    sc.result()
    eng.scan_reads_for_hits_many(fc.index, batches)
    # one shared null context, whatever the name
    assert tracing.span("filter.feed") is tracing.span("index.build")
    got = tracing.collect()
    assert got["spans"] == {} and got["records"] == []
    assert got["dropped"] == 0
    assert all(name.startswith("launches.") for name in got["counters"])


def test_feed_spans_nest_and_share_their_batch_id(monkeypatch):
    """On, with no profiler running: the spans are recorded and, with no
    timeline to land on, enter no ``record_function``."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    batches = _batches(2, [30, 50, 20])
    words = _table(batches)
    tracing.enable()
    fc = eng.make_parent_filter_counter(words, K, device=CPU)
    for codes, lengths in batches:
        fc.feed(codes, lengths)
    fc.result()
    got = tracing.collect()
    records = got["records"]
    feeds = _by_name(records, "filter.feed")
    assert [(r["batch"], r["parent"]) for r in feeds] == [
        (0, None), (1, None), (2, None)]
    for feed in feeds:
        children = sorted((r for r in records
                           if r["parent"] == "filter.feed"
                           and r["batch"] == feed["batch"]),
                          key=lambda r: r["start_ns"])
        assert [r["name"] for r in children] == FEED_CHILDREN
        for child in children:
            assert feed["start_ns"] <= child["start_ns"]
            assert child["end_ns"] <= feed["end_ns"]
            assert child["thread"] == feed["thread"]
    build = _by_name(records, "index.build")
    assert [(r["batch"], r["parent"]) for r in build] == [(0, None)]
    # the CPU keeps its numpy conversion: no upload, no directory
    assert [(r["name"], r["parent"]) for r in records
            if r["parent"] == "index.build"] == [
        ("index.convert", "index.build")]
    assert [r["parent"] for r in _by_name(records, "filter.result")] == [
        None]
    for name, agg in got["spans"].items():
        took = [(r["end_ns"] - r["start_ns"]) / 1e9
                for r in _by_name(records, name)]
        assert agg["count"] == len(took)
        assert agg["total_s"] == pytest.approx(sum(took))
        assert agg["max_s"] == pytest.approx(max(took))
    json.dumps(got)  # plain data


def test_the_filter_counters_are_exact():
    # 70 and 60 reads of 120 windows: two segments each, with repeats
    batches = _batches(3, [70, 60, 3])
    batches.append((np.zeros((4, K - 2), np.uint8),
                    np.full(4, K - 2, np.int32)))  # narrower than k
    words = _table(batches)
    tracing.enable()
    fc = eng.make_parent_filter_counter(words, K, device=CPU)
    for codes, lengths in batches:
        fc.feed(codes, lengths)
    counters = tracing.collect()["counters"]
    windows = sum(int(np.maximum(l.astype(np.int64) - K + 1, 0).sum())
                  for _, l in batches)
    distinct = 0
    for codes, lengths in batches[:-1]:
        stream = _window_strings(codes, lengths)
        for lo in range(0, len(stream), SEGMENT):
            distinct += len({w for w in stream[lo:lo + SEGMENT] if w})
    longest = max(len(_window_strings(c, l)) for c, l in batches[:-1])
    assert longest > SEGMENT and distinct < windows
    assert counters["filter.batches"] == len(batches)
    assert counters["filter.reads"] == sum(c.shape[0] for c, _ in batches)
    assert counters["filter.windows"] == windows
    assert counters["filter.distinct_keys"] == distinct
    assert counters["filter.bytes_up"] == sum(
        c.size + 4 * l.size for c, l in batches[:-1])
    assert not any(name.startswith("launches.") for name in counters)


def test_the_launch_counters_count_as_before():
    """Sixteen counters under chip_smoke.py's names, always on: the ops
    modules keep none of their own, the CPU's plain paths launch
    nothing, and :func:`tracing.reset` zeroes them, as chip_smoke.py's
    ``reset_counts`` did the globals."""
    from kmer_denovo_filter_tpu_torch import ops
    assert list(tracing.KERNELS) == KERNELS
    assert tracing.launches() == {k: 0 for k in KERNELS}
    ops_dir = os.path.dirname(ops.__file__)
    for name in sorted(os.listdir(ops_dir)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ops_dir, name)) as fh:
            tree = ast.parse(fh.read())
        globals_ = {t.id for node in tree.body if isinstance(node, ast.Assign)
                    for t in node.targets if isinstance(t, ast.Name)}
        assert not {g for g in globals_ if g.endswith("launches")}, name
    batches = _batches(4, [20])
    fc = eng.make_parent_filter_counter(_table(batches), K, device=CPU)
    fc.feed(*batches[0])
    assert tracing.launches() == {k: 0 for k in KERNELS}
    tracing.count("launches.seg_dedup")  # tracing off: counts all the same
    tracing.count("launches.seg_dedup", 2)
    assert tracing.launches()["seg_dedup"] == 3
    assert tracing.counter("launches.seg_dedup") == 3
    tracing.reset()
    assert tracing.launches()["seg_dedup"] == 0


def test_stream_scan_and_prefetch_spans():
    batches = _batches(5, [30, 30])
    words = _table(batches)
    tracing.enable()
    sc = eng.StreamCounter(K, device=CPU)
    for codes, lengths in prefetch_batches(iter(batches)):
        sc.feed(codes, lengths)
    sc.result()
    index = eng.KmerIndex(words, K, device=CPU)
    eng.scan_reads_for_hits_many(index, batches)
    got = tracing.collect()
    records = got["records"]
    names = {r["name"] for r in records}
    assert {"count.sort", "count.dtoh", "count.consolidate",
            "count.result.words", "scan.stage", "scan.member",
            "scan.mask_back", "prefetch.wait", "prefetch.decode"} <= names
    assert got["counters"]["count.merges"] == 1
    decode = _by_name(records, "prefetch.decode")
    wait = _by_name(records, "prefetch.wait")
    # the producer's thread: its own stack, its own ordinals
    assert len(decode) == 3 and len(wait) == 3
    assert {r["thread"] for r in decode} == {"kdf-prefetch"}
    assert {r["thread"] for r in wait} == {threading.current_thread().name}
    assert [r["batch"] for r in decode] == [0, 1, 2]
    assert all(r["parent"] is None for r in decode + wait)


def test_every_span_and_counter_is_listed_and_every_listed_one_used():
    opened, counted = set(), set()
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    text = fh.read()
                opened.update(re.findall(r'tracing\.span\("([^"]+)"', text))
                counted.update(re.findall(
                    r'tracing\.count(?:_on_device)?\(\s*"([^"]+)"', text))
    assert opened == set(tracing.SPANS)
    assert counted == set(tracing.COUNTERS)
    assert {f"launches.{k}" for k in KERNELS} <= counted
    tracing.enable()
    with pytest.raises(KeyError):
        tracing.span("filter.feed.unlisted")


def test_records_stop_at_the_cap_and_aggregates_go_on(monkeypatch):
    monkeypatch.setattr(tracing, "RECORDS", 3)
    tracing.enable()
    for _ in range(5):
        with tracing.span("prefetch.wait"):
            pass
    got = tracing.collect()
    assert len(got["records"]) == 3 and got["dropped"] == 2
    assert got["spans"]["prefetch.wait"]["count"] == 5


def test_spans_lie_on_the_profilers_clock():
    """Each in-memory span starts within 200 µs of its annotation on a
    CPU-only ``torch.profiler`` timeline: both in Unix nanoseconds."""
    from torch.profiler import ProfilerActivity, profile
    batches = _batches(6, [30, 30, 30])
    fc = eng.make_parent_filter_counter(_table(batches), K, device=CPU)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]):
        fc.feed(*batches[0])  # the annotations' first call sets them up
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.reset()
        for codes, lengths in batches[1:]:
            fc.feed(codes, lengths)
    records = tracing.collect()["records"]
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in tracing.SPANS:
            events.setdefault(e.name(), []).append(e.start_ns())
    assert set(events) == set(FEED_CHILDREN) | {"filter.feed"}
    for name, starts in events.items():
        mine = [r["start_ns"] for r in _by_name(records, name)]
        assert len(mine) == len(starts) == 2
        for a, b in zip(mine, sorted(starts)):
            assert abs(a - b) < 200_000, (name, a - b)
