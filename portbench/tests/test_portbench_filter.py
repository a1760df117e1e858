"""Every cell at its drive's tiny size on the CPU device, against its
plain reference: sound runs agree, the control and the planted faults do
not; the filter drive's inputs and the trace's reading."""

import itertools
import random

import numpy as np
import pytest
import torch

from portbench import kmerwords as kw
from portbench import recipes
from portbench import trace as tr
from portbench.control import control_of
from portbench import spec
from portbench.tests.conftest import CELLS, SEED, drive_of, run_tiny, tiny_cell

COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}
FILTER_CELLS = [c for c in CELLS if drive_of(c) == "filter_scan"]


def _strings(codes, lengths, k, canonical=True):
    """Each valid window's key as a base string, by plain Python."""
    out = []
    for row, n in zip(codes.tolist(), lengths.tolist()):
        read = "".join("ACGTN"[min(c, 4)] for c in row[:n])
        for s in range(len(read) - k + 1):
            kmer = read[s:s + k]
            if "N" in kmer:
                continue
            rc = "".join(COMPLEMENT[b] for b in reversed(kmer))
            out.append(min(kmer, rc) if canonical else kmer)
    return out


def _decode(cols, k):
    """Packed columns back to base strings."""
    words = kw.unpack(cols, kw.words_per_kmer(k)).tolist()
    out = []
    for row in words:
        bits = "".join(f"{w:032b}" for w in row)
        out.append("".join("ACGT"[int(bits[2 * i:2 * i + 2], 2)]
                           for i in range(k)))
    return out


@pytest.mark.parametrize("k", [3, 17, 31, 33, 63, 65])
def test_window_keys_are_the_canonical_strings(k):
    gen = torch.Generator().manual_seed(k)
    codes = torch.randint(0, 4, (5, 90), generator=gen, dtype=torch.uint8)
    codes[1, 20] = 4  # an N
    lengths = torch.tensor([90, 90, 40, k - 1, 77])
    for canonical in (True, False):
        keys, valid = kw.window_keys(codes, lengths, k, canonical)
        got = _decode(keys[valid], k)
        assert got == _strings(codes, lengths, k, canonical)
    # column order is string order
    strings = _decode(keys[valid], k)
    order = kw.lexsort(keys[valid]).tolist()
    assert [strings[i] for i in order] == sorted(strings)


def test_pack_round_trips_and_orders():
    rng = random.Random(5)
    for w in (1, 2, 3, 4, 13):
        words = torch.tensor([[rng.randrange(1 << 32) for _ in range(w)]
                              for _ in range(200)])
        cols = kw.pack(words)
        assert torch.equal(kw.unpack(cols, w), words)
        for a, b in itertools.combinations(range(20), 2):
            assert bool(kw.less(cols[a], cols[b])) == (
                words[a].tolist() < words[b].tolist())
        i32 = kw.to_uint32_words(cols, 16 * w - 1)
        assert np.array_equal(i32.numpy().view(np.uint32), words.numpy())


def test_drive_agrees_with_the_plain_reference(cell_name):
    out = run_tiny(cell_name)
    assert out["correct"] is True
    assert out["checks"] and all(c["value"] <= c["limit"]
                                 for c in out["checks"].values())
    assert out["attempted"] >= 1 and out["failed"] == 0
    bench = spec.load_benchmark()
    assert set(out["metrics"]) == {
        m["name"] for m in spec.cell_metrics(bench, cell_name, "end_to_end")}
    assert list(out)[-1] == "checks"


def test_control_is_not_correct(cell_name):
    _, _, cfg, traffic = tiny_cell(cell_name)
    checks = control_of(cfg, traffic, SEED, 9, torch.device("cpu"))
    assert any(value > limit for value, limit in checks.values())


@pytest.mark.parametrize("name", FILTER_CELLS)
def test_inputs_follow_the_seed(name):
    _, _, cfg, traffic = tiny_cell(name)
    dev = torch.device("cpu")

    def inputs(seed):
        parent, child, sites = recipes.make_trio(cfg, traffic, seed, dev)
        table, own = recipes.make_table(child, sites, cfg["k"],
                                        cfg["filter_table_keys"], seed, dev)
        return recipes.make_reads(parent, cfg, traffic, seed, dev), table, own

    a, b, c = inputs(SEED), inputs(SEED), inputs(SEED + 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    table, own = a[1], a[2]
    assert table.shape[0] == cfg["filter_table_keys"]
    assert 0 < own < cfg["filter_table_keys"]
    # sorted, unique and canonical
    assert not kw.less(table[1:], table[:-1]).any()
    assert (table[1:] != table[:-1]).any(1).all()
    strings = _decode(table[:300], cfg["k"])
    assert all(s <= "".join(COMPLEMENT[b] for b in reversed(s))
               for s in strings)


@pytest.mark.parametrize("name", FILTER_CELLS)
def test_shuffled_mix_holds_the_same_reads(name):
    """The shuffled order holds the coordinate order's reads, batch j
    those at j, j + n / B, ... of it (a thin stride over the slice), in
    another order."""
    _, _, cfg, traffic = tiny_cell(name)
    dev = torch.device("cpu")
    parent = recipes.make_trio(cfg, traffic, SEED, dev)[0]
    a = recipes.make_reads(parent, cfg, dict(traffic, order="coordinate"),
                           SEED, dev)
    b = recipes.make_reads(parent, cfg, dict(traffic, order="shuffled"),
                           SEED, dev)
    step = traffic["batch_reads"]
    n_batches = a.shape[0] // step
    rows = lambda t: sorted(map(bytes, t.numpy()))  # noqa: E731
    for j in range(n_batches):
        got = b[j * step:(j + 1) * step]
        assert rows(got) == rows(a[j::n_batches])
        assert not torch.equal(got, a[j::n_batches])


def _no_feed(self, codes, lengths):
    return None


def _half_feed(self, codes, lengths, feed=None):
    half = codes.shape[0] // 2
    return feed(self, codes[:half], lengths[:half])


def _altered_result(self, result=None):
    out = result(self)
    out[int(np.argmax(out))] += 1
    return out


@pytest.mark.parametrize("name", FILTER_CELLS)
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


def test_trace_summary_arithmetic():
    host = [("window", 0.0, 100.0), ("feed", 0.0, 40.0), ("feed", 50.0, 80.0),
            ("result", 90.0, 100.0)]
    device = [(tr.COPY, "Memcpy HtoD (Pageable -> Device)", 10.0, 30.0),
              (tr.KERNEL, "k1", 30.0, 35.0), (tr.KERNEL, "k2", 33.0, 40.0),
              (tr.COPY, "Memcpy HtoD (Pageable -> Device)", 60.0, 70.0),
              (tr.FILL, "Memset (Device)", 70.0, 72.0),
              (tr.COPY, "Memcpy DtoH (Device -> Pageable)", 95.0, 99.0),
              (tr.KERNEL, "late", 120.0, 130.0)]
    s = tr.summarize(device, host)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(46e-6)
    assert s["kernel_s"] == pytest.approx(12e-6)
    assert s["htod_s"] == pytest.approx(30e-6)
    gaps = dict((round(v * 1e6), n) for n, v in s["idle_gaps"])
    assert gaps == {10: "feed", 20: "loop", 23: "feed", 1: "result"}
    assert s["device_ops"][0] == ["Memcpy HtoD (Pageable -> Device)",
                                  pytest.approx(30e-6)]
    assert tr.summarize(device, [("feed", 0.0, 1.0)]) is None
    assert tr.summarize([], host) is None


class _Event:
    """A kineto event as :func:`trace.classify` reads one (µs in, ns out),
    with its activity type (torch 2.12 on)."""

    def __init__(self, kind, name, lo, hi):
        self.kind, self._name, self.lo, self.hi = kind, name, lo, hi

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return int(self.lo * 1e3)

    def duration_ns(self):
        return int((self.hi - self.lo) * 1e3)


class _OlderEvent:
    """The same event as torch before 2.12 binds it: no activity type,
    a device and an annotation flag."""

    def __init__(self, event):
        self.event = event

    def name(self):
        return self.event.name()

    def start_ns(self):
        return self.event.start_ns()

    def duration_ns(self):
        return self.event.duration_ns()

    def device_type(self):
        from torch.autograd import DeviceType
        on_card = self.event.kind in ("kernel", "gpu_memcpy", "gpu_memset",
                                      "gpu_user_annotation")
        return DeviceType.CUDA if on_card else DeviceType.CPU

    def is_user_annotation(self):
        return self.event.kind in ("user_annotation", "gpu_user_annotation")


@pytest.mark.parametrize("binding", ["activity_type", "older"])
def test_annotations_are_no_device_work(binding):
    """A ``record_function`` of the program's own inside the window shows
    on the device's timeline as an annotation, and leaves busy and kernel
    time as they were; so do the benchmark's spans and the host's calls."""
    wrap = (lambda e: e) if binding == "activity_type" else _OlderEvent
    events = [_Event("user_annotation", "window", 0.0, 100.0),
              _Event("gpu_user_annotation", "window", 0.0, 100.0),
              _Event("user_annotation", "feed", 0.0, 40.0),
              _Event("gpu_user_annotation", "feed", 5.0, 40.0),
              _Event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)",
                     10.0, 30.0),
              _Event("kernel", "k1", 30.0, 35.0),
              _Event("gpu_memset", "Memset (Device)", 35.0, 37.0),
              _Event("cuda_runtime", "cudaLaunchKernel", 29.0, 30.0),
              _Event("cpu_op", "aten::copy_", 10.0, 30.0)]
    foreign = events + [_Event("user_annotation", "engine.feed", 2.0, 39.0),
                        _Event("gpu_user_annotation", "engine.feed",
                               2.0, 60.0)]
    names = {"window", "feed"}
    plain = tr.summarize(*tr.classify(map(wrap, events), names)[:2])
    device, host, kinds = tr.classify(map(wrap, foreign), names)
    assert kinds["gpu_user_annotation"] == 3
    assert kinds["kernel"] == kinds["gpu_memset"] == 1
    assert sorted(n for n, _, _ in host) == ["feed", "window"]
    got = tr.summarize(device, host)
    assert got == plain
    assert got["busy_s"] == pytest.approx(27e-6)
    assert got["kernel_s"] == pytest.approx(5e-6)
    assert got["htod_s"] == pytest.approx(20e-6)


def test_trace_timeline_reads_a_profile():
    """The profiler's raw events give the benchmark's spans (a CPU
    profile has no device operation, so nothing is summarized)."""
    from torch.profiler import ProfilerActivity, profile
    spans = tr.Spans(traced=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("window"):
            for _ in range(3):
                with spans.span("feed"):
                    torch.ones(8).sum()
    device, host, kinds = tr.timeline(prof, set(spans.seconds))
    assert device == [] and kinds["user_annotation"] == 4
    assert sorted(name for name, _, _ in host) == ["feed"] * 3 + ["window"]
    (w_lo, w_hi), = [(lo, hi) for name, lo, hi in host if name == "window"]
    assert all(w_lo <= lo <= hi <= w_hi for _, lo, hi in host)
    assert tr.summarize(device, host) is None
