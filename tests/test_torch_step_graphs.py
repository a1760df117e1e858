"""The bookkeeping of a staged counter's CUDA graphs
(``engine._StepGraphs``) on the CPU, with the capture replaced by a
stand-in graph: a key's first batch runs eagerly, its second is captured
and replayed, later ones replayed; each replay adds its launches to the
launch counters; past ``GRAPHS_KEPT`` keys every graph is dropped.  The
capture and the replay on a card are held by the ``gpu`` test
``test_staged_counter_replays_a_graph_a_slot_and_counts_its_launches``
of ``tests/test_torch_gpu.py``."""

import pytest
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch import tracing

COUNTER = "launches.extract_canonical"


class _Graph:
    def __init__(self, calls):
        self.calls = calls

    def replay(self):
        self.calls.append("replay")


@pytest.fixture
def graphs(monkeypatch):
    calls = []

    def launch(batch):
        calls.append("eager")
        tracing.count(COUNTER)
        return "eager counts"

    held = eng._StepGraphs(launch)

    def capture(batch):
        calls.append("capture")
        return _Graph(calls), "graph counts", {COUNTER: 1}

    monkeypatch.setattr(held, "_capture", capture)
    return held, calls


def _batch(b, length=20):
    return (torch.zeros(b, length, dtype=torch.uint8),
            torch.zeros(b, dtype=torch.int32))


def test_eager_then_captured_then_replayed_counting_every_launch(graphs):
    held, calls = graphs
    batch = _batch(4)
    before = tracing.counter(COUNTER)
    outs = [held.run(batch) for _ in range(4)]
    assert calls == ["eager", "capture", "replay", "replay", "replay"]
    assert outs == ["eager counts"] + ["graph counts"] * 3
    assert tracing.counter(COUNTER) - before == 4


def test_each_buffer_and_shape_is_a_key_of_its_own(graphs):
    held, calls = graphs
    first, other = _batch(4), _batch(4)
    narrower = (first[0][:2], first[1][:2])  # same buffers, other shape
    for batch in (first, other, narrower, first, other, narrower):
        held.run(batch)
    assert calls == ["eager"] * 3 + ["capture", "replay"] * 3


def test_past_graphs_kept_every_graph_is_dropped(graphs):
    held, calls = graphs
    batches = [_batch(2) for _ in range(eng.GRAPHS_KEPT + 1)]
    first = batches[0]
    held.run(first)
    held.run(first)  # captured
    for batch in batches[1:]:
        held.run(batch)
    assert len(held._held) == 1  # cleared at the last new key
    calls.clear()
    held.run(first)
    assert calls == ["eager"]
