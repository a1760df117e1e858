"""The host half of the port's pinned staging ring (``staging.Stage``)
on the CPU, where nothing is pinned: slots taken in turn and grown to the
largest batch they take, smaller batches handed views of a slot, the
caller's arrays converted as ``steps.to_device`` converts them and free
once ``put`` returns, the growth counter, torch's thread count restored.
The card's half (copy stream, events, the staged ``FilteredCounter``) is
held by the ``gpu`` tests of ``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch import staging, steps, tracing

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _batch(seed, b, length):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 5, (b, length), dtype=np.uint8),
            rng.integers(0, length + 1, b).astype(np.int32))


def _sizes(stage):
    return [(None if s.codes is None else s.codes.numel(),
             None if s.lengths is None else s.lengths.numel())
            for s in stage.slots]


def _same_storage(view, buffer):
    """True when *view* starts at *buffer*'s first element (an empty
    view has no data pointer of its own)."""
    return (view.untyped_storage().data_ptr()
            == buffer.untyped_storage().data_ptr()
            and view.storage_offset() == 0)


def test_slots_are_taken_in_turn_and_grow_to_the_largest_batch():
    stage = staging.Stage(CPU)
    assert not stage.pinned and len(stage.slots) == staging.SLOTS == 3
    tracing.enable()
    shapes = [(10, 150), (10, 150), (10, 150),  # each slot's first batch
              (20, 150),                        # slot 0 grows
              (5, 100), (10, 150),              # slots 1, 2 hold them
              (8, 300),                         # slot 0: B*L 2,400 < 3,000
              (30, 10),                         # slot 1: more lengths
              (4, 151)]                         # slot 2 holds it
    grows = [1, 2, 3, 4, 4, 4, 4, 5, 5]
    sizes = [[(1500, 10), (None, None), (None, None)],
             [(1500, 10), (1500, 10), (None, None)],
             [(1500, 10), (1500, 10), (1500, 10)],
             [(3000, 20), (1500, 10), (1500, 10)],
             [(3000, 20), (1500, 10), (1500, 10)],
             [(3000, 20), (1500, 10), (1500, 10)],
             [(3000, 20), (1500, 10), (1500, 10)],
             [(3000, 20), (1500, 30), (1500, 10)],
             [(3000, 20), (1500, 30), (1500, 10)]]
    for i, (b, length) in enumerate(shapes):
        codes, lengths = _batch(i, b, length)
        got_codes, got_lengths = stage.put(codes, lengths)
        slot = stage.slots[i % staging.SLOTS]
        assert got_codes.data_ptr() == slot.codes.data_ptr()
        assert got_lengths.data_ptr() == slot.lengths.data_ptr()
        assert np.array_equal(got_codes.numpy(), codes)
        assert np.array_equal(got_lengths.numpy(), lengths)
        assert tracing.counter("filter.stage_grows") == grows[i]
        assert _sizes(stage) == sizes[i]
        stage.release()  # nothing to record off the card
    # nothing is pinned, so no put ever waits for its slot
    assert tracing.counter("filter.stage_waits") == 0


def test_smaller_batches_get_views_of_the_slot_they_take():
    stage = staging.Stage(CPU)
    big = _batch(1, 64, 152)
    for _ in range(staging.SLOTS):
        stage.put(*big)
    held = _sizes(stage)
    for i, (b, length) in enumerate([(64, 152), (1, 152), (64, 31),
                                     (17, 100), (0, 152), (3, 0)]):
        codes, lengths = _batch(10 + i, b, length)
        slot = stage.slots[stage._turn]
        got_codes, got_lengths = stage.put(codes, lengths)
        assert got_codes.shape == (b, length) and got_lengths.shape == (b,)
        assert got_codes.dtype == torch.uint8
        assert got_lengths.dtype == torch.int32
        assert got_codes.is_contiguous() and got_lengths.is_contiguous()
        assert _same_storage(got_codes, slot.codes)
        assert _same_storage(got_lengths, slot.lengths)
        assert np.array_equal(got_codes.numpy(), codes)
        assert np.array_equal(got_lengths.numpy(), lengths)
    assert _sizes(stage) == held


def _inputs():
    """(name, codes, lengths) the stage converts: non-contiguous and
    wrongly-typed arrays among them."""
    codes, lengths = _batch(7, 12, 60)
    wide = np.ascontiguousarray(np.repeat(codes, 2, axis=1))
    return [
        ("plain", codes, lengths),
        ("every other column", wide[:, ::2], lengths),
        ("every other row", codes[::2], lengths[::2]),
        ("reversed rows", codes[::-1], lengths[::-1]),
        ("Fortran order", np.asfortranarray(codes), lengths),
        ("transposed view", np.ascontiguousarray(codes.T).T, lengths),
        ("int64 codes", codes.astype(np.int64), lengths),
        ("int16 codes, uint16 lengths", codes.astype(np.int16),
         lengths.astype(np.uint16)),
        ("int64 lengths", codes, lengths.astype(np.int64)),
        ("float lengths", codes, lengths.astype(np.float64)),
        ("list lengths", codes, lengths.tolist()),
    ]


@pytest.mark.parametrize("name,codes,lengths", _inputs(),
                         ids=[name for name, _, _ in _inputs()])
def test_the_copy_converts_as_to_device_does(name, codes, lengths):
    want_codes, want_lengths = steps.to_device(codes, lengths, CPU)
    stage = staging.Stage(CPU)
    for _ in range(staging.SLOTS + 1):
        got_codes, got_lengths = stage.put(codes, lengths)
        assert got_codes.dtype == want_codes.dtype == torch.uint8
        assert got_lengths.dtype == want_lengths.dtype == torch.int32
        assert torch.equal(got_codes, want_codes), name
        assert torch.equal(got_lengths, want_lengths), name


def test_the_caller_may_overwrite_its_arrays_once_put_returns():
    stage = staging.Stage(CPU)
    codes = np.zeros((8, 40), np.uint8)
    lengths = np.zeros(8, np.int32)
    want, got = [], []
    for i in range(2 * staging.SLOTS + 1):
        # one buffer, refilled in place before each put
        codes[...] = _batch(i, 8, 40)[0]
        lengths[...] = i
        want.append((codes.copy(), lengths.copy()))
        host = stage.put(codes, lengths)
        got.append(tuple(t.clone() for t in host))
        codes[...] = 4  # overwritten before the next put
        lengths[...] = -1
        assert np.array_equal(host[0].numpy(), want[-1][0])
        assert np.array_equal(host[1].numpy(), want[-1][1])
    for (wc, wl), (gc, gl) in zip(want, got):
        assert np.array_equal(gc.numpy(), wc)
        assert np.array_equal(gl.numpy(), wl)


@pytest.mark.parametrize("threads", [1, 3])
def test_the_copy_restores_torchs_thread_count(threads):
    held = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        stage = staging.Stage(CPU)
        stage.put(*_batch(2, 16, 50))
        assert torch.get_num_threads() == threads
    finally:
        torch.set_num_threads(held)


def test_the_copy_never_cuts_a_callers_higher_thread_count(monkeypatch):
    """A caller that runs torch on more threads than the stage's copy
    needs keeps them: the stage sets no thread count at all."""
    held = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        stage = staging.Stage(CPU)
        stage._threads = 2
        set_to = []
        monkeypatch.setattr(torch, "set_num_threads", set_to.append)
        stage.put(*_batch(4, 16, 50))
        assert set_to == []
        assert torch.get_num_threads() == 3
    finally:
        monkeypatch.undo()
        torch.set_num_threads(held)


def test_the_stage_counters_are_the_engines_and_count_only_when_on():
    assert tracing.COUNTERS["filter.stage_waits"] == tracing.ENGINE
    assert tracing.COUNTERS["filter.stage_grows"] == tracing.ENGINE
    stage = staging.Stage(CPU)
    for i in range(staging.SLOTS):
        stage.put(*_batch(i, 4, 50))
    assert tracing.collect()["counters"] == {}


def test_a_cpu_filtered_counter_keeps_the_callers_arrays(monkeypatch):
    """On the CPU, K1 reads the caller's arrays in place: the counter
    makes no stage, and ``steps.to_device`` hands K1 the caller's memory."""
    def refuse(device):
        raise AssertionError("a CPU counter made a staging ring")

    monkeypatch.setattr(staging, "Stage", refuse)
    codes, lengths = _batch(3, 20, 80)
    words = eng.KmerIndex.from_strings(["A" * 31], 31, device=CPU).keys_np
    fc = eng.FilteredCounter(eng.KmerIndex(words, 31, device=CPU),
                             dedup=True)
    fc.feed(codes, lengths)
    assert fc._stage is None
    up_codes, up_lengths = steps.to_device(codes, lengths, CPU)
    assert up_codes.data_ptr() == codes.ctypes.data
    assert up_lengths.data_ptr() == lengths.ctypes.data
