"""CUDA kernels of the port against their plain PyTorch versions, on the
card.  Marked ``gpu``; each test skips without a CUDA device.

This file imports neither jax nor the JAX package's engine, so it also
runs where jax is not installed, without tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch import staging, steps, tracing
from kmer_denovo_filter_tpu_torch.experiments.x_fused import pair_order
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops import directory as tdir
from kmer_denovo_filter_tpu_torch.ops import extract, member, probe, segsort
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from tests.test_torch_directory import (
    N_BATCH,
    SMS,
    TABLES,
    launch,
    make_table,
    queries,
)
from tests.test_torch_directory_wide import (
    BITS_EDGE,
    make_table_wide,
    queries_wide,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches(*kernels):
    """The launch counters of *kernels* (``tracing``'s ``launches.<kernel>``):
    one int for one kernel, else a tuple."""
    counts = tuple(tracing.counter(f"launches.{k}") for k in kernels)
    return counts[0] if len(counts) == 1 else counts


def _batch(seed, n=2048, length=152):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, length), dtype=np.uint8)
    codes[rng.random((n, length)) < 0.01] = 4
    lengths = rng.integers(0, length + 1, n).astype(np.int32)
    lengths[::2] = length
    return torch.from_numpy(codes), torch.from_numpy(lengths)


@pytest.mark.parametrize("k", [3, 15, 17, 21, 31])
def test_extract_kernel_matches_plain(cuda, k):
    codes, lengths = (t.to(cuda) for t in _batch(k))
    before = _launches("extract_canonical")
    got = extract.extract_canonical(codes, lengths, k)
    ref = dev.extract_canonical_windows(codes, lengths, k)[0]
    torch.cuda.synchronize()
    assert _launches("extract_canonical") == before + 1
    assert torch.equal(got, ref)


def _extract_matches_plain(codes, lengths, k):
    """K1 (k <= 31) or K1w on a CUDA batch equals its plain version, in
    one launch; returns the keys."""
    narrow = k <= keys64.NARROW_K
    counter = "extract_canonical" if narrow else "extract_canonical_wide"
    before = _launches(counter)
    if narrow:
        got = extract.extract_canonical(codes, lengths, k)
        ref = dev.extract_canonical_windows(codes, lengths, k)[0]
    else:
        got = extract.extract_canonical_wide(codes, lengths, k)
        ref = dev.extract_canonical_windows_wide(codes, lengths, k)[0]
    torch.cuda.synchronize()
    assert _launches(counter) == before + 1
    assert torch.equal(got, ref)
    return got


def _ragged(seed, k, length, n=1024):
    """Ragged reads with N bases, lengths of 0 and k - 1, all-N rows."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, length), dtype=np.uint8)
    codes[rng.random((n, length)) < 0.01] = 4
    lengths = rng.integers(0, length + 1, n).astype(np.int32)
    lengths[::3] = length
    lengths[1::17] = 0
    lengths[2::17] = k - 1
    codes[5::31] = 4
    return torch.from_numpy(codes), torch.from_numpy(lengths)


@pytest.mark.parametrize("k,length", [
    (k, length) for k in (3, 15, 31, 33, 63)
    for length in (k, 32, 33, 63, 64, 65, 97) if length >= k])
def test_extract_kernels_ragged_lengths(cuda, k, length):
    """Read lengths around the 2-bit word and 16-byte chunk edges, L = k
    (one window a read) included."""
    codes, lengths = (t.to(cuda) for t in _ragged(k * 1000 + length, k,
                                                  length))
    _extract_matches_plain(codes, lengths, k)


@pytest.mark.parametrize("k", [31, 63])
def test_extract_kernels_one_long_row(cuda, k):
    """One (1, 2**20) row, as ``StreamCounter.feed_sequence`` feeds a
    contig: tiles cut the row, not reads."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (1, 1 << 20), dtype=np.uint8)
    codes[0, rng.random(1 << 20) < 0.001] = 4
    lengths = torch.tensor([1 << 20], dtype=torch.int32, device=cuda)
    got = _extract_matches_plain(torch.from_numpy(codes).to(cuda), lengths,
                                 k)
    assert got.shape[1] == (1 << 20) - k + 1


def test_extract_wide_kernel_window_sparse(cuda):
    """k = 151 on 152 bp reads: two windows a read, ~27 a tile."""
    codes, lengths = (t.to(cuda) for t in _batch(151, n=4096))
    got = _extract_matches_plain(codes, lengths, 151)
    assert got.shape == (4096, 2, 5)


@pytest.mark.parametrize("k", [31, 63])
def test_extract_kernels_stacked_group(cuda, k):
    """A group of batches of widths 152, 144, .., 96 stacked and padded
    with code 4, as ``scan_reads_for_hits_many`` stacks them."""
    parts = [_batch(k + i, n=512, length=152 - 8 * i) for i in range(8)]
    codes = torch.full((512 * 8, 152), 4, dtype=torch.uint8)
    for i, (c, _l) in enumerate(parts):
        codes[512 * i:512 * (i + 1), :c.shape[1]] = c
    lengths = torch.cat([l for _c, l in parts])
    _extract_matches_plain(codes.to(cuda), lengths.to(cuda), k)


@pytest.mark.parametrize("k", [31, 63])
def test_extract_kernels_unaligned_view(cuda, k):
    """A contiguous view whose data starts 97 bytes into its storage:
    the tiles' chunk frames are not the tensor's, the edges load by
    bytes."""
    codes, lengths = (t.to(cuda) for t in _batch(k + 1, n=1025, length=97))
    _extract_matches_plain(codes[1:], lengths[1:], k)


@pytest.mark.parametrize("m", [1, 777, 6144, 6145, 100_000])
def test_probe_kernel_matches_plain(cuda, m):
    """Table sizes around the 48 KB shared-memory staging edge."""
    codes, lengths = (t.to(cuda) for t in _batch(m))
    keys = extract.extract_canonical(codes, lengths, 31).reshape(-1)
    live = torch.unique(keys[keys != keys64.SENTINEL])
    gen = torch.Generator(device="cpu").manual_seed(m)
    from_batch = live[torch.randperm(live.numel(), generator=gen)[
        :max(1, m // 2)].to(cuda)]
    rand = torch.randint(0, 4 ** 31, (m - from_batch.numel(),),
                         generator=gen).to(cuda)
    table = torch.unique(torch.cat([from_batch, rand]))
    acc = torch.full((table.numel(),), 5, dtype=torch.int64, device=cuda)
    before = _launches("probe_tally")
    probe.probe_tally(keys, table, acc)
    ref = 5 + dev.small_table_tally(table, keys)
    torch.cuda.synchronize()
    assert _launches("probe_tally") == before + 1
    assert torch.equal(acc, ref)
    assert int(ref.sum()) > 5 * table.numel()


def test_filtered_counter_cuda_matches_cpu(cuda):
    codes, lengths = _batch(99, n=3000)
    keys = dev.extract_canonical_windows(codes, lengths, 31)[0]
    live = torch.unique(keys[keys != keys64.SENTINEL])[::7]
    words = keys64.keys64_to_words(live, 31)
    results = []
    for device in (cuda, torch.device("cpu")):
        fc = eng.FilteredCounter(eng.KmerIndex(words, 31, device=device))
        fc.feed(codes.numpy(), lengths.numpy())
        fc.feed(codes[:1000].numpy(), lengths[:1000].numpy())
        results.append(fc.result())
    assert np.array_equal(results[0], results[1])
    assert results[0].sum() > 0


def _table_for(keys, m, cuda):
    """(≈m,) sorted unique int64 table: half batch keys, half random."""
    live = torch.unique(keys[keys != keys64.SENTINEL])
    gen = torch.Generator(device="cpu").manual_seed(m)
    from_batch = live[torch.randperm(live.numel(), generator=gen)[
        :max(1, m // 2)].to(cuda)]
    rand = torch.randint(0, 4 ** 31, (m - from_batch.numel(),),
                         generator=gen).to(cuda)
    return torch.unique(torch.cat([from_batch, rand]))


@pytest.mark.parametrize("m", [1, 777, 6144, 6145, 100_000])
def test_weighted_probe_kernel_matches_plain(cuda, m):
    """K3 over a dedup'd batch with duplicated reads (weights > 1)."""
    codes, lengths = (t.to(cuda) for t in _batch(m))
    codes = torch.cat([codes, codes[:700]])
    lengths = torch.cat([lengths, lengths[:700]])
    win = extract.extract_canonical(codes, lengths, 31).reshape(-1)
    table = _table_for(win, m, cuda)
    keys, weights = dev.dedup_windows(win)
    acc = torch.full((table.numel(),), 3, dtype=torch.int64, device=cuda)
    before = _launches("probe_tally_weighted")
    probe.probe_tally_weighted(keys, weights, table, acc)
    ref = 3 + dev.small_table_tally(table, win)
    torch.cuda.synchronize()
    assert _launches("probe_tally_weighted") == before + 1
    assert torch.equal(acc, ref)
    assert int(ref.max()) > 4


@pytest.mark.parametrize("m", [1, 777, 6144, 6145, 100_000])
def test_member_kernel_matches_plain(cuda, m):
    codes, lengths = (t.to(cuda) for t in _batch(m + 1))
    win = extract.extract_canonical(codes, lengths, 31).reshape(-1)
    table = _table_for(win, m, cuda)
    before = _launches("probe_member")
    got = member.probe_member(win, table)
    rows = member.probe_rows(win, table)
    ref = dev.member(table, win)
    ref_rows = dev.find_rows(table, win)
    torch.cuda.synchronize()
    assert _launches("probe_member") == before + 2
    assert got.dtype == torch.bool and torch.equal(got, ref)
    assert rows.dtype == torch.int64 and torch.equal(rows, ref_rows)
    assert bool(ref.any()) and not bool(ref.all())


def test_discovery_engine_cuda_matches_cpu(cuda):
    """Dedup-first counter and grouped scan on the card equal the CPU."""
    codes, lengths = _batch(7, n=3000)
    keys = dev.extract_canonical_windows(codes, lengths, 31)[0]
    live = torch.unique(keys[keys != keys64.SENTINEL])[::5]
    words = keys64.keys64_to_words(live, 31)
    batches = [(codes[i:i + 1000].numpy(), lengths[i:i + 1000].numpy())
               for i in range(0, 3000, 1000)]
    counts, masks = [], []
    for device in (cuda, torch.device("cpu")):
        fc = eng.make_parent_filter_counter(words, 31, device=device)
        for c, l in batches:
            fc.feed(c, l)
        counts.append(fc.result())
        masks.append(eng.scan_reads_for_hits_many(
            eng.KmerIndex(words, 31, device=device), batches))
    assert np.array_equal(counts[0], counts[1]) and counts[0].sum() > 0
    assert all(np.array_equal(a, b) for a, b in zip(*masks))


def test_cuda_tables_stay_on_the_card(cuda, monkeypatch):
    """``KDF_DEVICE_TABLE_BYTES`` sends no CUDA table to the host: the
    index and the parent filter stay on the card, and ``counts_of``
    (K4 rows) equals the CPU index."""
    codes, lengths = _batch(11, n=1000)
    keys = dev.extract_canonical_windows(codes, lengths, 31)[0]
    live = torch.unique(keys[keys != keys64.SENTINEL])
    words = keys64.keys64_to_words(live[::3], 31)
    counts = np.arange(words.shape[0], dtype=np.int64) + 1
    monkeypatch.setenv("KDF_DEVICE_TABLE_BYTES", "1")
    idx = eng.make_membership_index(words, 31, counts, device=cuda)
    assert isinstance(idx, eng.KmerIndex) and idx.table.is_cuda
    fc = eng.make_parent_filter_counter(words, 31, device=cuda)
    assert isinstance(fc, eng.FilteredCounter) and fc.acc.is_cuda
    queries = keys64.keys64_to_words(live[::2], 31)
    cpu_idx = eng.KmerIndex(words, 31, counts, device="cpu")
    got = idx.counts_of(queries)
    assert np.array_equal(got, cpu_idx.counts_of(queries)) and got.any()


# ── FilteredCounter's pinned staging ring (staging.Stage) ─────────────


def _genome_batches(k, shapes, seed=0, genome=20_000):
    """(table words, host batches): reads of *shapes* (B, L) drawn from
    one random genome, with N bases and ragged lengths (0 and k - 1
    among them), so batches share k-mers; the table holds every third
    distinct key of them all."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, genome, dtype=np.uint8)
    batches = []
    for b, length in shapes:
        starts = rng.integers(0, genome - length, b)
        codes = bases[starts[:, None] + np.arange(length)]
        codes[rng.random((b, length)) < 0.003] = 4
        lengths = np.full(b, length, np.int32)
        lengths[::5] = rng.integers(0, length + 1, len(lengths[::5]))
        lengths[3::17] = max(0, k - 1)
        batches.append((codes, lengths))
    keys = []
    for codes, lengths in batches:
        win = steps.window_keys(codes, lengths, k, torch.device("cpu"))
        if win is not None:
            keys.append(win.flatten(0, 1))
    flat = torch.cat(keys)
    if flat.dim() == 1:
        live = torch.unique(flat[flat != keys64.SENTINEL])
        return keys64.keys64_to_words(live[::3], k), batches
    live = torch.unique(flat[flat[:, 0] != keys64.SENTINEL], dim=0)
    return keys64.limbs_to_words(live[::3], k), batches


def _ragged_shapes(k):
    """More feeds than the ring has slots; B and L change every batch, a
    larger batch grows a slot, an empty batch and one narrower than k
    come in between."""
    return [(300, 150), (500, 152), (0, 150), (200, 100), (40, k - 1),
            (900, 160), (100, 250), (700, 150), (1, 150), (1200, 152),
            (64, k), (30, 150)]


@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "plain"])
@pytest.mark.parametrize("k", [31, 63])
def test_staged_filter_counter_matches_the_cpu(cuda, k, dedup):
    words, batches = _genome_batches(k, _ragged_shapes(k), seed=k)
    results = []
    tracing.enable()
    try:
        for device in (cuda, torch.device("cpu")):
            fc = eng.FilteredCounter(eng.KmerIndex(words, k, device=device),
                                     dedup=dedup)
            assert (fc._stage is not None) == (device.type == "cuda")
            for codes, lengths in batches:
                fc.feed(codes, lengths)
            results.append(fc.result())
            if device.type == "cuda":
                # each slot's first batch, then at least one larger one
                assert tracing.counter("filter.stage_grows") > staging.SLOTS
    finally:
        tracing.disable()
        tracing.reset()
    assert np.array_equal(results[0], results[1])
    assert results[0].sum() > 0 and results[0].max() > 1


@pytest.mark.parametrize("k", [31, 63])
def test_staged_counter_replays_a_graph_a_slot_and_counts_its_launches(
        cuda, k):
    """Batches of one shape: each slot's first runs eagerly, its second
    is captured and replayed, the rest replayed; the counts equal the
    CPU's and each kernel's launch counter counts every batch once."""
    words, batches = _genome_batches(k, [(700, 150)] * 4, seed=k + 1)
    feeds = batches * 3  # 12 feeds: 3 eager, 3 captured, 6 replayed
    fc = eng.FilteredCounter(eng.KmerIndex(words, k, device=cuda),
                             dedup=True)
    before = tracing.launches()
    for codes, lengths in feeds:
        fc.feed(codes, lengths)
    got = fc.result()
    graphs = [h for h in fc._graphs._held.values() if h is not None]
    assert len(graphs) == staging.SLOTS
    ran = {n: c - before[n] for n, c in tracing.launches().items()
           if c != before[n]}
    names = (("extract_canonical", "seg_dedup", "probe_tally_weighted")
             if k <= 31 else ("extract_canonical_wide", "seg_dedup_wide",
                              "probe_tally_wide_weighted"))
    assert ran == {n: len(feeds) for n in names}
    ref = eng.FilteredCounter(eng.KmerIndex(words, k, device="cpu"),
                              dedup=True)
    for codes, lengths in feeds:
        ref.feed(codes, lengths)
    assert np.array_equal(got, ref.result()) and got.sum() > 0


def test_staged_feed_lets_the_caller_overwrite_its_arrays(cuda):
    """One host buffer, refilled in place with a new batch before each
    feed and overwritten right after it, in a tight loop: the card's
    counts equal the CPU counter's over the original contents."""
    k = 31
    words, batches = _genome_batches(k, [(2048, 152)] * 10, seed=5)
    index = eng.KmerIndex(words, k, device=cuda)
    fc = eng.FilteredCounter(index, dedup=True)
    codes = np.empty_like(batches[0][0])
    lengths = np.empty_like(batches[0][1])
    for _ in range(3):
        for c, l in batches:
            codes[...] = c
            lengths[...] = l
            fc.feed(codes, lengths)
            codes[...] = 4
            lengths[...] = 0
    ref = eng.FilteredCounter(eng.KmerIndex(words, k, device="cpu"),
                              dedup=True)
    for c, l in batches * 3:
        ref.feed(c, l)
    got = fc.result()
    assert np.array_equal(got, ref.result()) and got.sum() > 0


def test_staged_feed_makes_no_host_sync(cuda):
    """Once every slot holds a batch, a feed waits on the host only for
    its slot's last copy up (an event): with CUDA sync debugging set to
    raise, the staged feeds run, where a pageable copy would raise."""
    k = 31
    words, batches = _genome_batches(k, [(1024, 152)] * 4, seed=9)
    fc = eng.FilteredCounter(eng.KmerIndex(words, k, device=cuda),
                             dedup=True)
    for c, l in batches:
        fc.feed(c, l)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c, l in batches * 2:
            fc.feed(c, l)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = eng.FilteredCounter(eng.KmerIndex(words, k, device="cpu"),
                              dedup=True)
    for c, l in batches * 3:
        ref.feed(c, l)
    assert np.array_equal(fc.result(), ref.result())


@pytest.mark.parametrize("through", ["put", "feed"])
def test_a_growing_slot_waits_for_the_readers_of_the_block_it_takes(
        cuda, through):
    """A slot that grows takes its device buffers from the kernels'
    stream's pool, which hands out a freed block whose reader may still
    be queued on that stream.  A 32 MiB tensor's sum is queued behind a
    long sleep and the tensor freed; the next batch, put on a stage or
    fed to a counter, grows a slot of the same size, so takes that
    block, and returns while the sum still waits: the sum reads the
    tensor's contents, and the batch goes up whole (the counts are the
    CPU's)."""
    k = 31
    words, (small,) = _genome_batches(k, [(2048, 256)], seed=11)
    b, length = 1 << 17, 256  # 32 MiB of codes
    codes = np.random.default_rng(12).integers(0, 5, (b, length),
                                               dtype=np.uint8)
    lengths = np.zeros(b, np.int32)
    codes[:small[0].shape[0]] = small[0]
    lengths[:small[1].shape[0]] = small[1]
    index = eng.KmerIndex(words, k, device=cuda)
    # the sleep and the reader, then a batch of this shape through a
    # counter of its own: their kernels loaded and every block the batch
    # takes cached, so that nothing below asks CUDA for memory or
    # a module (either may wait for the device, and the race would have
    # no window)
    torch.cuda._sleep(1)
    torch.full((b * length,), 7, dtype=torch.uint8,
               device=cuda).sum(dtype=torch.int64)
    eng.FilteredCounter(index, dedup=True).feed(codes, lengths)
    torch.cuda.synchronize()
    if through == "put":
        stage = staging.Stage(cuda)
        slot = stage.slots[0]
    else:
        fc = eng.FilteredCounter(index, dedup=True)
        slot = fc._stage.slots[0]
    held = torch.full((b * length,), 7, dtype=torch.uint8, device=cuda)
    block = held.data_ptr()
    torch.cuda._sleep(500_000_000)  # ~0.3 s of the kernels' stream
    total = held.sum(dtype=torch.int64)
    summed = torch.cuda.Event()
    summed.record()
    del held
    if through == "put":
        up = stage.put(codes, lengths)
        stage.release()
    else:
        fc.feed(codes, lengths)
    waited = summed.query()
    assert int(total) == 7 * b * length
    assert slot.dev_codes.data_ptr() == block, "the slot took another block"
    assert not waited, "the batch waited for the device: no race to see"
    if through == "put":
        assert np.array_equal(up[0].cpu().numpy(), codes)
        assert np.array_equal(up[1].cpu().numpy(), lengths)
        return
    ref = eng.FilteredCounter(eng.KmerIndex(words, k, device="cpu"),
                              dedup=True)
    ref.feed(*small)
    got = fc.result()
    assert np.array_equal(got, ref.result()) and got.sum() > 0


def test_staged_copies_are_pinned_on_a_stream_of_their_own(cuda):
    """Under ``torch.profiler`` each feed's host-to-device copies are
    ``Pinned -> Device``, on another stream than K1."""
    from torch.profiler import ProfilerActivity, profile
    k = 31
    words, batches = _genome_batches(k, [(1024, 152)] * 5, seed=3)
    fc = eng.FilteredCounter(eng.KmerIndex(words, k, device=cuda),
                             dedup=True)
    fc.feed(*batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c, l in batches:
            fc.feed(c, l)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    copies = [e for e in events if e.name().startswith("Memcpy HtoD")]
    k1 = [e for e in events if "extract_canonical_kernel" in e.name()]
    assert len(copies) == 2 * len(batches) and len(k1) == len(batches)
    assert all("Pinned" in e.name() for e in copies), {
        e.name() for e in copies}
    copy_streams = {e.device_resource_id() for e in copies}
    assert copy_streams.isdisjoint({e.device_resource_id() for e in k1})


# ── the prefix directory: kdf_build_directory, K2 and K4 through it ───


def _directory_table(kind, k, cuda):
    """A table of the CPU model's kinds (tests/test_torch_directory.py),
    or "2**20": 2**20 random 31-mer keys."""
    if kind == "2**20":
        gen = torch.Generator(device="cpu").manual_seed(k)
        keys = torch.unique(torch.randint(0, 4 ** k, (1 << 20,),
                                          generator=gen))
        return keys.to(cuda)
    return torch.from_numpy(make_table(kind, k)).to(cuda)


@pytest.mark.parametrize("k", [15, 31])
@pytest.mark.parametrize("kind", TABLES + ("2**20",))
def test_directory_kernel_matches_plain(cuda, kind, k):
    table = _directory_table(kind, k, cuda)
    before = _launches("build_directory")
    got = tdir.build_directory(table)
    ref = tdir.build_directory(table.cpu())
    torch.cuda.synchronize()
    assert _launches("build_directory") == before + 1
    assert (got.bits, got.shift, got.live) == (ref.bits, ref.shift, ref.live)
    assert got.offsets.is_cuda and got.offsets.dtype == torch.int32
    assert torch.equal(got.offsets.cpu(), ref.offsets)


@pytest.mark.parametrize("kind", TABLES + ("2**20",))
def test_directory_probes_match_plain(cuda, kind):
    """K4 (found, rows) and K2, with a prebuilt directory and without
    one (the wrapper builds it), on the model's tables (the staged limits
    6,207 / 10,367 +- 1 among them), on queries that repeat keys and on
    an unaligned view of them."""
    k = 31
    table = _directory_table(kind, k, cuda)
    table_np = table.cpu().numpy()
    live_np = table_np[table_np != keys64.SENTINEL]
    q_np = np.concatenate([queries(table_np, k),
                           np.repeat(live_np[:100], 40)])  # coverage
    q = torch.from_numpy(q_np).to(cuda)
    ref_found, ref_rows = dev.member(table, q), dev.find_rows(table, q)
    ref_tally = dev.small_table_tally(table, q)
    counts = _launches("build_directory", "probe_member", "probe_tally")
    d = tdir.build_directory(table)
    found = member.probe_member(q, table, d)
    rows = member.probe_rows(q, table, d)
    found_own = member.probe_member(q, table)
    acc = torch.full((table.numel(),), 5, dtype=torch.int64, device=cuda)
    probe.probe_tally(q, table, acc, d)
    acc_own = torch.full_like(acc, 3)
    probe.probe_tally(q, table, acc_own)
    view = q[1:]
    found_view = member.probe_member(view, table, d)
    acc_view = torch.zeros_like(acc)
    probe.probe_tally(view, table, acc_view, d)
    torch.cuda.synchronize()
    assert _launches("build_directory", "probe_member", "probe_tally") == (
        counts[0] + 3, counts[1] + 4, counts[2] + 3)
    assert torch.equal(found, ref_found) and torch.equal(found_own, ref_found)
    assert torch.equal(rows, ref_rows)
    assert torch.equal(acc, ref_tally + 5) and torch.equal(acc_own,
                                                           ref_tally + 3)
    assert torch.equal(found_view, dev.member(table, view))
    assert torch.equal(acc_view, dev.small_table_tally(table, view))
    if d.live:
        assert bool(ref_found.any()) and int(ref_tally.max()) > 40


def test_probes_refuse_another_tables_directory(cuda):
    """K2 and K4 given the directory of another table of the same size
    raise before any launch."""
    table = _directory_table("4096", 31, cuda)
    other = torch.from_numpy(make_table("4096", 21)).to(cuda)
    d = tdir.build_directory(other)
    q = table[:100].clone()
    counts = _launches("probe_member", "probe_tally")
    for call in (lambda: member.probe_member(q, table, d),
                 lambda: member.probe_rows(q, table, d),
                 lambda: probe.probe_tally(q, table, torch.zeros_like(table),
                                           d)):
        with pytest.raises(ValueError, match="does not belong"):
            call()
    assert _launches("probe_member", "probe_tally") == counts


@pytest.mark.parametrize("counts", [True, False], ids=["K2", "K4"])
@pytest.mark.parametrize("live", [1, 4096, 6207, 6208, 10367, 10368,
                                  262_144, 1 << 24])
@pytest.mark.parametrize("n", [100, N_BATCH])
def test_default_launch_plan_is_the_models(cuda, counts, live, n):
    """With no launch override, ``kdf::dir_probe_launch`` gives the CPU
    model's plan, the one K2 and K4 had before overrides existed (an
    H100 SXM's: 132 SMs, 115,712 bytes of staged budget a block)."""
    if torch.cuda.get_device_properties(cuda).multi_processor_count != SMS:
        pytest.skip("the model's plan is an H100 SXM's")
    bits = tdir.directory_bits(live)
    plan = tdir.launch_plan(n, live, bits, counts)
    assert (plan.staged, plan.blocks, plan.threads, plan.smem) == launch(
        n, live, bits, counts)
    assert plan.budget == 115712


@pytest.mark.parametrize("m", [4096, 6208, 10368, 262_144])
def test_launch_overrides_match_the_plan(cuda, m):
    """K2, K4 and K3 (on K9d's slots) under each launch override equal
    their default launch and the plain versions, one launch each; the
    staged form over its edge raises before launching."""
    codes, lengths = _batch(11)
    # a quarter of the reads twice, so K2's counts repeat
    codes, lengths = (torch.cat([t, t[:512]]).to(cuda)
                      for t in (codes, lengths))
    flat = extract.extract_canonical(codes, lengths, 31).reshape(-1)
    live = torch.unique(flat[flat != keys64.SENTINEL]).cpu().numpy()
    rng = np.random.default_rng(m)
    table_np = np.unique(np.concatenate([
        rng.choice(live, min(m // 2, live.size), replace=False),
        rng.integers(0, 4 ** 31, m, dtype=np.int64)]))[:m]
    table = torch.from_numpy(table_np).to(cuda)
    d = tdir.build_directory(table)
    slots = segsort.seg_dedup(flat)
    ref_acc = dev.small_table_tally(table, flat)
    ref_found = dev.member(table, flat)
    ref_w = dev.weighted_tally(table, *dev.segment_compact(*slots),
                               torch.zeros_like(ref_acc))
    overrides = [tdir.Launch("global"), tdir.Launch("auto", 128, 1),
                 tdir.Launch("auto", 512, 2), tdir.Launch("global", 512, 4),
                 tdir.Launch("auto", 256, 1)]
    for name, counts in (("K2", True), ("K4", False)):
        fits = tdir.launch_plan(flat.numel(), d.live, d.bits, counts).staged
        staged = tdir.Launch("staged")
        if not fits:
            before = _launches("probe_tally", "probe_member")
            with pytest.raises(ValueError, match="staged edge"):
                if counts:
                    probe.probe_tally(flat, table, torch.zeros_like(ref_acc),
                                      d, staged)
                else:
                    member.probe_member(flat, table, d, staged)
            assert _launches("probe_tally", "probe_member") == before
        for o in overrides + ([staged] if fits else []):
            before = _launches("probe_tally", "probe_member")
            if counts:
                acc = torch.zeros_like(ref_acc)
                probe.probe_tally(flat, table, acc, d, o)
                torch.cuda.synchronize()
                assert torch.equal(acc, ref_acc), (name, o)
                assert _launches("probe_tally") == before[0] + 1
            else:
                got = member.probe_member(flat, table, d, o)
                torch.cuda.synchronize()
                assert torch.equal(got, ref_found), (name, o)
                assert _launches("probe_member") == before[1] + 1
    for o in overrides:
        acc = torch.zeros_like(ref_acc)
        probe.probe_tally_weighted(*slots[:2], table, acc, d, slots[2], o)
        torch.cuda.synchronize()
        assert torch.equal(acc, ref_w), ("K3", o)
    assert (ref_acc > 1).any() and ref_found.any()


@pytest.mark.parametrize("m", [4096, 10367, 10368, 262_144])
def test_member_kernel_stacked_group(cuda, m):
    """K4 over a stacked group of 8 batches of widths 152, 144, .., 96
    padded with code 4, through the directory ``KmerIndex`` builds."""
    parts = [_batch(m + i, n=512, length=152 - 8 * i) for i in range(8)]
    codes = torch.full((512 * 8, 152), 4, dtype=torch.uint8)
    for i, (c, _l) in enumerate(parts):
        codes[512 * i:512 * (i + 1), :c.shape[1]] = c
    lengths = torch.cat([l for _c, l in parts])
    win = extract.extract_canonical(codes.to(cuda), lengths.to(cuda),
                                    31).reshape(-1)
    table = _table_for(win, m, cuda)
    index = eng.KmerIndex(keys64.keys64_to_words(table.cpu(), 31), 31,
                          device=cuda)
    assert index.directory is not None and index.directory.live == m
    before = _launches("build_directory")
    got = member.probe_member(win, index.table, index.directory)
    torch.cuda.synchronize()
    assert _launches("build_directory") == before
    assert torch.equal(got, dev.member(table, win))
    assert bool(got.any()) and not bool(got.all())


def test_cuda_probes_use_no_library_search(cuda, monkeypatch):
    """On the card the directory, K2 and K4 run no ``torch.searchsorted``,
    ``torch.isin`` or plain version."""
    table = _directory_table("4096", 31, cuda)
    big = _directory_table("2**20", 31, cuda)
    q = torch.from_numpy(queries(table.cpu().numpy(), 31)).to(cuda)

    def refuse(*_args, **_kwargs):
        raise AssertionError("a library search ran on the CUDA path")
    for mod, name in ((torch, "searchsorted"), (torch, "isin"),
                      (dev, "member"), (dev, "find_rows"),
                      (dev, "small_table_tally"),
                      (tdir, "plain_directory")):
        monkeypatch.setattr(mod, name, refuse)
    for t in (table, big):
        member.probe_member(q, t)
        member.probe_rows(q, t)
        probe.probe_tally(q, t, torch.zeros_like(t))
    torch.cuda.synchronize()


# ── wide keys: K1w, K7 (both forms), K8 ────────────────────────────────


def _wide_table_for(flat, m, k, cuda):
    """(≈m, Q) sorted unique limb rows: half batch keys, half random."""
    live = dev.unique_rows(flat[flat[:, 0] != keys64.SENTINEL])[0]
    gen = torch.Generator(device="cpu").manual_seed(m)
    from_batch = live[torch.randperm(live.shape[0], generator=gen)[
        :max(1, m // 2)].to(cuda)]
    rand = torch.stack([torch.randint(0, 4 ** nb, (m - from_batch.shape[0],),
                                      generator=gen)
                        for nb in keys64.limb_bases(k)], 1).to(cuda)
    return dev.unique_rows(torch.cat([from_batch, rand]))[0]


@pytest.mark.parametrize("k", [33, 63, 127, 151, 201, 207])
def test_extract_wide_kernel_matches_plain(cuda, k):
    codes, lengths = (t.to(cuda) for t in _batch(k, length=k + 60))
    before = _launches("extract_canonical_wide")
    got = extract.extract_canonical_wide(codes, lengths, k)
    ref = dev.extract_canonical_windows_wide(codes, lengths, k)[0]
    torch.cuda.synchronize()
    assert _launches("extract_canonical_wide") == before + 1
    assert got.shape == ref.shape == (2048, 61, keys64.limbs_per_kmer(k))
    assert torch.equal(got, ref)
    assert bool((ref[..., 0] != keys64.SENTINEL).any())


@pytest.mark.parametrize("k,m", [(33, 1), (63, 777), (63, 2048), (63, 2049),
                                 (63, 100_000), (201, 877), (201, 878),
                                 (201, 50_000)])
def test_wide_probe_kernels_match_plain(cuda, k, m):
    """K7 unweighted and weighted, K8 found and rows, each wrapper given
    no directory (it builds one), around 6,144 / Q rows (the 48 KB a
    whole-table search staged) and past them."""
    codes, lengths = (t.to(cuda) for t in _batch(m, length=k + 40))
    codes = torch.cat([codes, codes[:700]])
    lengths = torch.cat([lengths, lengths[:700]])
    flat = extract.extract_canonical_wide(codes, lengths, k).flatten(0, 1)
    table = _wide_table_for(flat, m, k, cuda)
    ref = dev.small_table_tally_wide(table, flat)
    kernels = ("probe_tally_wide", "probe_tally_wide_weighted",
               "probe_member_wide")
    counts = _launches(*kernels)
    acc = torch.full((table.shape[0],), 5, dtype=torch.int64, device=cuda)
    probe.probe_tally_wide(flat, table, acc)
    keys, weights = dev.dedup_windows_wide(flat)
    acc_w = torch.full_like(acc, 3)
    probe.probe_tally_wide(keys, table, acc_w, weights)
    found = member.probe_member_wide(flat, table)
    rows = member.probe_rows_wide(flat, table)
    torch.cuda.synchronize()
    assert _launches(*kernels) == (counts[0] + 1, counts[1] + 1,
                                   counts[2] + 2)
    assert torch.equal(acc, ref + 5) and torch.equal(acc_w, ref + 3)
    assert m == 1 or int(ref.max()) > 1  # duplicated reads
    assert torch.equal(found, dev.member_wide(table, flat))
    assert torch.equal(rows, dev.find_rows_wide(table, flat))
    assert bool(found.any()) and not bool(found.all())


# ── K7 and K8 through the prefix directory over limb 0 ────────────────


def _wide_dir_cases():
    """(kind, k) at Q = 2, 3 and 7: the CPU model's small tables, its
    limb-0-tie table and the directory's bits edge."""
    return [(kind, k) for k in (33, 63, 201)
            for kind in ("1", "2", "all-sentinel", "trailing-sentinels",
                         "limb-0-tie") + tuple(str(m) for m in BITS_EDGE)]


WIDE_DIR_CASES = _wide_dir_cases()


@pytest.mark.parametrize("kind,k", WIDE_DIR_CASES)
def test_wide_directory_kernel_matches_plain(cuda, kind, k):
    """``kdf_build_directory`` over limb 0 of an (M, Q) table (row stride
    Q) equals the plain version."""
    table = torch.from_numpy(make_table_wide(kind, k)).to(cuda)
    before = _launches("build_directory")
    got = tdir.build_directory(table)
    ref = tdir.build_directory(table.cpu())
    torch.cuda.synchronize()
    assert _launches("build_directory") == before + 1
    assert (got.bits, got.shift, got.live) == (ref.bits, ref.shift, ref.live)
    assert torch.equal(got.offsets.cpu(), ref.offsets)


@pytest.mark.parametrize("kind,k", WIDE_DIR_CASES)
def test_wide_directory_probes_match_plain(cuda, kind, k):
    """K7 unweighted and weighted and K8 (found, rows) through the
    directory, prebuilt and built by the wrapper, on the model's queries
    with repeated rows and on an unaligned view of them, equal their
    plain versions at Q = 2, 3, 7."""
    table_np = make_table_wide(kind, k)
    table = torch.from_numpy(table_np).to(cuda)
    live_np = table_np[table_np[:, 0] != keys64.SENTINEL]
    q_np = np.concatenate([queries_wide(table_np, k),
                           np.repeat(live_np[:100], 40, axis=0)])
    q = torch.from_numpy(q_np).to(cuda)
    uniq, weights = dev.dedup_windows_wide(q)
    ref_found = dev.member_wide(table, q)
    ref_rows = dev.find_rows_wide(table, q)
    ref_tally = dev.small_table_tally_wide(table, q)
    kernels = ("build_directory", "probe_member_wide", "probe_tally_wide",
               "probe_tally_wide_weighted")
    counts = _launches(*kernels)
    d = tdir.build_directory(table)
    found = member.probe_member_wide(q, table, d)
    rows = member.probe_rows_wide(q, table, d)
    found_own = member.probe_member_wide(q, table)
    acc = torch.full((table.shape[0],), 5, dtype=torch.int64, device=cuda)
    probe.probe_tally_wide(q, table, acc, directory=d)
    acc_own = torch.full_like(acc, 3)
    probe.probe_tally_wide(q, table, acc_own)
    acc_w = torch.zeros_like(acc)
    probe.probe_tally_wide(uniq, table, acc_w, weights, d)
    view = q[1:]
    found_view = member.probe_member_wide(view, table, d)
    rows_view = member.probe_rows_wide(view, table, d)
    acc_view = torch.zeros_like(acc)
    probe.probe_tally_wide(view, table, acc_view, directory=d)
    torch.cuda.synchronize()
    assert _launches(*kernels) == (
        counts[0] + 3, counts[1] + 5, counts[2] + 3, counts[3] + 1)
    assert torch.equal(found, ref_found) and torch.equal(found_own, ref_found)
    assert torch.equal(rows, ref_rows)
    assert torch.equal(acc, ref_tally + 5) and torch.equal(acc_own,
                                                           ref_tally + 3)
    assert torch.equal(acc_w, ref_tally)
    assert torch.equal(found_view, dev.member_wide(table, view))
    assert torch.equal(rows_view, dev.find_rows_wide(table, view))
    assert torch.equal(acc_view, dev.small_table_tally_wide(table, view))
    if d.live:
        assert bool(ref_found.any()) and int(ref_tally.max()) > 40


def test_wide_probes_refuse_another_tables_directory(cuda):
    """K7 and K8 given the directory of another (M, Q) table of the same
    shape, or of the table's own limb-0 column, raise before any
    launch."""
    table = torch.from_numpy(make_table_wide("4096", 63)).to(cuda)
    q = table[:100].clone()
    for foreign in (torch.from_numpy(make_table_wide("4096", 93)).to(cuda),
                    table[:, 0].contiguous()):
        d = tdir.build_directory(foreign)
        kernels = ("probe_member_wide", "probe_tally_wide",
                   "probe_tally_wide_weighted")
        counts = _launches(*kernels)
        acc = torch.zeros(table.shape[0], dtype=torch.int64, device=cuda)
        for call in (lambda: member.probe_member_wide(q, table, d),
                     lambda: member.probe_rows_wide(q, table, d),
                     lambda: probe.probe_tally_wide(q, table, acc,
                                                    directory=d),
                     lambda: probe.probe_tally_wide(
                         q, table, acc, torch.ones(100, dtype=torch.int64,
                                                   device=cuda), d)):
            with pytest.raises(ValueError, match="does not belong"):
                call()
        assert _launches(*kernels) == counts


def test_wide_index_builds_its_directory_once(cuda):
    """``KmerIndex`` at k = 63 on the card builds the directory over limb 0
    once, from its host copy, and its probes launch no other build."""
    k = 63
    table_np = make_table_wide("trailing-sentinels", k)
    index = eng.KmerIndex(keys64.limbs_to_words(torch.from_numpy(table_np),
                                                k), k, device=cuda)
    d = index.directory
    assert d is not None and d.table is index.table and d.live == 3000
    ref = tdir.build_directory(index.table.cpu())
    assert torch.equal(d.offsets.cpu(), ref.offsets)
    q = torch.from_numpy(queries_wide(table_np, k)).to(cuda)
    before = _launches("build_directory")
    found = steps.member(q, index)
    acc = torch.zeros(index.n, dtype=torch.int64, device=cuda)
    steps.tally(q, index, acc)
    torch.cuda.synchronize()
    assert _launches("build_directory") == before
    assert torch.equal(found, dev.member_wide(index.table, q))
    assert torch.equal(acc, dev.small_table_tally_wide(index.table, q))


def test_cuda_wide_probes_use_no_library_search(cuda, monkeypatch):
    """On the card the wide directory, K7 and K8 run no plain version."""
    table = torch.from_numpy(make_table_wide("4096", 63)).to(cuda)
    q = torch.from_numpy(queries_wide(table.cpu().numpy(), 63)).to(cuda)

    def refuse(*_args, **_kwargs):
        raise AssertionError("a plain version ran on the CUDA path")
    for name in ("member_wide", "find_rows_wide", "small_table_tally_wide",
                 "weighted_tally_wide", "unique_rows"):
        monkeypatch.setattr(dev, name, refuse)
    monkeypatch.setattr(tdir, "plain_directory", refuse)
    monkeypatch.setattr(torch, "searchsorted", refuse)
    member.probe_member_wide(q, table)
    member.probe_rows_wide(q, table)
    probe.probe_tally_wide(q, table, torch.zeros(table.shape[0],
                                                 dtype=torch.int64,
                                                 device=cuda))
    torch.cuda.synchronize()


def test_wide_engine_cuda_matches_cpu(cuda):
    """k = 63: both filter forms, the grouped scan and counts_of on the
    card equal the CPU."""
    k = 63
    codes, lengths = _batch(13, n=3000)
    win = dev.extract_canonical_windows_wide(codes, lengths, k)[0]
    flat = win.flatten(0, 1)
    live = dev.unique_rows(flat[flat[:, 0] != keys64.SENTINEL])[0]
    words = keys64.limbs_to_words(live[::5], k)
    counts_np = np.arange(words.shape[0], dtype=np.int64) + 1
    batches = [(codes[i:i + 1000].numpy(), lengths[i:i + 1000].numpy())
               for i in range(0, 3000, 1000)]
    queries = keys64.limbs_to_words(live[::2], k)
    results = []
    tracing.reset()
    for device in (cuda, torch.device("cpu")):
        plain = eng.make_filtered_counter(eng.KmerIndex(words, k,
                                                        device=device))
        dedup = eng.make_parent_filter_counter(words, k, device=device)
        for c, l in batches:
            plain.feed(c, l)
            dedup.feed(c, l)
        idx = eng.KmerIndex(words, k, counts_np, device=device)
        results.append((plain.result(), dedup.result(),
                        eng.scan_reads_for_hits_many(idx, batches),
                        idx.counts_of(queries)))
    (p0, d0, m0, c0), (p1, d1, m1, c1) = results
    assert _launches("seg_dedup_wide") >= 3  # the dedup form: K9dw
    assert np.array_equal(p0, p1) and np.array_equal(d0, d1)
    assert np.array_equal(p0, d0) and p0.sum() > 0
    assert all(np.array_equal(a, b) for a, b in zip(m0, m1))
    assert np.array_equal(c0, c1) and c0.any()


# ── segment-local sort and dedup: K9, K9d; K1's stage probes ──────────


def _segment_stream(seed, tail):
    """A stream of four full segments (random keys with sentinels, one
    key repeated, all sentinel, few distinct keys) and *tail* more rows,
    so the last segment is padded."""
    rng = np.random.default_rng(seed)
    seg = segsort.SEGMENT
    parts = [rng.integers(0, 4 ** 31, seg), np.full(seg, 12345),
             np.full(seg, keys64.SENTINEL), rng.integers(0, 40, seg),
             rng.integers(0, 4 ** 31, tail)]
    flat = np.concatenate(parts).astype(np.int64)
    flat[:seg][rng.random(seg) < 0.1] = keys64.SENTINEL
    return torch.from_numpy(flat)


@pytest.mark.parametrize("tail", [0, 1, 5000])
def test_seg_sort_kernel_matches_plain(cuda, tail):
    flat = _segment_stream(tail, tail).to(cuda)
    payload = torch.arange(flat.numel(), dtype=torch.int32, device=cuda)
    before = _launches("seg_sort")
    keys, pay = segsort.seg_sort(flat, payload)
    keys_only, none = segsort.seg_sort(flat)
    ref_keys, ref_pay = dev.segment_sort(
        segsort.segments(flat, keys64.SENTINEL), segsort.segments(payload, -1))
    torch.cuda.synchronize()
    assert _launches("seg_sort") == before + 2 and none is None
    assert keys.shape == (4 + (tail > 0), segsort.SEGMENT)
    assert torch.equal(keys, ref_keys) and torch.equal(keys_only, ref_keys)
    got, ref = pair_order(keys, pay), pair_order(ref_keys, ref_pay)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("tail", [0, 1, 5000])
def test_seg_dedup_kernel_matches_plain(cuda, tail):
    """K9d: every segment's count and live slots equal the plain
    version's, on random, one-key, all-sentinel and few-key segments, a
    40x-like one (~1,100 keys of ~7 copies: the hash), one of ~4,000 keys
    (past the hash's 3,072-key limit: a sort of all rows), and a ragged
    tail (no padded copy)."""
    rng = np.random.default_rng(tail)
    seg = segsort.SEGMENT
    extra = torch.from_numpy(np.concatenate([
        rng.choice(rng.integers(0, 4 ** 31, 1100), seg),
        rng.choice(rng.integers(0, 4 ** 31, 5000), seg)]))
    flat = torch.cat([_segment_stream(tail + 1, 0), extra,
                      _segment_stream(tail + 2, tail)[4 * seg:]]).to(cuda)
    before = _launches("seg_dedup")
    keys, weights, counts = segsort.seg_dedup(flat)
    ref = dev.segment_runs(segsort.segments(flat, keys64.SENTINEL))
    torch.cuda.synchronize()
    assert _launches("seg_dedup") == before + 1
    assert keys.shape == (6 + (tail > 0), seg)
    assert torch.equal(counts, ref[2])
    assert counts[1] == 1 and counts[2] == 0  # all equal, all sentinel
    assert 1000 < int(counts[4]) <= 1100 and int(counts[5]) > 3072
    for got, want in zip(dev.segment_compact(keys, weights, counts),
                         dev.segment_compact(*ref)):
        assert torch.equal(got, want)
    cpu = segsort.seg_dedup(flat.cpu())
    assert torch.equal(counts.cpu(), cpu[2])


def test_seg_sort_kernel_keeps_every_payload(cuda):
    """K9 with a payload on segments of few distinct keys and a random
    int32 payload with repeats: every (key, payload) pair lands once."""
    rng = np.random.default_rng(5)
    n = 3 * segsort.SEGMENT + 999
    flat = torch.from_numpy(rng.integers(0, 6, n).astype(np.int64)).to(cuda)
    payload = torch.from_numpy(
        rng.integers(-50, 50, n).astype(np.int32)).to(cuda)
    keys, pay = segsort.seg_sort(flat, payload)
    ref_keys, ref_pay = dev.segment_sort(
        segsort.segments(flat, keys64.SENTINEL), segsort.segments(payload, -1))
    torch.cuda.synchronize()
    assert torch.equal(keys, ref_keys)
    got, ref = pair_order(keys, pay), pair_order(ref_keys, ref_pay)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_cuda_segsort_never_takes_the_plain_path(cuda, monkeypatch):
    def plain(*_args):
        raise AssertionError("a CUDA tensor reached the plain path")
    for name in ("segment_sort", "segment_runs", "segment_runs_wide",
                 "segment_compact", "weighted_tally", "weighted_tally_wide"):
        monkeypatch.setattr(dev, name, plain)
    flat = _segment_stream(3, 17).to(cuda)
    segsort.seg_sort(flat)
    keys, weights, counts = segsort.seg_dedup(flat)
    table = torch.unique(flat)
    probe.probe_tally_weighted(keys, weights, table, torch.zeros_like(table),
                               counts=counts)
    rows = _wide_segment_stream(3, 3, 17).to(cuda)
    keys, weights, counts = segsort.seg_dedup_wide(rows)
    table = keys[0, :100].contiguous()
    probe.probe_tally_wide(keys, table, torch.zeros(100, dtype=torch.int64,
                                                    device=cuda),
                           weights, counts=counts)
    torch.cuda.synchronize()


# ── K9dw, the wide segment dedup, and K7 on its slots ─────────────────


def _wide_segment_stream(seed, q, tail):
    """(N, Q) limb rows in whole segments that the kernel's hash takes
    (0: 40x-like with sentinels; 1: ~3,900 distinct rows; 2: limb-0 ties
    of 4 rows that differ only in their last limb; 3: one row repeated)
    and that it gives up on (4: random rows; 5: ~7,250 distinct rows all
    tied on limb 0; 6-8: 512 random rows, then limb-0 ties of
    duplicates, one row repeated, or 40 rows on one limb 0; 9: past
    6,144 distinct rows), 10: all sentinel, and *tail* random rows, so
    the last segment is ragged.  Segments 1, 2 and 9 draw their first
    512 rows from a few rows, as consecutive reads repeat theirs."""
    rng = np.random.default_rng(seed)
    seg = segsort.SEGMENT
    head = 512

    def pool(n, limb0=None):
        rows = rng.integers(0, 1 << 62, (n, q))
        if limb0 is not None:
            rows[:, 0] = limb0
        return rows

    def draw(rows, n=seg, first=None):
        """n rows of *rows*, the first 512 of them from rows[:first]."""
        out = rows[rng.integers(0, rows.shape[0], n)]
        if first is not None:
            out[:head] = rows[rng.integers(0, first, head)]
        return out

    ties = np.repeat(pool(1000), 4, axis=0)
    ties[:, -1] = rng.integers(0, 1 << 62, ties.shape[0])
    pairs = np.repeat(pool(500), 2, axis=0)
    pairs[1::2, 1:] = rng.integers(0, 1 << 62, (500, q - 1))
    parts = [
        draw(pool(1100)),
        draw(pool(5000), first=100),
        draw(ties, first=400),
        np.repeat(pool(1), seg, axis=0),
        pool(seg),
        draw(pool(4 * seg, limb0=7)),
        np.concatenate([pool(head), draw(pairs, seg - head)]),
        np.concatenate([pool(head), np.repeat(pool(1), seg - head, axis=0)]),
        np.concatenate([pool(head), draw(pool(40, limb0=5), seg - head)]),
        np.concatenate([draw(pool(100), head), pool(seg - head)]),
        np.full((seg, q), keys64.SENTINEL),
        pool(tail),
    ]
    flat = np.concatenate(parts).astype(np.int64)
    flat[:seg][rng.random(seg) < 0.05] = keys64.SENTINEL
    return torch.from_numpy(flat)


@pytest.mark.parametrize("q", [2, 3, 7])
@pytest.mark.parametrize("tail", [0, 5000])
def test_seg_dedup_wide_kernel_matches_plain(cuda, q, tail):
    """K9dw: every segment's count and live slots equal the plain
    version's, on the hash's segments and on those it gives up on."""
    flat = _wide_segment_stream(q + tail, q, tail).to(cuda)
    before = _launches("seg_dedup_wide")
    keys, weights, counts = segsort.seg_dedup_wide(flat)
    ref = dev.segment_runs_wide(segsort.segments(flat, keys64.SENTINEL))
    torch.cuda.synchronize()
    assert _launches("seg_dedup_wide") == before + 1
    assert keys.shape == (11 + (tail > 0), segsort.SEGMENT, q)
    assert torch.equal(counts, ref[2])
    assert counts[3] == 1 and counts[7] == 513 and counts[10] == 0
    assert int(counts[5]) > 6144 and int(counts[9]) > 6144
    for got, want in zip(dev.segment_compact(keys, weights, counts),
                         dev.segment_compact(*ref)):
        assert torch.equal(got, want)
    cpu = segsort.seg_dedup_wide(flat.cpu())
    assert torch.equal(counts.cpu(), cpu[2])


# ── K9d and K9dw unordered: the parent filter's form ──────────────────


def _order_reads(order, k, seed, n=4096):
    """Host (codes, lengths) of *n* reads of 152 bp (256 past k = 151):
    "name" reads from random places of a 4 Mbp genome (as a name-sorted
    batch: hardly a window repeats, so every segment's hash gives up),
    "40x" consecutive reads at 40x coverage, sorted by place (the hash
    keeps every segment), and "mixed" the two in turns of three
    segments' reads; with N bases and ragged lengths."""
    length = 152 if k < 152 else 256
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 4 << 20, dtype=np.uint8)
    span = n * length // 40
    near = np.sort(rng.integers(0, span, n))
    far = rng.integers(0, genome.size - length, n)
    if order == "name":
        starts = far
    elif order == "40x":
        starts = near
    else:
        turn = 3 * -(-segsort.SEGMENT // (length - k + 1))
        starts = np.where(np.arange(n) // turn % 2 == 0, near, far)
    codes = genome[starts[:, None] + np.arange(length)]
    codes[rng.random((n, length)) < 0.002] = 4
    lengths = np.full(n, length, np.int32)
    lengths[::9] = rng.integers(0, length + 1, len(lengths[::9]))
    return codes, lengths


def _segment_sums(keys, weights, counts):
    """Every segment's live slots merged: sorted (segment, key limbs)
    rows and each row's weight sum."""
    seg = segsort.SEGMENT
    live = (torch.arange(seg, device=keys.device)[None, :]
            < counts[:, None].long())
    segs = torch.arange(counts.shape[0], device=keys.device)[:, None]
    rows = keys[live].reshape(int(live.sum()), -1)
    rows = torch.cat([segs.expand(-1, seg)[live][:, None], rows], 1)
    uniq, inverse = torch.unique(rows, dim=0, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=torch.int64, device=keys.device)
    return uniq, sums.index_add_(0, inverse, weights[live])


@pytest.mark.parametrize("order", ["name", "40x", "mixed"])
@pytest.mark.parametrize("k", [31, 63, 201])
def test_unordered_dedup_kernels_match_the_ordered(cuda, k, order):
    """K9d (K9dw) unordered against ordered on one batch's windows: each
    segment's weights sum key by key to the same multiplicities; a
    name-order batch's segments are all passed through (every live key in
    row order, of weight 1), a 40x batch's none, a mixed batch's some;
    the kernel launches once a call."""
    codes, lengths = _order_reads(order, k, seed=k)
    codes = torch.from_numpy(codes).to(cuda)
    lengths = torch.from_numpy(lengths).to(cuda)
    narrow = k <= keys64.NARROW_K
    flat = (extract.extract_canonical(codes, lengths, k).reshape(-1)
            if narrow else
            extract.extract_canonical_wide(codes, lengths, k).flatten(0, 1))
    dedup = segsort.seg_dedup if narrow else segsort.seg_dedup_wide
    name = "seg_dedup" if narrow else "seg_dedup_wide"
    before = _launches(name)
    keys, weights, counts, passed = dedup(flat, ordered=False)
    ordered = dedup(flat)
    torch.cuda.synchronize()
    assert _launches(name) == before + 2
    for got, want in zip(_segment_sums(keys, weights, counts),
                         _segment_sums(*ordered)):
        assert torch.equal(got, want)
    n_seg = counts.shape[0]
    assert passed.dtype == torch.int32 and passed.shape == (n_seg,)
    assert set(passed.tolist()) <= {0, 1}
    n_passed = int(passed.sum())
    if order == "name":
        assert n_passed == n_seg
    elif order == "40x":
        assert n_passed == 0
        assert torch.equal(counts, ordered[2])
    else:
        assert 0 < n_passed < n_seg
    live = flat[flat != keys64.SENTINEL] if narrow else (
        flat[flat[:, 0] != keys64.SENTINEL])
    assert int(weights[torch.arange(segsort.SEGMENT, device=cuda)[None, :]
                       < counts[:, None].long()].sum()) == live.shape[0]
    seg = segsort.SEGMENT
    for s in range(n_seg):
        c = int(counts[s])
        if passed[s]:  # every live key in row order, of weight 1
            part = flat[s * seg:(s + 1) * seg]
            live_keys = (part != keys64.SENTINEL) if narrow else (
                part[:, 0] != keys64.SENTINEL)
            assert torch.equal(keys[s, :c], part[live_keys])
            assert bool((weights[s, :c] == 1).all())


@pytest.mark.parametrize("order", ["name", "40x"])
@pytest.mark.parametrize("k", [31, 63])
def test_unordered_filter_matches_the_plain_form_and_the_oracle(
        cuda, k, order):
    """``FilteredCounter``'s dedup form (K9d / K9dw unordered) on a card,
    eagerly and through its CUDA graphs (three batches a slot of one
    shape), against its plain form on the card and a count of every
    window's key in the table on the host; with tracing on, every segment
    of a name-order batch is passed through and none of a 40x batch."""
    batches = [_order_reads(order, k, seed=k + i) for i in range(3)]
    feeds = batches * staging.SLOTS  # eager, captured, replayed
    keys = []
    for codes, lengths in batches:
        win = steps.window_keys(codes, lengths, k, torch.device("cpu"))
        keys.append(win.flatten(0, 1) if win.dim() == 3 else win.reshape(-1))
    flat = torch.cat(keys)
    narrow = flat.dim() == 1
    live = flat[flat != keys64.SENTINEL] if narrow else (
        flat[flat[:, 0] != keys64.SENTINEL])
    table = torch.unique(live, dim=0)[::3]
    words = (keys64.keys64_to_words(table, k) if narrow
             else keys64.limbs_to_words(table, k))
    # the oracle: each table key's count over every window fed, by the
    # plain tally of the host index's rows
    host = eng.KmerIndex(words, k, device="cpu")
    tally = dev.small_table_tally if narrow else dev.small_table_tally_wide
    want = tally(host.table, live).numpy() * staging.SLOTS
    results = {}
    tracing.enable()
    try:
        for dedup in (True, False):
            tracing.reset()
            fc = eng.FilteredCounter(eng.KmerIndex(words, k, device=cuda),
                                     dedup=dedup)
            for codes, lengths in feeds:
                fc.feed(codes, lengths)
            results[dedup] = fc.result()
            counters = tracing.collect()["counters"]
            if dedup:
                graphs = [h for h in fc._graphs._held.values()
                          if h is not None]
                assert len(graphs) == staging.SLOTS
                segments = counters["filter.segments"]
                assert segments > 0
                assert counters["filter.passed_segments"] == (
                    segments if order == "name" else 0)
    finally:
        tracing.disable()
        tracing.reset()
    assert np.array_equal(results[True], results[False])
    assert np.array_equal(results[True], want) and want.sum() > 0


def test_sort_count_keeps_the_ordered_dedup(cuda):
    """K12 merges K9d's (K9dw's) sorted segments: on a name-order batch,
    whose every segment the unordered form would pass through, its keys
    stay strictly ascending and equal the plain version's."""
    from kmer_denovo_filter_tpu_torch.ops import sortcount
    for k in (31, 63):
        codes, lengths = (torch.from_numpy(a).to(cuda)
                          for a in _order_reads("name", k, seed=3))
        if k <= keys64.NARROW_K:
            flat = extract.extract_canonical(codes, lengths, k).reshape(-1)
            keys, counts = sortcount.sort_count(flat, k)
            assert bool((keys[1:] > keys[:-1]).all())
            plain = dev.sort_count(flat)
        else:
            flat = extract.extract_canonical_wide(codes, lengths,
                                                  k).flatten(0, 1)
            keys, counts = sortcount.sort_count_wide(flat, k)
            assert torch.equal(keys, dev.unique_rows(keys)[0])
            plain = dev.sort_count_wide(flat)
        assert keys.shape[0] > 250_000
        assert torch.equal(keys, plain[0]) and torch.equal(counts, plain[1])


def test_seg_dedup_wide_rejects_bad_tensors(cuda):
    rows = _wide_segment_stream(1, 3, 0)[:1000].to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        segsort.seg_dedup_wide(rows.t().contiguous().t())
    with pytest.raises(ValueError, match="int64"):
        segsort.seg_dedup_wide(rows.to(torch.int32))
    with pytest.raises(ValueError, match="Q in"):
        segsort.seg_dedup_wide(rows[:, :1].contiguous())
    keys, weights, counts = segsort.seg_dedup_wide(rows)
    table = dev.unique_rows(rows)[0]
    acc = torch.zeros(table.shape[0], dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        probe.probe_tally_wide(torch.cat([keys, keys], 2)[..., :3], table,
                               acc, weights, counts=counts)
    with pytest.raises(ValueError, match="int32"):
        probe.probe_tally_wide(keys, table, acc, weights,
                               counts=counts.long())


@pytest.mark.parametrize("kind,k", [("4096", 63), ("limb-0-tie", 63),
                                    ("trailing-sentinels", 201)])
def test_wide_probe_on_slots_matches_plain(cuda, kind, k):
    """K7 weighted on K9dw's slots: rows of a 40x-like stream with stale
    slots past each count; equal to the plain version (compaction +
    weighted_tally_wide) and to K7 on the flat whole-batch dedup."""
    table = torch.from_numpy(make_table_wide(kind, k)).to(cuda)
    rng = np.random.default_rng(k)
    live = table[table[:, 0] != keys64.SENTINEL].cpu().numpy()
    rand = np.stack([rng.integers(0, 4 ** nb, 4000)
                     for nb in keys64.limb_bases(k)], 1)
    pool = np.concatenate([live, rand])
    flat = torch.from_numpy(np.concatenate([
        pool[rng.integers(0, pool.shape[0], 3 * segsort.SEGMENT + 777)],
        np.full((300, table.shape[1]), keys64.SENTINEL)])).to(cuda)
    keys, weights, counts = segsort.seg_dedup_wide(flat)
    d = tdir.build_directory(table)
    acc = torch.full((table.shape[0],), 5, dtype=torch.int64, device=cuda)
    before = _launches("probe_tally_wide_weighted")
    probe.probe_tally_wide(keys, table, acc, weights, d, counts)
    ref = 5 + dev.small_table_tally_wide(table, flat)
    uniq, uniq_weights = dev.dedup_windows_wide(flat)
    flat_acc = probe.probe_tally_wide(uniq, table, torch.full_like(acc, 5),
                                      uniq_weights, d)
    torch.cuda.synchronize()
    assert _launches("probe_tally_wide_weighted") == before + 2
    assert torch.equal(acc, ref) and torch.equal(flat_acc, ref)
    plain = dev.weighted_tally_wide(table, *dev.segment_compact(
        keys, weights, counts), torch.full_like(acc, 5))
    assert torch.equal(acc, plain) and int(ref.sum()) > 5 * acc.numel()


def test_wide_probe_skips_stale_slots(cuda):
    """Slots past each segment's count hold table rows; K7 never reads
    them.  Counts 0, 8,192, 1 and 4,095."""
    seg = segsort.SEGMENT
    table = torch.stack([torch.arange(0, 3 * 4 * seg, 3),
                         torch.arange(4 * seg)], 1).to(cuda)
    keys = table.reshape(4, seg, 2).clone()
    weights = torch.full((4, seg), 2, dtype=torch.int64, device=cuda)
    counts = torch.tensor([0, seg, 1, 4095], dtype=torch.int32, device=cuda)
    acc = torch.zeros(4 * seg, dtype=torch.int64, device=cuda)
    probe.probe_tally_wide(keys, table, acc, weights, counts=counts)
    want = dev.weighted_tally_wide(table, *dev.segment_compact(
        keys, weights, counts), torch.zeros_like(acc))
    torch.cuda.synchronize()
    assert torch.equal(acc, want) and int(acc.sum()) == 2 * (seg + 4096)


@pytest.mark.parametrize("k", [63, 201])
def test_wide_segment_step_makes_no_host_sync(cuda, k):
    """K1w -> K9dw -> K7 on the slots, from the codes on the card to the
    accumulator, with CUDA sync debugging set to raise."""
    codes, lengths = (t.to(cuda) for t in _batch(29, n=4096, length=k + 60))
    codes = torch.cat([codes, codes[:2000]])
    lengths = torch.cat([lengths, lengths[:2000]])
    flat = extract.extract_canonical_wide(codes, lengths, k).flatten(0, 1)
    table = _wide_table_for(flat, 4096, k, cuda)
    d = tdir.build_directory(table)
    acc = torch.zeros(table.shape[0], dtype=torch.int64, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flat = extract.extract_canonical_wide(codes, lengths,
                                              k).flatten(0, 1)
        keys, weights, counts = segsort.seg_dedup_wide(flat)
        probe.probe_tally_wide(keys, table, acc, weights, d, counts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ref = dev.small_table_tally_wide(table, flat)
    assert torch.equal(acc, ref) and int(ref.max()) > 1


@pytest.mark.parametrize("kind", TABLES + ("2**20",))
def test_weighted_probe_on_slots_matches_plain(cuda, kind):
    """K3 through the directory on K9d's slots: rows of a 40x-like
    stream, stale slots past each count, a key in every segment; equal
    to the plain version (compaction + weighted_tally) and to K3 on the
    flat whole-batch dedup."""
    table = _directory_table(kind, 31, cuda)
    rng = np.random.default_rng(len(kind))
    live = table[table != keys64.SENTINEL].cpu().numpy()
    pool = np.concatenate([live, rng.integers(0, 4 ** 31, 4000)])
    flat = torch.from_numpy(np.concatenate([
        rng.choice(pool, 3 * segsort.SEGMENT + 777),
        np.full(300, keys64.SENTINEL)])).to(cuda)
    keys, weights, counts = segsort.seg_dedup(flat)
    d = tdir.build_directory(table)
    acc = torch.full_like(table, 5)
    before = _launches("probe_tally_weighted")
    probe.probe_tally_weighted(keys, weights, table, acc, d, counts)
    ref = 5 + dev.small_table_tally(table, flat)
    flat_acc = probe.probe_tally_weighted(*dev.dedup_windows(flat), table,
                                          torch.full_like(table, 5), d)
    torch.cuda.synchronize()
    assert _launches("probe_tally_weighted") == before + 2
    assert torch.equal(acc, ref) and torch.equal(flat_acc, ref)
    plain = dev.weighted_tally(table, *dev.segment_compact(
        keys, weights, counts), torch.full_like(table, 5))
    assert torch.equal(acc, plain)


def test_weighted_probe_skips_stale_slots(cuda):
    """Slots past each row's count hold table keys; K3 never reads them.
    Counts 0, 8,192, 1 and 4,095."""
    seg = segsort.SEGMENT
    table = torch.arange(0, 3 * 4 * seg, 3, dtype=torch.int64, device=cuda)
    keys = table[:4 * seg].reshape(4, seg).clone()
    weights = torch.full_like(keys, 2)
    counts = torch.tensor([0, seg, 1, 4095], dtype=torch.int32, device=cuda)
    acc = torch.zeros_like(table)
    probe.probe_tally_weighted(keys, weights, table, acc, counts=counts)
    want = dev.weighted_tally(table, *dev.segment_compact(
        keys, weights, counts), torch.zeros_like(table))
    torch.cuda.synchronize()
    assert torch.equal(acc, want) and int(acc.sum()) == 2 * (seg + 4096)


def test_weighted_probe_builds_or_checks_its_directory(cuda):
    """K3 without a directory builds one (a counted launch); given
    another table's, it raises before any launch."""
    table = _directory_table("4096", 31, cuda)
    keys, weights = dev.dedup_windows(table[::3].repeat(3))
    acc = torch.zeros_like(table)
    before = _launches("build_directory", "probe_tally_weighted")
    probe.probe_tally_weighted(keys, weights, table, acc)
    torch.cuda.synchronize()
    assert _launches("build_directory", "probe_tally_weighted") == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(acc, dev.small_table_tally(table,
                                                  table[::3].repeat(3)))
    other = tdir.build_directory(
        torch.from_numpy(make_table("4096", 21)).to(cuda))
    with pytest.raises(ValueError, match="does not belong"):
        probe.probe_tally_weighted(keys, weights, table, acc, other)
    assert _launches("probe_tally_weighted") == before[1] + 1


def test_segment_step_makes_no_host_sync(cuda):
    """K9d -> K3 on the slots, from K1's keys on the card to the
    accumulator, with CUDA sync debugging set to raise."""
    codes, lengths = (t.to(cuda) for t in _batch(23, n=4096))
    table = _table_for(
        extract.extract_canonical(codes, lengths, 31).reshape(-1), 4096,
        cuda)
    d = tdir.build_directory(table)
    acc = torch.zeros_like(table)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flat = extract.extract_canonical(codes, lengths, 31).reshape(-1)
        keys, weights, counts = segsort.seg_dedup(flat)
        probe.probe_tally_weighted(keys, weights, table, acc, d, counts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(acc, dev.small_table_tally(table, flat))


def test_segment_counter_cuda_matches_cpu(cuda):
    from kmer_denovo_filter_tpu_torch.experiments.x_join_variants import (
        SegmentDedupCounter,
    )
    codes, lengths = _batch(17, n=3000)
    keys = dev.extract_canonical_windows(codes, lengths, 31)[0]
    live = torch.unique(keys[keys != keys64.SENTINEL])[::4]
    words = keys64.keys64_to_words(live, 31)
    before = _launches("seg_dedup")
    results = []
    for device in (cuda, torch.device("cpu")):
        fc = SegmentDedupCounter(eng.KmerIndex(words, 31, device=device))
        fc.feed(codes.numpy(), lengths.numpy())
        fc.feed(codes[:1000].numpy(), lengths[:1000].numpy())
        results.append(fc.result())
    assert _launches("seg_dedup") == before + 2
    assert np.array_equal(results[0], results[1]) and results[0].max() > 1


@pytest.mark.parametrize("stage", range(6))
def test_extract_stage_kernel_matches_plain(cuda, stage):
    """Every stage probe launches and counts once; stage 5, the only one
    compared with anything, equals the plain K1."""
    codes, lengths = (t.to(cuda) for t in _batch(stage + 40))
    before, k1_before = _launches("extract_canonical_stage",
                                  "extract_canonical")
    got = extract.extract_canonical_stage(codes, lengths, 31, stage)
    torch.cuda.synchronize()
    assert _launches("extract_canonical_stage") == before + 1
    assert _launches("extract_canonical") == k1_before
    assert got.shape == (codes.shape[0], codes.shape[1] - 30)
    if stage == 5:
        ref = dev.extract_canonical_windows(codes, lengths, 31)[0]
        assert torch.equal(got, ref)


# ── the sharded engine on one card: the mesh [cuda:0] * S ─────────────


def _sharded_case(k, seed, n_reads=512, length=152):
    """(table words, host codes, host lengths): the distinct keys of the
    first 64 reads plus random keys, and *n_reads* reads with N bases."""
    codes, lengths = (t.numpy() for t in _batch(seed, n_reads, length))
    win = steps.window_keys(codes[:64], lengths[:64], k, torch.device("cpu"))
    flat = win.flatten(0, 1)
    if flat.dim() == 1:
        keys = torch.unique(flat[flat != keys64.SENTINEL])
        words = keys64.keys64_to_words(keys, k)
    else:
        keys = torch.unique(flat[flat[:, 0] != keys64.SENTINEL], dim=0)
        words = keys64.limbs_to_words(keys, k)
    return words, codes, lengths


def test_owner_hash_equal_on_cpu_and_card(cuda):
    from kmer_denovo_filter_tpu_torch.ops.route import hash_owner
    gen = torch.Generator().manual_seed(0)
    for q in (1, 3, 7):
        keys = torch.randint(0, 1 << 62, (100_000, q), generator=gen)
        keys[::97] = keys64.SENTINEL
        flat = keys if q > 1 else keys[:, 0]
        for n in (2, 3, 4, 8):
            assert torch.equal(hash_owner(flat, n),
                               hash_owner(flat.to(cuda), n).cpu())


@pytest.mark.parametrize("s", [1, 3, 4])
def test_table_owners_on_the_card_equal_the_cpu_hash(cuda, s):
    """The sharded index routes each slice of its table on a card (K11,
    K10): each shard holds the rows the CPU hash of the whole table gives
    it, in table order, and the card sees whether the rows are in
    order."""
    from kmer_denovo_filter_tpu_torch.ops import encode as enc
    from kmer_denovo_filter_tpu_torch.ops.route import hash_owner
    from kmer_denovo_filter_tpu_torch.parallel.sharded import _route_table
    rng = np.random.default_rng(s)
    mesh = [torch.device("cuda", 0)] * s
    for k in (31, 63):
        w = enc.words_per_kmer(k)
        words = rng.integers(0, 1 << 32, (10_001, w), dtype=np.uint64)
        words = words.astype(np.uint32)
        words[:, -1] &= np.uint32((0xFFFFFFFF << (32 * w - 2 * k))
                                  & 0xFFFFFFFF)
        host = steps.key_tensor(words, k)
        owner = hash_owner(host, s).numpy()
        tables, rows, ordered = _route_table(words, k, mesh)
        assert not ordered
        for d in range(s):
            assert np.array_equal(rows[d], np.flatnonzero(owner == d))
            assert torch.equal(tables[d].cpu(),
                               host[torch.from_numpy(rows[d])])
        assert _route_table(words[enc.lexsort_keys(words)], k, mesh)[2]


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("k", [31, 63])
def test_sharded_engine_on_one_card_matches_one_device(cuda, k, s):
    """Phase 8 of chip_smoke.py at a small size: every sharded result
    equals the single-device one, and every shard launched its kernels."""
    from kmer_denovo_filter_tpu_torch.parallel import (
        ShardedFilteredCounter,
        ShardedKmerIndex,
        sharded_count,
        sharded_scan_reads_for_hits,
    )
    words, codes, lengths = _sharded_case(k, 200 + k)
    mesh = [torch.device("cuda", 0)] * s
    index = eng.KmerIndex(words, k, device=cuda)
    name = "probe_tally" if k <= keys64.NARROW_K else "probe_tally_wide"
    for dedup in (False, True):
        before = _launches(name)
        fc = ShardedFilteredCounter(words, k, mesh, dedup=dedup)
        fc.feed(codes, lengths)
        one = eng.FilteredCounter(index, dedup=dedup)
        one.feed(codes, lengths)
        assert np.array_equal(fc.result(), one.result())
        if not dedup:
            assert _launches(name) >= before + s
    q = words[::2]
    sharded = ShardedKmerIndex(words, k, mesh)
    assert np.array_equal(sharded.membership(q), index.membership(q))
    assert np.array_equal(sharded_scan_reads_for_hits(sharded, codes,
                                                      lengths),
                          eng.scan_reads_for_hits(index, codes, lengths))
    got_k, got_c = sharded_count(codes, lengths, k, mesh)
    sc = eng.StreamCounter(k, device=cuda)
    sc.feed(codes, lengths)
    want_k, want_c = sc.result()
    assert np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c)
    homopolymer = np.zeros((64, 80), np.uint8)
    fc = ShardedFilteredCounter(words, k, mesh)
    fc.feed(homopolymer, np.full(64, 80, np.int32))
    fc.feed(codes[:0], lengths[:0])
    one = eng.FilteredCounter(index)
    one.feed(homopolymer, np.full(64, 80, np.int32))
    assert np.array_equal(fc.result(), one.result())


# ── K10, the route, and K11, words to keys ───────────────────────────


def _route_rows(n, q, kind, seed):
    """(n,) keys (q = 1) or (n, q) limb rows on the CPU: random with every
    13th row a sentinel row, one key in every row, or all sentinels."""
    rng = np.random.default_rng(seed)
    if kind == "homopolymer":
        rows = np.full((n, q), 12345, np.int64)
    elif kind == "sentinel":
        rows = np.full((n, q), keys64.SENTINEL, np.int64)
    else:
        rows = rng.integers(0, 1 << 62, (n, q), dtype=np.int64)
        rows[::13] = keys64.SENTINEL
    keys = torch.from_numpy(rows)
    return keys[:, 0].contiguous() if q == 1 else keys


def _route_matches_plain(keys, s, sentinel=True):
    from kmer_denovo_filter_tpu_torch.ops import route
    before = _launches("route")
    got = route.route(keys, s, sentinel)
    ref = route.plain_route(keys.cpu(), s, sentinel)
    torch.cuda.synchronize()
    assert _launches("route") == before + 1
    for g, r in zip(got, ref):
        assert g.is_cuda and torch.equal(g.cpu(), r)


@pytest.mark.parametrize("kind", ["random", "homopolymer", "sentinel"])
@pytest.mark.parametrize("q", [1, 2, 3, 7])
@pytest.mark.parametrize("n", [0, 1, 4097, 8193, 100_000])
def test_route_kernel_matches_plain(cuda, n, q, kind):
    """K10 against its plain version: order, sizes and routed rows, to
    1 .. 1,023 shards (the histogram spans warps past 32 bins), with
    and without the sentinel bucket."""
    keys = _route_rows(n, q, kind, seed=n + q).to(cuda)
    for s in (1, 2, 3, 4, 7, 64, 1023):
        _route_matches_plain(keys, s)
    for s in (4, 1024):
        _route_matches_plain(keys, s, sentinel=False)


def test_route_kernel_takes_views_and_batch_keys(cuda):
    """A strided view, a gather of rows, and the flat K1 / K1w keys of a
    batch."""
    rows = _route_rows(20_000, 3, "random", seed=1).to(cuda)
    _route_matches_plain(rows[::2], 4)
    _route_matches_plain(rows[torch.arange(0, 20_000, 3, device=cuda)], 5)
    codes, lengths = (t.to(cuda) for t in _batch(7))
    _route_matches_plain(extract.extract_canonical(codes, lengths, 31)
                         .flatten(), 4)
    _route_matches_plain(extract.extract_canonical_wide(codes, lengths, 63)
                         .flatten(0, 1), 4)


def test_route_kernel_refuses_too_many_buckets(cuda):
    from kmer_denovo_filter_tpu_torch.ops import route
    keys = torch.zeros(10, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="buckets"):
        route.route(keys, route.MAX_BINS)


@pytest.mark.parametrize("k", list(range(3, keys64.MAX_K + 1, 2)))
def test_words_to_keys_kernel_matches_plain(cuda, k):
    """K11 against its plain version and the numpy conversion, with
    sentinel rows, from a view one word into its storage, and with no
    row (no launch)."""
    from kmer_denovo_filter_tpu_torch.ops import convert
    from kmer_denovo_filter_tpu_torch.ops import encode as enc
    rng = np.random.default_rng(k)
    w = enc.words_per_kmer(k)
    words = rng.integers(0, 1 << 32, (3001, w), dtype=np.uint64).astype(
        np.uint32)
    words[:, -1] &= np.uint32((0xFFFFFFFF << (32 * w - 2 * k)) & 0xFFFFFFFF)
    words[::5] = keys64.SENTINEL32
    on_card = convert.words_tensor(words).to(cuda)
    before = _launches("words_to_keys")
    got = convert.words_to_keys(on_card, k)
    torch.cuda.synchronize()
    assert _launches("words_to_keys") == before + 1
    assert torch.equal(got.cpu(), steps.key_tensor(words, k))
    assert torch.equal(got, convert.plain_words_to_keys(on_card, k))
    store = torch.empty(on_card.numel() + 1, dtype=torch.int32, device=cuda)
    view = store[1:].view(on_card.shape)
    view.copy_(on_card)
    assert torch.equal(convert.words_to_keys(view, k), got)
    assert convert.words_to_keys(on_card[:0], k).shape == got[:0].shape
    assert _launches("words_to_keys") == before + 2


def test_cuda_index_converts_its_words_on_the_card(cuda):
    """A CUDA KmerIndex and its queries launch K11; the sharded build
    launches K11 and K10 a slice, its queries K11 and K10 once."""
    from kmer_denovo_filter_tpu_torch.parallel import ShardedKmerIndex

    words, _codes, _lengths = _sharded_case(31, 5)
    ref = eng.KmerIndex(words, 31, device="cpu").membership(words[::3])
    before, routes = _launches("words_to_keys", "route")
    index = eng.KmerIndex(words, 31, device=cuda)
    assert np.array_equal(index.membership(words[::3]), ref)
    sharded = ShardedKmerIndex(words, 31, [torch.device("cuda", 0)] * 3)
    assert np.array_equal(sharded.membership(words[::3]), ref)
    assert _launches("words_to_keys") == before + 2 + 3 + 1
    assert _launches("route") == routes + 3 + 1


# ── K12, the stream count's sort-count ───────────────────────────────


def _sort_count_matches_plain(rows, k):
    """K12 on (n, Q) numpy rows at *k* against its plain version: one
    launch (none for no row), exact keys and counts."""
    from kmer_denovo_filter_tpu_torch.ops import sortcount
    from tests.test_torch_sort_count_model import as_tensor
    flat = as_tensor(rows)
    fn = sortcount.sort_count if flat.dim() == 1 else sortcount.sort_count_wide
    before = _launches("sort_count")
    got = fn(flat.cuda(), k)
    torch.cuda.synchronize()
    assert _launches("sort_count") == before + int(rows.shape[0] > 0)
    want = fn(flat, k)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("k", [15, 21, 31, 33, 63, 127, 201, 207])
def test_sort_count_kernel_matches_plain(cuda, k):
    """Every input of the CPU tests (reads, a duplicated batch, one key,
    no row, one row, all sentinels, all distinct, N = 8,191..8,193, a
    limb-0 tie; the merge tree's S = 1, 3, 5 and 9, a key in every
    segment, empty segments, one read repeated, a batch repeated) and a
    batch of 40 copies of 24 reads."""
    from tests.test_torch_sort_count_model import (
        cases,
        merge_cases,
        read_rows,
    )
    for label, rows in {**cases(k), **merge_cases(k)}.items():
        _sort_count_matches_plain(rows, k)
    _sort_count_matches_plain(read_rows(k, 3, copies=40), k)


@pytest.mark.parametrize("k", [31, 63, 201])
def test_sort_count_kernel_on_many_segments(cuda, k):
    """The merge tree at S = 2**7 + 1 and 2**9 (one key repeated, a key
    in every segment; 2**22 rows of 1,000 keys) and on 2**20 random
    keys (runs of ~7,400 rows, tiles inside one pair)."""
    from tests.test_torch_sort_count_model import random_rows
    q = keys64.limbs_per_kmer(k)
    _sort_count_matches_plain(np.full((128 * 8192 + 1, q), 5, np.int64), k)
    _sort_count_matches_plain(random_rows(1 << 22, k, 7, distinct=1000), k)
    _sort_count_matches_plain(random_rows(1 << 20, k, 8), k)


def test_sort_count_kernel_on_a_long_row(cuda):
    """The K1 / K1w keys of one (1, 2**20) row at k = 31 and 63."""
    rng = np.random.default_rng(5)
    row = torch.from_numpy(rng.integers(0, 4, (1, 1 << 20), dtype=np.uint8))
    length = torch.tensor([1 << 20], dtype=torch.int32)
    for k in (31, 63):
        win = (extract.extract_canonical(row.cuda(), length.cuda(), k)
               if k == 31 else extract.extract_canonical_wide(
                   row.cuda(), length.cuda(), k))
        _sort_count_matches_plain(win.reshape(-1, keys64.limbs_per_kmer(k))
                                  .cpu().numpy(), k)


def test_sort_count_syncs_once(cuda):
    """A K12 call makes one host sync: the read of its distinct count."""
    import warnings
    from kmer_denovo_filter_tpu_torch.ops import sortcount
    codes, lengths = (t.to(cuda) for t in _batch(11))
    flat = extract.extract_canonical(codes, lengths, 31).reshape(-1)
    wide = extract.extract_canonical_wide(codes, lengths, 63).flatten(0, 1)
    for run in (lambda: sortcount.sort_count(flat, 31),
                lambda: sortcount.sort_count_wide(wide, 63)):
        run()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in caught
                 if "called a synchronizing" in str(w.message)]
        assert len(syncs) == 1, [str(w.message) for w in caught]


def test_cuda_stream_counts_use_no_library_sort(cuda, monkeypatch):
    """StreamCounter.feed, the sharded count and the multi-host count
    (no group) launch K12 on the card and call no torch.unique,
    torch.sort or torch.argsort; their results equal the CPU's."""
    from kmer_denovo_filter_tpu_torch.parallel import multihost
    from kmer_denovo_filter_tpu_torch.parallel import sharded_count
    codes, lengths = (t.numpy() for t in _batch(13))
    want = {}
    for k in (31, 63):
        sc = eng.StreamCounter(k, device="cpu")
        sc.feed(codes, lengths)
        want[k] = sc.result()

    def refuse(*_args, **_kwargs):
        raise AssertionError("a library sort on the card path")

    for name in ("unique", "sort", "argsort"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for k in (31, 63):
        before = _launches("sort_count")
        sc = eng.StreamCounter(k, device=cuda)
        sc.feed(codes, lengths)
        got = sc.result()
        assert _launches("sort_count") == before + 1
        assert all(np.array_equal(g, w) for g, w in zip(got, want[k]))
        mesh = [torch.device("cuda", 0)] * 2
        got = sharded_count(codes, lengths, k, mesh)
        assert _launches("sort_count") == before + 3
        assert all(np.array_equal(g, w) for g, w in zip(got, want[k]))
        got = multihost.sharded_count_multihost(codes, lengths, k,
                                                device=cuda)
        assert _launches("sort_count") == before + 4
        assert all(np.array_equal(g, w) for g, w in zip(got, want[k]))
