"""Device k-mer engine of the port: counters, tables and the anchoring scan.

Counterparts of :mod:`kmer_denovo_filter_tpu.engine`:

* :class:`KmerIndex` (:90) — the sorted canonical k-mer table, held on
  the device as one int64 key (or one row of int64 limbs) per k-mer
  (:mod:`.ops.keys`), with its prefix directory on the card (over limb
  0 for k > 31; :mod:`.ops.directory`), and :meth:`~KmerIndex.membership` /
  :meth:`~KmerIndex.counts_of` through kernel K4 (``probe_member``) or
  K8 (``probe_member_wide``);
* :class:`HostKmerIndex` (:162) and :class:`HostFilteredCounter` (:623)
  — CPU-device tables over ``KDF_DEVICE_TABLE_BYTES``, answered by the
  host C++ hash or a numpy search (a table on a CUDA device never goes
  to the host);
* :func:`make_membership_index` (:300) — that gate, and the sharded
  index for a CUDA table one card cannot hold;
* :class:`StreamCounter` (:321) — ``jellyfish count -C``: K1 window keys,
  a device sort-count per batch (K12), host merge of the per-batch
  uniques;
* :class:`FilteredCounter` (:434) — ``jellyfish count -C --if``: a
  per-table-row tally, K1 → K2 (VCF mode, :func:`make_filtered_counter`)
  or K1 → K9d segment dedup → K3 (discovery,
  :func:`make_parent_filter_counter`);
* :func:`scan_reads_for_hits` / :func:`scan_reads_for_hits_many`
  (:706, :718) — the anchoring scan, K1 → K4.

Host-facing keys stay the JAX package's (M, W) uint32 words, so the
pipelines, ``.jf`` loading and ``.npz`` snapshots are shared; they
become int64 at this boundary (:mod:`.ops.keys`): one int64 per key for
k <= 31, a row of Q = ceil(k / 31) int64 limbs for k = 33..207.  For a
CUDA device the words go up as they are and kernel K11 converts them
there (:func:`.steps.key_tensor`, :mod:`.ops.convert`).  The
wide path runs K1w → K7 (tally, unweighted or weighted) and K1w → K8
(membership, rows) where the narrow one runs K1 → K2/K3 and K1 → K4;
:mod:`.steps` picks each kernel's wrapper from the key form.
The device is explicit: chosen at the entry point and passed to every
table and counter.  With two or more local CUDA devices the factories
below hand a table one card cannot hold, or every table under
``KDF_SHARDED=1``, to the sharded engine (:mod:`.parallel.sharded`,
:func:`_shard_dispatch`); a CPU entry point keeps one device.  The
counters' and the index's steps open the spans of :mod:`.tracing` (off,
a null context, unless tracing is on); :data:`.tracing.SPANS` lists them.

The reference's ``pad_read_batch`` (engine.py:70) has no counterpart:
it padded every batch to bound XLA's distinct compiled shapes, and the
CUDA kernels take any (B, L) without a recompile.  Nor do its overflow
ladders: the binary-search kernels have no capacity to overflow.  For
wide keys that also drops the cross-batch ``_wide_buf`` flush of the
reference's ``FilteredCounter`` (engine.py:519–521, :868–903), which
densified window-sparse batches for the ~40-row VMEM windows of its wide
tile joins: every batch goes to K7 as it comes.
"""

import logging
import os

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch import staging, steps, tracing
from kmer_denovo_filter_tpu_torch.htsio import native
from kmer_denovo_filter_tpu_torch.ops import directory as tdir
from kmer_denovo_filter_tpu_torch.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.convert import (
    words_tensor,
    words_to_keys,
)

logger = logging.getLogger(__name__)


def resolve_device(device):
    """*device* as a ``torch.device``; raises for CUDA on a host
    without it (there is no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() "
            "is False")
    return device


# the keys (a ring slot's buffers and a batch shape) a staged counter
# holds CUDA graphs for before it drops them all: two a slot
GRAPHS_KEPT = 2 * staging.SLOTS
_UNSEEN = object()


class KmerIndex:
    """Sorted canonical k-mer table on *device*, with optional counts.

    A table on a CUDA device also holds its prefix directory
    (:mod:`.ops.directory`; over limb 0 for k > 31), built here once for
    every K2 and K4 (K7 and K8) probe of the table; ``directory`` is None
    on the CPU."""

    def __init__(self, keys_np, k, counts_np=None, *, device, key_tensor=None):
        """*keys_np*: (M, W) uint32 sorted unique canonical keys;
        *key_tensor*: their :func:`.steps.key_tensor` form, when the caller
        holds it already."""
        keys64.check_k(k)
        self.k = k
        self.w = enc.words_per_kmer(k)
        self.n = keys_np.shape[0]
        self.keys_np = keys_np
        self.counts_np = counts_np
        self.device = resolve_device(device)
        with tracing.span("index.build"):
            # (M,) int64 keys, or (M, Q) limb rows for k > 31: on a card
            # made there from the words (K11, as in steps.key_tensor)
            if key_tensor is not None:
                self.table = key_tensor.to(self.device)
            elif self.device.type == "cuda":
                with tracing.span("index.upload"):
                    words = words_tensor(keys_np).to(self.device)
                with tracing.span("index.convert"):
                    self.table = words_to_keys(words, k)
            else:
                with tracing.span("index.convert"):
                    self.table = steps.key_tensor(keys_np, k)
            self.directory = None
            if self.device.type == "cuda":
                # live rows (sentinel rows trail) and the last live key
                # from the host words: no sync
                with tracing.span("index.directory"):
                    self.directory = tdir.build_directory(
                        self.table, *steps.live_rows(keys_np, k))

    @classmethod
    def from_strings(cls, kmers, k, *, device):
        """Build from canonical k-mer strings (order-independent)."""
        keys = enc.kmers_to_keys(list(kmers), k)
        uniq, _ = enc.unique_with_counts(keys)
        return cls(uniq, k, device=device)

    @classmethod
    def from_keys_counts(cls, keys_np, counts_np, k, *, device):
        return cls(keys_np, k, counts_np, device=device)

    def to_strings(self):
        return enc.keys_to_kmers(self.keys_np, self.k)

    def membership(self, query_keys_np):
        """bool array: which (N, W) query rows are in the table (K4, or
        K8 for k > 31); sentinel rows are never found."""
        q = steps.key_tensor(query_keys_np, self.k, self.device)
        return steps.member(q, self).cpu().numpy()

    def counts_of(self, query_keys_np):
        """int64 counts per query row (0 when absent): K4 (K8) finds each
        row's table row on the device, the host gathers its count."""
        if self.counts_np is None:
            raise ValueError("index has no counts")
        q = steps.key_tensor(query_keys_np, self.k, self.device)
        if self.n == 0:
            return np.zeros(q.shape[0], dtype=np.int64)
        rows = steps.rows(q, self).cpu().numpy()
        return np.where(rows >= 0, self.counts_np[np.maximum(rows, 0)], 0)


class HostKmerIndex:
    """Host-resident membership index for CPU-device tables over
    ``KDF_DEVICE_TABLE_BYTES``.

    The analog of the reference's mmap'd jellyfish index (reference
    kmer_utils.py:124–136): for k <= 31 probes run on the multithreaded
    C++ hash over the int64 keys, or a numpy searchsorted where the
    native library cannot be built; wider keys take a numpy searchsorted
    over the words' big-endian bytes, as the reference does for W != 2
    (engine.py:264–278).  Exposes the :class:`KmerIndex` subset the
    reference subtraction uses (``k``, ``n``, ``membership``,
    ``counts_of``).
    """

    def __init__(self, keys_np, k, counts_np=None):
        keys64.check_k(k)
        self.k = k
        self.w = enc.words_per_kmer(k)
        self.keys_np = np.ascontiguousarray(keys_np, np.uint32)
        self.counts_np = counts_np
        self.n = keys_np.shape[0]
        self._keys = self._searchable(self.keys_np)
        self._ht = (native.HostHashTable(self._keys.view(np.uint64))
                    if native.available() and k <= keys64.NARROW_K
                    else None)

    def _searchable(self, words):
        """(N,) keys that sort like the rows of (N, W) *words*: int64
        keys for k <= 31, else one big-endian byte string per row."""
        if self.k <= keys64.NARROW_K:
            return keys64.words_to_keys64(words, self.k).numpy()
        big = np.ascontiguousarray(np.asarray(words, np.uint32)
                                   .astype(">u4"))
        return big.view(f"S{4 * self.w}").ravel()

    def _locate(self, query_keys_np):
        q = self._searchable(query_keys_np)
        if self._ht is not None:
            found, pos = self._ht.member(q.view(np.uint64),
                                         want_index=True)
        elif self.n == 0:
            found = np.zeros(q.shape[0], dtype=bool)
            pos = np.zeros(q.shape[0], dtype=np.int64)
        else:
            pos = np.minimum(np.searchsorted(self._keys, q), self.n - 1)
            found = self._keys[pos] == q
        live = (np.asarray(query_keys_np) != keys64.SENTINEL32).any(axis=1)
        return found & live, pos

    def membership(self, query_keys_np):
        return self._locate(query_keys_np)[0]

    def counts_of(self, query_keys_np):
        if self.counts_np is None:
            raise ValueError("index has no counts")
        found, pos = self._locate(query_keys_np)
        return np.where(found, self.counts_np[pos] if self.n else 0, 0)


def _card_free(device):
    """Bytes CUDA *device* can still allocate (free, plus cached by
    PyTorch's allocator)."""
    return torch.cuda.mem_get_info(device)[0] + (
        torch.cuda.memory_reserved(device)
        - torch.cuda.memory_allocated(device))


def _check_card_holds(n_bytes, device, what):
    """Raise when CUDA *device* cannot allocate *n_bytes* for a table:
    a table on the card never goes to the host.  The factories call it
    only where the sharded engine cannot take the table instead."""
    free = _card_free(device)
    if n_bytes > free:
        raise RuntimeError(
            f"the {what} table needs {n_bytes / 2 ** 30:.2f} GB on "
            f"{device}, which has {free / 2 ** 30:.2f} GB free; a table "
            "larger than one card needs the sharded engine "
            "(parallel.ShardedKmerIndex), which takes 2 or more cards")


def _local_mesh(device):
    """The devices an entry point on *device* may shard a table over:
    every local CUDA device for a CUDA device in a single-process run;
    the one device otherwise (a CPU entry point, or one process of a
    multi-host run, which owns its one card)."""
    from kmer_denovo_filter_tpu_torch.parallel import multihost
    if device.type != "cuda" or multihost.active():
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _needs_shards(n_bytes, device):
    """True when a CUDA table of *n_bytes* does not fit *device* but 2 or
    more local cards can share it."""
    return (device.type == "cuda" and len(_local_mesh(device)) >= 2
            and n_bytes > _card_free(device))


def _shard_dispatch(device, n_bytes=0):
    """True when the sharded engine should serve a table of *n_bytes*
    for an entry point on *device*: ``KDF_SHARDED=0`` turns sharding
    off, ``KDF_SHARDED=1`` forces it over 2 or more devices
    (:func:`_local_mesh`), and otherwise only a table the card cannot
    hold shards.  The reference's automatic rule (above 2**20 keys,
    engine.py:1357) is not kept: on H100s the sharded feed ran 5-7x
    slower than one card's, whether its shards shared a card or sat on
    four (PERF.md, the sharded feed)."""
    mode = os.environ.get("KDF_SHARDED")
    if mode == "0" or len(_local_mesh(device)) < 2:
        return False
    return mode == "1" or _needs_shards(n_bytes, device)


def _host_resident(n, k, what):
    """True (and logged) when an n-key table on the CPU device exceeds
    ``KDF_DEVICE_TABLE_BYTES`` (the reference's budget, engine.py:299);
    the host then answers it."""
    budget = os.environ.get("KDF_DEVICE_TABLE_BYTES")
    n_bytes = _key_bytes(k) * n
    if budget is None or n_bytes <= int(budget):
        return False
    logger.info("  %s table %d keys (%.2f GB) exceeds "
                "KDF_DEVICE_TABLE_BYTES (%.2f GB) — host-resident", what, n,
                n_bytes / 2 ** 30, int(budget) / 2 ** 30)
    return True


def _key_bytes(k):
    """Device bytes of one key: 8 per int64 limb."""
    return 8 * keys64.limbs_per_kmer(k)


def _table_bytes(n, k):
    """Device bytes of an n-key table: its keys (a row of limbs for
    k > 31) and its prefix directory."""
    return _key_bytes(k) * n + tdir.directory_bytes(n)


def make_membership_index(keys_np, k, counts_np=None, *, device):
    """:class:`KmerIndex` on *device*.  On the CPU device a table over
    ``KDF_DEVICE_TABLE_BYTES`` becomes a :class:`HostKmerIndex`; on a
    CUDA device one the card cannot hold is sharded over the local cards
    (:class:`~.parallel.sharded.ShardedKmerIndex`, reference
    engine.py:303–326), or raises with one card."""
    device = resolve_device(device)
    n = keys_np.shape[0]
    if _needs_shards(_table_bytes(n, k), device):
        from kmer_denovo_filter_tpu_torch.parallel import ShardedKmerIndex
        mesh = _local_mesh(device)
        logger.info("  reference table %d keys exceeds %s — sharded "
                    "across %d devices", n, device, len(mesh))
        return ShardedKmerIndex(keys_np, k, mesh)
    if device.type == "cuda":
        _check_card_holds(_table_bytes(n, k), device, "reference")
    elif _host_resident(n, k, "reference"):
        return HostKmerIndex(keys_np, k, counts_np)
    return KmerIndex(keys_np, k, counts_np, device=device)


class StreamCounter:
    """Canonical k-mer counting over streamed (codes, lengths) batches.

    Each batch: K1 (K1w) window keys → K12 sort-count on the device
    (:mod:`.ops.sortcount`: K9d / K9dw, a merge of their sorted segments,
    one host sync) →
    host (keys, counts) chunk.  The chunks consolidate progressively
    exactly as in the reference (engine.py:358–389): whenever the pending
    chunks hold at least as many rows as the consolidated array (and at
    least ``KDF_MERGE_ROWS``), everything merges by
    ``enc.unique_with_counts`` — here over (N, Q) int64 limb rows (Q = 1
    for k <= 31), converted to words in :meth:`result`.
    """

    def __init__(self, k, *, device):
        keys64.check_k(k)
        self.k = k
        self.w = enc.words_per_kmer(k)
        self.device = resolve_device(device)
        self._chunks = []  # pending per-batch (unique (N, Q) keys, counts)
        self._pending_rows = 0
        self._merged = None  # consolidated (sorted keys, counts)
        self._merge_floor = int(os.environ.get(
            "KDF_MERGE_ROWS", 16 * 1024 * 1024))
        self.total_windows = 0

    def _consolidate(self):
        if not self._chunks:
            return
        if tracing.enabled():
            tracing.count("count.merges")
        with tracing.span("count.consolidate"):
            parts = self._chunks
            if self._merged is not None:
                parts = [self._merged] + parts
            all_keys = np.concatenate([c[0] for c in parts], axis=0)
            all_counts = np.concatenate([c[1] for c in parts], axis=0)
            self._merged = enc.unique_with_counts(all_keys,
                                                  weights=all_counts)
        self._chunks = []
        self._pending_rows = 0

    def feed(self, codes, lengths):
        win = steps.window_keys(codes, lengths, self.k, self.device)
        if win is None:
            return
        with tracing.span("count.sort"):
            uk, counts = steps.sort_count(win.flatten(0, 1), self.k)
        with tracing.span("count.dtoh"):
            uk, counts = uk.cpu().numpy(), counts.cpu().numpy()
        self.add_chunk(uk, counts)

    def add_chunk(self, uk, counts):
        """Queue one batch's sorted unique (N, Q) rows and counts, and
        consolidate when the pending rows call for it."""
        self._chunks.append((uk, counts))
        self._pending_rows += uk.shape[0]
        self.total_windows += int(counts.sum())
        merged_rows = (self._merged[0].shape[0]
                       if self._merged is not None else 0)
        if self._pending_rows >= max(self._merge_floor, merged_rows):
            self._consolidate()

    def feed_sequence(self, seq):
        """Count k-mers of one long sequence (reference contigs), in
        chunks of 2**20 bases overlapping by k - 1 so no window is lost
        (the reference's power-of-two padding of each chunk bounded
        XLA's compiled shapes and is not needed here)."""
        codes = enc.ASCII_TO_CODE[
            np.frombuffer(seq.upper().encode("ascii"), dtype=np.uint8)]
        chunk = 1 << 20
        k = self.k
        n = len(codes)
        if n < k:
            return
        step = chunk - (k - 1)
        for off in range(0, max(n - k + 1, 1), step):
            part = codes[off:off + chunk]
            self.feed(part[None, :], np.array([len(part)], dtype=np.int32))

    def result(self):
        """Final (sorted unique (M, W) uint32 keys, int64 counts)."""
        self._consolidate()
        if self._merged is None:
            return (np.zeros((0, self.w), dtype=np.uint32),
                    np.zeros(0, dtype=np.int64))
        keys, counts = self._merged
        with tracing.span("count.result.words"):
            return steps.to_words(keys, self.k), counts

    def to_index(self):
        keys, counts = self.result()
        return KmerIndex.from_keys_counts(keys, counts, self.k,
                                          device=self.device)


def make_stream_counter(k, *, device):
    """:class:`StreamCounter` on *device*, or
    :class:`~.parallel.sharded.ShardedStreamCounter` over the local CUDA
    devices when ``KDF_SHARDED=1`` forces it and there are 2 or more
    (:func:`_shard_dispatch`).  The reference shards
    automatically on a multi-chip mesh (engine.py:455–469); here the
    count's output is on the host, so no card limits it, and the
    sharded count sorts each batch's rows on the host."""
    device = resolve_device(device)
    if _shard_dispatch(device):
        from kmer_denovo_filter_tpu_torch.parallel import ShardedStreamCounter
        mesh = _local_mesh(device)
        logger.info("  sharded stream counter: %d-device mesh", len(mesh))
        return ShardedStreamCounter(k, mesh)
    return StreamCounter(k, device=device)


class FilteredCounter:
    """Count stream k-mers restricted to a fixed index (``--if`` analog).

    Two forms of one tally, both adding into an int64 accumulator IN
    PLACE (the JAX counter rebinds a new array each step):

    * plain (``dedup=False``): K1 window keys → K2, one probe per window;
    * dedup-first (``dedup=True``): K1 → K9d
      (:func:`~.ops.segsort.seg_dedup` in its unordered form: each
      8,192-window segment's keys with weights, left in its slot: its
      distinct keys where K9d's hash kept it, every live key of weight 1
      where it passed it through) → K3 on those slots, one probe and one
      weighted add per key of a slot, with no host sync between them —
      the reference's
      large-table branch with dedup on (engine.py:484–504,
      ``join_tally_step_dedup``: ``_dedup_compact`` over 8,192-row local
      chunks, then the weighted tally).

    For k > 31 the same forms run K1w → K7 unweighted (the reference's
    ``join_tally_flat_wide``) and K1w → K9dw
    (:func:`~.ops.segsort.seg_dedup_wide`, unordered: each segment's
    limb rows and weights, left in its slot) → K7 weighted on those
    slots, again with no host sync (``join_tally_flat_wide_dedup``:
    ``_dedup_compact_wide`` over 8,192-row local chunks, then the
    weighted tally).

    On a CUDA device each batch goes up through a ring of pinned slots
    (:class:`~.staging.Stage`) on a copy stream of its own, so ``feed``
    returns with its kernels enqueued and no host sync, and its launches
    run as one CUDA graph once the slot has taken a batch of its shape
    twice (:class:`_StepGraphs`); on the CPU K1 reads the caller's arrays
    in place.
    """

    def __init__(self, index, dedup=False):
        self.index = index
        self.dedup = dedup
        self.acc = torch.zeros(index.n, dtype=torch.int64,
                               device=index.device)
        self._stage = (staging.Stage(index.device)
                       if index.device.type == "cuda" else None)
        self._graphs = (_StepGraphs(self._launch)
                        if self._stage is not None else None)

    def feed(self, codes, lengths):
        """Tally one (B, L) uint8 code batch with (B,) lengths.  The
        batch goes over unpadded; one narrower than k holds no window.
        The caller may overwrite its arrays once this returns."""
        k = self.index.k
        with tracing.span("filter.feed"):
            batch = flags = None
            if steps.has_windows(codes, k):
                batch, flags = self._step(codes, lengths, k)
            if tracing.enabled():
                _count_batch(codes, lengths, k, batch, flags)

    def _step(self, codes, lengths, k):
        """The batch up, then its launches enqueued (:meth:`_launch`),
        on a card as a CUDA graph where one is held: (the batch on the
        device, the dedup's per-segment flags or None)."""
        with tracing.span("filter.feed.htod"):
            if self._stage is None:
                batch = steps.to_device(codes, lengths, self.index.device)
            else:
                batch = self._stage.put(codes, lengths)
        if self._stage is None:
            return batch, self._launch(batch)
        flags = self._graphs.run(batch)
        self._stage.release()
        return batch, flags

    def _launch(self, batch):
        """K1 (K1w), then the tally, through K9d (K9dw) in the dedup
        form, enqueued on the current stream: the dedup's per-segment
        ``(counts, passed)``, or None.  The dedup is unordered: K3 and K7
        read no order among a slot's keys, and their integer adds
        commute."""
        k = self.index.k
        with tracing.span("filter.feed.extract"):
            flat = steps.extract(*batch, k).flatten(0, 1)
        if not self.dedup:
            with tracing.span("filter.feed.tally"):
                steps.tally(flat, self.index, self.acc)
            return None
        with tracing.span("filter.feed.dedup"):
            keys, weights, counts, passed = steps.dedup(flat)
        with tracing.span("filter.feed.tally"):
            steps.tally(keys, self.index, self.acc, weights, counts)
        return counts, passed

    def result(self):
        """int64 counts aligned with the index's sorted keys."""
        with tracing.span("filter.result"):
            return self.acc.to("cpu", copy=True).numpy()


class _StepGraphs:
    """A staged counter's launches (``launch(batch)``, which returns the
    dedup's flags or None) as CUDA graphs, one for each slot of the ring
    and shape of batch: the host enqueues a batch's kernels by one graph
    launch, where each kernel's wrapper costs it tens of microseconds.

    A batch whose device buffers and shapes (its key) come for the first
    time runs eagerly; the second time, its launches are captured, on a
    side stream, into a graph that holds the outputs of every kernel but
    the last, and the graph is replayed, as it is for every later batch of
    that key, on the current stream.  The graph reads the slot's buffers,
    the table and the accumulator in place, and adds into the
    accumulator.  A replay adds its kernels to the launch counters
    (``tracing.launches``) as the eager launches did; while tracing is on
    it is the span ``filter.feed.graph``, and the stage spans come only
    from eager batches.  A slot that grows takes new buffers, a new key:
    past :data:`GRAPHS_KEPT` keys every graph is dropped."""

    def __init__(self, launch):
        self._launch = launch
        self._held = {}  # key -> None (seen once) or (graph, out, launched)
        self._side = None

    def run(self, batch):
        """Enqueue *batch*'s launches; the dedup's flags or None."""
        key = tuple((t.data_ptr(), tuple(t.shape)) for t in batch)
        held = self._held.get(key, _UNSEEN)
        if held is _UNSEEN:
            if len(self._held) >= GRAPHS_KEPT:
                self._held.clear()
            self._held[key] = None
            return self._launch(batch)
        if held is None:
            held = self._held[key] = self._capture(batch)
        graph, out, launched = held
        with tracing.span("filter.feed.graph"):
            graph.replay()
        for name, n in launched.items():
            tracing.count(name, n)
        return out

    def _capture(self, batch):
        """(graph, its output, {launch counter: launches}) of *batch*'s
        launches, captured and not run."""
        kernels = torch.cuda.current_stream(batch[0].device)
        if self._side is None:
            self._side = torch.cuda.Stream(batch[0].device)
        before = tracing.launches()
        graph = torch.cuda.CUDAGraph()
        self._side.wait_stream(kernels)
        torch.cuda.set_stream(self._side)
        try:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = self._launch(batch)
            finally:
                graph.capture_end()
        finally:
            torch.cuda.set_stream(kernels)
        launched = {}
        for kernel, n in tracing.launches().items():
            n -= before[kernel]
            if n:
                # the capture ran nothing: its wrappers' counts undone
                tracing.count(f"launches.{kernel}", -n)
                launched[f"launches.{kernel}"] = n
        return graph, out, launched


def _count_batch(codes, lengths, k, batch, flags):
    """The filter's counters of one host batch while tracing is on,
    counted after its kernels are enqueued, so the card runs them while
    the host counts: batches, reads, windows (the sum of max(0, length -
    k + 1)), the bytes copied up and, in the dedup form (*flags*, K9d's
    or K9dw's per-segment counts and passed flags), the segments, the
    keys left in them and the segments passed through, the last two
    summed on the device."""
    lengths = np.asarray(lengths)
    tracing.count("filter.batches")
    tracing.count("filter.reads", codes.shape[0])
    tracing.count("filter.windows",
                  int(np.maximum(lengths, k - 1).sum(dtype=np.int64))
                  - (k - 1) * lengths.size)
    if batch is not None:
        tracing.count("filter.bytes_up",
                      sum(t.numel() * t.element_size() for t in batch))
    if flags is not None:
        counts, passed = flags
        tracing.count("filter.segments", counts.shape[0])
        tracing.count_on_device("filter.distinct_keys", counts)
        tracing.count_on_device("filter.passed_segments", passed)


class HostFilteredCounter:
    """``--if`` filtered counter over a host-resident table.

    For filter tables on the CPU device over ``KDF_DEVICE_TABLE_BYTES``:
    windows are extracted on the CPU and the multithreaded C++ hash
    answers the random-access tally at host-memory speed (the role the
    mmap'd jellyfish index plays in the reference, kmer_utils.py:124–136).
    k <= 31 only, as in the reference (engine.py:1217).
    """

    def __init__(self, keys_np, k):
        keys64.check_k(k)
        if k > keys64.NARROW_K:
            raise ValueError("host filtered counter requires W <= 2")
        if not native.available():
            raise RuntimeError("native library unavailable")
        self.k = k
        self.w = enc.words_per_kmer(k)
        self.keys_np = np.ascontiguousarray(keys_np, np.uint32)
        self.n = keys_np.shape[0]
        self._ht = native.HostHashTable(
            keys64.words_to_keys64(self.keys_np, k).numpy().view(np.uint64))
        self._tally = np.zeros(self.n, dtype=np.int64)

    def feed(self, codes, lengths):
        win = steps.window_keys(codes, lengths, self.k, steps.CPU)
        if win is None:
            return
        # sentinel (INT64_MAX) windows are no table key: they never match
        self._ht.tally(win.reshape(-1).numpy().view(np.uint64), self._tally)

    def result(self):
        return self._tally.copy()


def make_filtered_counter(index):
    """VCF-mode parent scan: the plain K1 → K2 :class:`FilteredCounter`,
    or the :class:`~.parallel.sharded.ShardedFilteredCounter` over the
    local devices under ``KDF_SHARDED=1`` (:func:`_shard_dispatch`;
    reference engine.py:1370): *index* already fits its card."""
    if _shard_dispatch(index.device):
        from kmer_denovo_filter_tpu_torch.parallel import (
            ShardedFilteredCounter,
        )
        mesh = _local_mesh(index.device)
        logger.info("  sharded engine: %d-device mesh", len(mesh))
        return ShardedFilteredCounter(index.keys_np, index.k, mesh)
    return FilteredCounter(index)


def make_parent_filter_counter(keys_np, k, *, device):
    """Discovery parent filter (Module 2) built straight from host keys.

    The table becomes a :class:`KmerIndex` on *device* with the
    dedup-first :class:`FilteredCounter` (reference engine.py:1401).
    Over 2 or more local cards, a table the card cannot hold (or any
    table under ``KDF_SHARDED=1``, :func:`_shard_dispatch`) gives the
    dedup-first
    :class:`~.parallel.sharded.ShardedFilteredCounter` instead.  Otherwise
    on a CUDA device it must fit the card (table and accumulator) or
    this raises; on the CPU device a table over
    ``KDF_DEVICE_TABLE_BYTES`` goes to :class:`HostFilteredCounter` for
    k <= 31, while a wide table stays on the device, as in the reference
    (engine.py:1437).
    """
    device = resolve_device(device)
    n = keys_np.shape[0]
    n_bytes = _table_bytes(n, k) + 8 * n
    if _shard_dispatch(device, n_bytes):
        from kmer_denovo_filter_tpu_torch.parallel import (
            ShardedFilteredCounter,
        )
        mesh = _local_mesh(device)
        logger.info("  sharded engine: %d-device mesh", len(mesh))
        return ShardedFilteredCounter(keys_np, k, mesh, dedup=True)
    if device.type == "cuda":
        _check_card_holds(n_bytes, device, "filter")
    elif (k <= keys64.NARROW_K and _host_resident(n, k, "filter")
          and native.available()):
        return HostFilteredCounter(keys_np, k)
    return FilteredCounter(KmerIndex(keys_np, k, device=device), dedup=True)


def scan_reads_for_hits(index, codes, lengths):
    """Window hit mask of a read batch against *index* (K1 → K4, or
    K1w → K8 for k > 31).

    The anchoring-scan primitive (replaces the per-read Aho-Corasick /
    jellyfish-query loop of reference core/bam_scanner.py:340–507).
    Returns a (B, L - k + 1) bool numpy array: window *s* of read *b* is
    a canonical k-mer present in the index.
    """
    return scan_reads_for_hits_many(index, [(codes, lengths)])[0]


def scan_reads_for_hits_many(index, batches):
    """Anchoring scan of a GROUP of read batches in one device pass.

    *batches* is a list of ``(codes, lengths)`` numpy pairs.  They are
    padded to a common width with code 4, stacked into one
    (sum B_i, L) batch, and run through K1 and K4 (K1w and K8) once —
    the counterpart of the reference's one member join per super-batch
    (``join_member_superbatch_dedup``, kernel 5; for k > 31 it joins
    each batch by ``join_member_step_wide``); the mask is then split
    back per batch.  Returns a list of (B_i, L_i - k + 1) bool masks.
    """
    k = index.k
    batch = hits = None
    with tracing.span("scan.stage"):
        shapes = [(c.shape[0], max(0, c.shape[1] - k + 1))
                  for c, _ in batches]
        lmax = max([c.shape[1] for c, _ in batches] + [k])
        codes = np.full((sum(b for b, _ in shapes), lmax), 4,
                        dtype=np.uint8)
        lengths = np.concatenate(
            [np.asarray(l, dtype=np.int32) for _, l in batches]
            + [np.zeros(0, np.int32)])
        row = 0
        for c, _ in batches:
            codes[row:row + c.shape[0], :c.shape[1]] = c
            row += c.shape[0]
        if steps.has_windows(codes, k):
            batch = steps.to_device(codes, lengths, index.device)
    if batch is not None:
        with tracing.span("scan.member"):
            win = steps.extract(*batch, k)
            hits = steps.member(win.flatten(0, 1),
                                index).reshape(win.shape[:2])
    with tracing.span("scan.mask_back"):
        found = (np.zeros((codes.shape[0], lmax - k + 1), dtype=bool)
                 if hits is None else hits.cpu().numpy())
        out, row = [], 0
        for b, s in shapes:
            out.append(found[row:row + b, :s])
            row += b
    return out


def _sharded_index(index):
    """*index* itself when it is sharded, else its sharded copy when
    ``KDF_SHARDED=1`` forces it (:func:`_shard_dispatch`), else None."""
    from kmer_denovo_filter_tpu_torch.parallel import ShardedKmerIndex
    if isinstance(index, ShardedKmerIndex):
        return index
    if not _shard_dispatch(index.device):
        return None
    mesh = _local_mesh(index.device)
    logger.info("  sharded anchoring scan: %d-device mesh", len(mesh))
    return ShardedKmerIndex(index.keys_np, index.k, mesh)


def make_scanner(index):
    """Anchoring-scan callable for *index*: :func:`scan_reads_for_hits`,
    or :func:`~.parallel.sharded.sharded_scan_reads_for_hits` by the rule
    of :func:`make_filtered_counter` (reference engine.py:1448)."""
    sharded = _sharded_index(index)
    if sharded is not None:
        from kmer_denovo_filter_tpu_torch.parallel import (
            sharded_scan_reads_for_hits,
        )

        def scan(codes, lengths):
            return sharded_scan_reads_for_hits(sharded, codes, lengths)

        return scan

    def scan(codes, lengths):
        return scan_reads_for_hits(index, codes, lengths)

    return scan


def make_scanner_many(index):
    """Group-scan callable: list of (codes, lengths) → list of masks; a
    sharded index scans batch by batch (reference engine.py:1335)."""
    sharded = _sharded_index(index)
    if sharded is not None:
        from kmer_denovo_filter_tpu_torch.parallel import (
            sharded_scan_reads_for_hits,
        )

        def scan_many(batches):
            return [sharded_scan_reads_for_hits(sharded, c, l)
                    for c, l in batches]

        return scan_many

    def scan_many(batches):
        return scan_reads_for_hits_many(index, batches)

    return scan_many


def count_reads(read_batches, k, *, device):
    """Count canonical k-mers across an iterator of (codes, lengths)."""
    sc = StreamCounter(k, device=device)
    for codes, lengths in read_batches:
        sc.feed(codes, lengths)
    return sc
