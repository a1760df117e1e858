"""Hash-owner sharded k-mer engine over a mesh of torch devices.

Counterpart of :mod:`kmer_denovo_filter_tpu.parallel.sharded`, in one
process.  The mesh is an explicit list of ``torch.device``s
(:func:`make_mesh`: every local CUDA device); a device may repeat, so
``[cuda:0] * 4`` is four shards on one card and ``[cpu] * S`` is the CPU
tests' mesh.  The canonical k-mer table is partitioned by
:func:`~..ops.route.hash_owner`, so every distinct k-mer lives on
exactly one shard:

* each shard is a :class:`~kmer_denovo_filter_tpu_torch.engine.KmerIndex`
  on its device, with its own prefix directory on a card;
* reads split data-parallel across the mesh: the rows of a batch go in
  contiguous chunks, one a device, through K1 (K1w for k > 31) there;
* every window key goes to its owner: K10 (:func:`~..ops.route.route`,
  a stable counting sort by owner) gives variable-size buckets, so
  there is no capacity, no overflow flag and no replay (the JAX
  ``_bucketize`` capacity and its slack retry bound XLA's static
  shapes, and have no counterpart);
* on the keys it receives each shard runs the single-device steps
  (:mod:`..steps`): tally K2, or K9d -> K3 with ``dedup=True`` (for
  k > 31 K7, or K9dw -> K7), membership K4 (K8), and the
  ``StreamCounter`` sort-count K12 for :func:`sharded_count` and
  :class:`ShardedStreamCounter`;
* a copy between two cards is a plain ``Tensor.to``: PyTorch runs a
  copy between CUDA devices after the work queued on both devices'
  current streams, and their later work after it (``copy_`` in
  ``aten/src/ATen/native/cuda/Copy.cu``), so no event is recorded here.

Every source's route is launched before any bucket size is read; the
sizes then come to the host in one copy a device: the one host sync
routing adds to a batch.  A table is built on the mesh as it is
queried: slice i of its words goes up to ``mesh[i]``, becomes keys there
(K11) and is routed there (K10).  A shard on a CUDA device launches its
kernels or raises, as the single-device wrappers do.  The TPU lane-tile
counters (``parallel/tile_sharded.py``) are not ported.
"""

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch import steps
from kmer_denovo_filter_tpu_torch.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.route import route


def make_mesh(n_devices=None):
    """Every local CUDA device (the first *n_devices*), as a list of
    ``torch.device``; raises on a host without one.  Other meshes (a
    repeated device, CPU devices) are passed as lists directly."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device for the default mesh; pass the "
                           "mesh as a list of torch.device")
    devices = [torch.device("cuda", i) for i in range(count)]
    return devices if n_devices is None else devices[:n_devices]


def _device(device):
    """*device* as a ``torch.device`` with its CUDA index filled in, so
    that it compares equal to a tensor's device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _dispatch(keys, mesh):
    """Launch the route of a flat (N,) or (N, Q) key tensor to its owners
    on *mesh* (K10 on a card): ``(order, sizes, routed)`` on the keys'
    device, with the sentinel rows' bucket last; no host sync."""
    return route(keys, len(mesh))


def _to_host(tensors):
    """Each (n_i,) int64 tensor of *tensors* as a host numpy array, in
    one copy a device: the tensors of one device are concatenated
    first."""
    by_device = {}
    for i, t in enumerate(tensors):
        by_device.setdefault(t.device, []).append(i)
    out = [None] * len(tensors)
    for idx in by_device.values():
        flat = torch.cat([tensors[i] for i in idx]).cpu().numpy()
        ends = np.cumsum([tensors[i].shape[0] for i in idx])
        for i, part in zip(idx, np.split(flat, ends[:-1])):
            out[i] = part
    return out


def _in_order(keys):
    """0-dim bool tensor on the keys' device, no sync: (N,) int64 keys or
    (N, Q) limb rows in ascending (lexicographic) order, the order of
    their uint32 words."""
    a, b = keys[:-1], keys[1:]
    if keys.dim() == 1:
        return (a <= b).all()
    differ = a != b
    first = differ.to(torch.uint8).argmax(dim=1, keepdim=True)
    less = (a.gather(1, first) < b.gather(1, first)).squeeze(1)
    return (~differ.any(dim=1) | less).all()


def _route_table(keys_np, k, mesh):
    """Route a host (M, W) word table on *mesh*: slice i of ``len(mesh)``
    contiguous slices goes up to ``mesh[i]`` as words (with the last row
    of slice i - 1, so that the rows where two slices meet are compared
    too), becomes keys there (K11) and is routed there (K10, every row
    hashed).  Returns, for each shard d, its keys on ``mesh[d]`` (the
    slices' parts for d, in slice order, so a sorted table's stay
    sorted) and their (N_d,) int64 rows of *keys_np*, and whether the
    table's rows are in order.  The sizes, order checks and row numbers
    of all slices come to the host in one copy a device."""
    n, m = len(mesh), keys_np.shape[0]
    per = -(-m // n)
    routes, packets = [], []
    for i, device in enumerate(mesh):
        lo, hi = min(i * per, m), min((i + 1) * per, m)
        start = max(lo - 1, 0)
        keys = steps.key_tensor(keys_np[start:hi], k, device)
        order, sizes, routed = route(keys[lo - start:], n, sentinel=False)
        routes.append(routed)
        packets.append(torch.cat([sizes, _in_order(keys).view(1).long(),
                                  order + lo]))
    ordered = True
    shard_keys = [[] for _ in mesh]
    shard_rows = [[] for _ in mesh]
    for routed, packet in zip(routes, _to_host(packets)):
        sizes, ordered = packet[:n].tolist(), ordered and bool(packet[n])
        ends = np.cumsum(sizes)
        for d, (part, rows_d) in enumerate(zip(
                routed.split(sizes), np.split(packet[n + 1:], ends[:-1]))):
            shard_keys[d].append(part.to(mesh[d]))
            shard_rows[d].append(rows_d)
    return ([torch.cat(p) for p in shard_keys],
            [np.concatenate(r) for r in shard_rows], ordered)


def _split_reads(codes, lengths, n):
    """The rows of a host batch in *n* contiguous chunks (some empty when
    there are fewer rows than chunks)."""
    per = -(-codes.shape[0] // n)
    return [(codes[i * per:(i + 1) * per], lengths[i * per:(i + 1) * per])
            for i in range(n)]


def _window_keys_by_source(codes, lengths, k, mesh):
    """K1 (K1w) on each device's chunk of the batch: a list of (flat
    keys on the device or None, (rows, windows) of the chunk)."""
    out = []
    for device, (c, l) in zip(mesh, _split_reads(codes, lengths, len(mesh))):
        win = steps.window_keys(c, l, k, device)
        out.append((None, None) if win is None
                   else (win.flatten(0, 1), win.shape[:2]))
    return out


def _gather_by_owner(key_batches, mesh):
    """Route each flat key tensor of *key_batches* (one a source, each on
    its own device) to its owners: every source's route is launched
    before the bucket sizes come to the host, together.  Returns the
    routes (order, sizes, parts) of each batch and, for each shard, the
    parts it received."""
    pending = [_dispatch(keys, mesh) for keys in key_batches]
    sizes = [sz.tolist() for sz in _to_host([p[1] for p in pending])]
    routes = [(order, sz, [p.to(d) for p, d in zip(rows.split(sz), mesh)])
              for (order, _sizes, rows), sz in zip(pending, sizes)]
    received = [[route[2][d] for route in routes] for d in range(len(mesh))]
    return routes, received


class ShardedKmerIndex:
    """A canonical k-mer table sharded across a mesh of devices.

    Shard d holds the keys ``hash_owner`` gives it, lexicographically
    sorted, as a :class:`~kmer_denovo_filter_tpu_torch.engine.KmerIndex`
    on ``mesh[d]``; ``global_index_of[d]`` maps its rows back to rows of
    *keys_np*, and ``tallies[d]`` is its int64 filtered count."""

    def __init__(self, keys_np, k, mesh):
        """*keys_np*: (M, W) uint32 canonical keys, unique."""
        keys64.check_k(k)
        self.k = k
        self.w = enc.words_per_kmer(k)
        self.mesh = [_device(d) for d in mesh]
        if not self.mesh:
            raise ValueError("the mesh holds no device")
        self.n_shards = len(self.mesh)
        self.keys_np = keys_np
        self.n = keys_np.shape[0]
        tables, rows_of, presorted = _route_table(keys_np, k, self.mesh)
        self.shards = []
        self.global_index_of = []
        for device, table, rows in zip(self.mesh, tables, rows_of):
            if not presorted:
                # an unsorted table: each shard sorts its own rows
                rows = rows[enc.lexsort_keys(keys_np[rows])]
                table = None
            self.global_index_of.append(rows)
            self.shards.append(eng.KmerIndex(keys_np[rows], k, device=device,
                                             key_tensor=table))
        self.tallies = [torch.zeros(s.n, dtype=torch.int64, device=s.device)
                        for s in self.shards]

    def _tally_received(self, received, dedup=False):
        """Add each shard's received key parts to its tally: K2 (K7), or
        with *dedup* K9d -> K3 (K9dw -> K7) on their concatenation, the
        dedup unordered (its tally reads no order)."""
        for shard, acc, parts in zip(self.shards, self.tallies, received):
            if shard.n == 0 or not any(p.shape[0] for p in parts):
                continue
            keys = torch.cat(parts)
            if not dedup:
                steps.tally(keys, shard, acc)
                continue
            keys, weights, counts, _passed = steps.dedup(keys)
            steps.tally(keys, shard, acc, weights, counts)

    def _member_many(self, key_batches):
        """Found bools for each flat key tensor of *key_batches*, on its
        own device: every key goes to its owner, one K4 (K8) probe a
        shard answers all it received, and the answers come back."""
        routes, received = _gather_by_owner(key_batches, self.mesh)
        answers = [[] for _ in key_batches]
        for shard, parts in zip(self.shards, received):
            sizes = [p.shape[0] for p in parts]
            if shard.n and sum(sizes):
                found = steps.member(torch.cat(parts), shard)
            else:
                found = torch.zeros(sum(sizes), dtype=torch.bool,
                                    device=shard.device)
            for i, piece in enumerate(found.split(sizes)):
                answers[i].append(piece.to(key_batches[i].device))
        out = []
        for keys, (order, sizes, _parts), pieces in zip(key_batches, routes,
                                                       answers):
            pieces.append(torch.zeros(sizes[-1], dtype=torch.bool,
                                      device=keys.device))
            found = torch.empty(keys.shape[0], dtype=torch.bool,
                                device=keys.device)
            found[order] = torch.cat(pieces)
            out.append(found)
        return out

    def membership(self, query_keys_np):
        """bool per (N, W) query row: routed to its owner shard, K4 (K8)
        there, routed back; sentinel rows are never found."""
        if query_keys_np.shape[0] == 0:
            return np.zeros(0, dtype=bool)
        q = steps.key_tensor(query_keys_np, self.k, self.mesh[0])
        return self._member_many([q])[0].cpu().numpy()

    def tally_batch(self, flat_keys_np):
        """Accumulate filtered counts for a batch of (N, W) window keys."""
        if flat_keys_np.shape[0] == 0:
            return
        q = steps.key_tensor(flat_keys_np, self.k, self.mesh[0])
        self._tally_received(_gather_by_owner([q], self.mesh)[1])

    def tally_result(self):
        """int64 tally per global key, in the order of *keys_np*."""
        out = np.zeros(self.n, dtype=np.int64)
        for rows, acc in zip(self.global_index_of, self.tallies):
            out[rows] = acc.cpu().numpy()
        return out


class ShardedFilteredCounter:
    """Sharded ``--if`` filtered counter, the mesh counterpart of
    :class:`~kmer_denovo_filter_tpu_torch.engine.FilteredCounter`: each
    batch is extracted data-parallel over the mesh, its window keys go
    to their owners, and each owner tallies what it received, plain
    (K2, K7) or, with *dedup*, dedup-first (K9d -> K3, K9dw -> K7)."""

    def __init__(self, keys_np, k, mesh, dedup=False):
        self.index = ShardedKmerIndex(keys_np, k, mesh)
        self.k = k
        self.w = self.index.w
        self.dedup = dedup

    def feed(self, codes, lengths):
        """Tally one (B, L) uint8 code batch with (B,) lengths."""
        idx = self.index
        batches = [keys for keys, _shape in _window_keys_by_source(
            codes, lengths, self.k, idx.mesh) if keys is not None]
        if batches:
            idx._tally_received(_gather_by_owner(batches, idx.mesh)[1],
                                self.dedup)

    def result(self):
        """int64 counts aligned with the table's keys."""
        return self.index.tally_result()


def sharded_scan_reads_for_hits(counter_or_index, codes, lengths):
    """Window hit mask of a read batch against a sharded index (the
    counterpart of ``engine.scan_reads_for_hits``): reads data-parallel,
    keys routed to their owners, answers routed back.  Returns (B,
    max(0, L - k + 1)) bool numpy, equal to the single-device scan."""
    index = getattr(counter_or_index, "index", counter_or_index)
    b = codes.shape[0]
    out = np.zeros((b, max(0, codes.shape[1] - index.k + 1)), dtype=bool)
    sources = _window_keys_by_source(codes, lengths, index.k, index.mesh)
    live = [(i, keys, shape) for i, (keys, shape) in enumerate(sources)
            if keys is not None]
    if not live:
        return out
    found = index._member_many([keys for _i, keys, _shape in live])
    per = -(-b // index.n_shards)
    for (i, _keys, shape), hits in zip(live, found):
        out[i * per:i * per + shape[0]] = hits.reshape(shape).cpu().numpy()
    return out


def _count_rows(codes, lengths, k, mesh):
    """Sharded sort-count of one batch: (sorted unique (N, Q) int64 limb
    rows, int64 counts) on the host, Q = 1 for k <= 31.  Each owner
    sort-counts the keys it received by K12, as ``StreamCounter`` does;
    the owners' results are disjoint."""
    mesh = [_device(d) for d in mesh]
    batches = [keys for keys, _shape in _window_keys_by_source(
        codes, lengths, k, mesh) if keys is not None]
    q = keys64.limbs_per_kmer(k)
    keys_out = [np.zeros((0, q), dtype=np.int64)]
    counts_out = [np.zeros(0, dtype=np.int64)]
    if batches:
        for parts in _gather_by_owner(batches, mesh)[1]:
            keys = torch.cat(parts)
            if keys.shape[0] == 0:
                continue
            uk, counts = steps.sort_count(keys, k)
            keys_out.append(uk.cpu().numpy())
            counts_out.append(counts.cpu().numpy())
    keys = np.concatenate(keys_out)
    counts = np.concatenate(counts_out)
    order = enc.lexsort_keys(keys)
    return keys[order], counts[order]


def sharded_count(codes, lengths, k, mesh):
    """Distributed canonical k-mer count of a read batch over *mesh*:
    reads data-parallel, every window key to its owner, an owner-side
    sort-count.  Returns host ``(keys, counts)``: sorted (N, W) uint32
    words and int64 counts, as the single-device count gives them."""
    rows, counts = _count_rows(codes, lengths, k, mesh)
    return steps.to_words(rows, k), counts


class ShardedStreamCounter(eng.StreamCounter):
    """Mesh canonical counting (``jellyfish count -C`` over devices).

    Each batch runs the sharded count (:func:`_count_rows`: extraction
    data-parallel over the mesh, window keys routed to their owner, an
    owner-side sort-count); the per-batch (rows, counts) merge reuses
    :class:`~kmer_denovo_filter_tpu_torch.engine.StreamCounter`'s
    progressive consolidation (reference engine.py:430–452).
    """

    def __init__(self, k, mesh):
        super().__init__(k, device=mesh[0])
        self.mesh = mesh

    def feed(self, codes, lengths):
        self.add_chunk(*_count_rows(codes, lengths, self.k, self.mesh))
