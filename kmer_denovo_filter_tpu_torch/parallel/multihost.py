"""Multi-host runs of the port over ``torch.distributed``.

Counterpart of :mod:`kmer_denovo_filter_tpu.parallel.multihost`: N
processes (one a card, or CPU processes in the tests) each decode their
own stripe of every input BAM, partial results merge at module
boundaries, and process 0 writes the outputs.

Deployment contract, as in the JAX package:

* every process joins first (:func:`initialize`, or the CLIs'
  ``cli._join_multihost``), from ``KDF_COORDINATOR`` (host:port),
  ``KDF_NUM_PROCESSES`` and ``KDF_PROCESS_ID``:
  ``init_process_group(init_method="tcp://" + KDF_COORDINATOR, ...)``;
* a CUDA process takes ``cuda:{rank % torch.cuda.device_count()}`` and
  the ``nccl`` backend for device tensors, plus one ``gloo`` group for
  host payloads; a CPU process takes ``gloo`` only.  The NCCL group is
  formed while joining: if it cannot form, joining raises, and nothing
  falls back to gloo;
* host payloads (pickled partials, aligned numpy sums) travel on the
  gloo group; device tensors (the routed keys of
  :func:`sharded_count_multihost`, tensors given to :func:`sum_aligned`)
  on the default group.

The JAX ``global_mesh`` and ``distribute_read_batch`` build JAX global
arrays and have no counterpart: a process here feeds its own device,
and keys cross processes only through the collectives below.
"""

import logging
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch import steps
from kmer_denovo_filter_tpu_torch.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.route import route

logger = logging.getLogger(__name__)

# This process's membership, set by initialize(): its device and the
# gloo group for host payloads (None when the default group is gloo).
_RUNTIME = {}


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, *, device="cuda"):
    """Join the process group (idempotent).

    Arguments fall back to ``KDF_COORDINATOR`` / ``KDF_NUM_PROCESSES`` /
    ``KDF_PROCESS_ID``; with no coordinator this is a no-op returning
    False, so single-process runs need no configuration.  *device*'s
    type picks the backend: ``cuda`` joins with ``nccl`` on
    ``cuda:{rank % device_count}`` (and a gloo group for host payloads),
    ``cpu`` with ``gloo``."""
    coordinator_address = coordinator_address or os.environ.get(
        "KDF_COORDINATOR")
    if coordinator_address is None:
        return False
    if _RUNTIME:
        return True
    if num_processes is None:
        num_processes = int(os.environ["KDF_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["KDF_PROCESS_ID"])
    device = eng.resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda",
                              process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    host_group = None
    if backend == "nccl":
        host_group = dist.new_group(backend="gloo")
        # form the NCCL communicator now: a failure raises here
        probe = torch.ones(1, dtype=torch.int64, device=device)
        dist.all_reduce(probe)
        if int(probe.item()) != num_processes:
            raise RuntimeError(f"NCCL all_reduce over {num_processes} "
                               f"processes gave {int(probe.item())}")
    _RUNTIME.update(device=device, host_group=host_group)
    logger.info("distributed runtime: process %d/%d on %s (%s)",
                process_id, num_processes, device, backend)
    return True


def shutdown():
    """Leave the process group joined by :func:`initialize`."""
    if _RUNTIME:
        _RUNTIME.clear()
        dist.destroy_process_group()


def joined():
    """True once :func:`initialize` joined a process group."""
    return bool(_RUNTIME)


def device():
    """The device this process joined with, or None."""
    return _RUNTIME.get("device")


def active():
    """True when this run spans multiple processes."""
    return joined() and dist.get_world_size() > 1


def process_index():
    return dist.get_rank() if active() else 0


def process_count():
    return dist.get_world_size() if active() else 1


def is_primary():
    """True on the process that owns output writing (process 0)."""
    return process_index() == 0


def stripe():
    """(process_id, n_processes) input-shard assignment, or None: host
    *i* consumes chunk/batch stripe ``i mod n`` of each input stream."""
    return (process_index(), process_count()) if active() else None


def _group_for(tensor):
    """The group a tensor's collective runs on: the default group for a
    CUDA tensor (NCCL; a gloo-only process refuses it), the gloo group
    for a host tensor."""
    if tensor.device.type == "cuda":
        if dist.get_backend() != "nccl":
            raise RuntimeError("a CUDA tensor needs the NCCL group; this "
                               "process joined with gloo")
        return None
    return _RUNTIME["host_group"]


def allgather_bytes(payload):
    """Gather one bytes payload from every process, in process order."""
    if not joined():
        return [bytes(payload)]
    group = _RUNTIME["host_group"]
    n = dist.get_world_size()
    arr = torch.from_numpy(np.frombuffer(payload, dtype=np.uint8).copy())
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([arr.numel()]), group=group)
    cap = max(1, max(int(s) for s in sizes))
    padded = torch.zeros(cap, dtype=torch.uint8)
    padded[:arr.numel()] = arr
    gathered = [torch.empty(cap, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(gathered, padded, group=group)
    return [g[:int(s)].numpy().tobytes() for g, s in zip(gathered, sizes)]


def allgather_object(obj):
    """Gather one picklable object from every process (process order)."""
    return [pickle.loads(b)
            for b in allgather_bytes(pickle.dumps(obj, protocol=4))]


def merge_counts(keys, counts):
    """Merge per-host (keys, counts) partial k-mer counts globally.

    Every process contributes the sorted output of its local stream
    counter; the merged result (concatenate → lexsort → segment-sum)
    is identical on every host and equal to a single-process count of
    the union of the input stripes.
    """
    parts = allgather_object((np.asarray(keys), np.asarray(counts)))
    return _merge_sorted_parts([p[0] for p in parts], [p[1] for p in parts])


# Transient-memory accounting of the last owner-sharded merge: every
# field is bytes (or a ratio) observed on THIS process.  The 1/N
# memory contract is tested against these (tests/test_torch_multihost.py).
LAST_MERGE_STATS = {}


def _fmix32_np(x):
    """fmix32 of uint32 *x* (copy of ``pallas_join._fmix32_np``)."""
    x = x.astype(np.uint32, copy=True)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def route_hash_np(words):
    """Uniform uint32 route hash of (N, W) uint32 keys (copy of the JAX
    package's ``pallas_join.route_hash_np``, so owners match it)."""
    h = np.zeros(words.shape[0], dtype=np.uint32)
    for j in range(words.shape[1]):
        h = _fmix32_np(h ^ words[:, j])
    return h


def _owner_of_keys(keys, n):
    """Stable uniform owner process for each (N, W) uint32 key row:
    the fixed-point scale of :func:`route_hash_np`, so ownership is
    identical on every host, independent of input order, and equal to
    the JAX package's."""
    h = route_hash_np(np.ascontiguousarray(keys, np.uint32))
    return ((h.astype(np.uint64) * np.uint64(n))
            >> np.uint64(32)).astype(np.int64)


def _merge_sorted_parts(parts_keys, parts_counts):
    """Concatenate per-host partials and segment-sum equal keys."""
    all_keys = np.concatenate(parts_keys, axis=0)
    all_counts = np.concatenate(parts_counts, axis=0)
    if all_keys.shape[0] == 0:
        return all_keys, all_counts.astype(np.int64)
    order = enc.lexsort_keys(all_keys)
    sk = all_keys[order]
    sc = all_counts[order]
    new = np.empty(sk.shape[0], dtype=bool)
    new[0] = True
    new[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    seg = np.cumsum(new) - 1
    merged = np.zeros(int(seg[-1]) + 1, dtype=np.int64)
    np.add.at(merged, seg, sc.astype(np.int64))
    return sk[new], merged


def merge_counts_sharded(keys, counts):
    """Owner-sharded merge of per-host partial counts.

    NO process ever materializes the global table: each host routes
    its partial rows to their hash owner in N allgather rounds
    (non-owners drop a round's payload immediately), so per-host
    transient memory is O(total / N) and the returned ``(keys,
    counts)`` hold ONLY this process's shard — disjoint across
    processes, union = the global merge.  Threshold filters then apply
    shard-locally and only survivors gather
    (:func:`allgather_keys_sorted`).
    """
    keys = np.asarray(keys)
    counts = np.asarray(counts)
    n = process_count()
    me = process_index()
    if n == 1:
        k, c = _merge_sorted_parts([keys], [counts])
        LAST_MERGE_STATS.update(
            n_processes=1, local_in_bytes=keys.nbytes + counts.nbytes,
            peak_round_bytes=0, shard_out_bytes=k.nbytes + c.nbytes)
        return k, c
    owner = _owner_of_keys(keys, n)
    order = np.argsort(owner, kind="stable")
    bounds = np.searchsorted(owner[order], np.arange(n + 1))
    sk = keys[order]
    sc = counts[order]
    mine_k = mine_c = None
    peak_round = 0
    for d in range(n):
        sl = slice(bounds[d], bounds[d + 1])
        parts = allgather_bytes(pickle.dumps((sk[sl], sc[sl]), protocol=4))
        peak_round = max(peak_round, sum(len(b) for b in parts))
        if d == me:
            loaded = [pickle.loads(b) for b in parts]
            mine_k, mine_c = _merge_sorted_parts(
                [p[0] for p in loaded], [p[1] for p in loaded])
        # non-owners drop this round's parts before the next gather
        del parts
    LAST_MERGE_STATS.update(
        n_processes=n, local_in_bytes=keys.nbytes + counts.nbytes,
        peak_round_bytes=peak_round,
        shard_out_bytes=mine_k.nbytes + mine_c.nbytes)
    return mine_k, mine_c


def allgather_keys_sorted(keys):
    """Gather disjoint per-process key shards into the global sorted key
    array (identical on every host; lexicographic order matches the
    single-process pipeline's sorted tables)."""
    keys = np.asarray(keys)
    parts = [p for p in allgather_object(keys) if p.shape[0]]
    if not parts:
        return keys.reshape(0, keys.shape[-1] if keys.ndim > 1 else 1)
    merged = np.concatenate(parts, axis=0)
    return merged[enc.lexsort_keys(merged)]


def sum_aligned(values):
    """Element-wise sum of one aligned array across all processes.

    A numpy array (or scalar) sums on the gloo group and comes back as
    numpy; a tensor sums on its device's group (NCCL for a CUDA tensor)
    and comes back as a new tensor on that device."""
    if isinstance(values, torch.Tensor):
        out = values.clone()
        if joined():
            dist.all_reduce(out, group=_group_for(out))
        return out
    arr = np.asarray(values)
    if not joined():
        return arr.copy()
    flat = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).copy())
    dist.all_reduce(flat, group=_RUNTIME["host_group"])
    return flat.numpy().reshape(arr.shape)


def _exchange(keys):
    """Route flat live (N,) or (N, Q) keys on this process's device to
    their owner processes (:func:`~..ops.route.hash_owner` over the world
    size; K10 on a card, with no sentinel bucket): one
    ``all_to_all_single`` of the bucket sizes, one with variable splits
    of the keys.  Returns the keys this process owns."""
    n = dist.get_world_size()
    group = _group_for(keys)
    _order, send_sizes, routed = route(keys, n, sentinel=False)
    recv_sizes = torch.empty_like(send_sizes)
    dist.all_to_all_single(recv_sizes, send_sizes, group=group)
    recv_split = recv_sizes.tolist()
    recv = keys.new_empty((sum(recv_split),) + tuple(keys.shape[1:]))
    dist.all_to_all_single(recv, routed, recv_split, send_sizes.tolist(),
                           group=group)
    return recv


def sharded_count_multihost(codes, lengths, k, per_process=False,
                            device=None):
    """Distributed canonical k-mer count with per-host input feeds.

    Each process extracts its own batch's window keys with K1 (K1w for
    k > 31) on *device* (by default the device it joined with, else
    CUDA), routes every live key to its owner process
    (``all_to_all_single`` with variable splits: NCCL on the card, gloo
    on the CPU), and sort-counts what it receives (K12 on the card), as
    ``StreamCounter`` does.  With ``per_process=True`` it returns only
    its own disjoint shard (sorted (N, W) uint32 keys, int64 counts);
    otherwise the shards gather on the host to the global result on
    every process.
    """
    device = eng.resolve_device(device or _RUNTIME.get("device", "cuda"))
    win = steps.window_keys(codes, lengths, k, device)
    q = keys64.limbs_per_kmer(k)
    flat = (torch.empty((0, q) if q > 1 else (0,), dtype=torch.int64,
                        device=device)
            if win is None else win.flatten(0, 1))
    live = flat[(flat if flat.dim() == 1 else flat[:, 0])
                != keys64.SENTINEL]
    if joined():
        live = _exchange(live)
    uk, counts = steps.sort_count(live, k)
    words, counts = steps.to_words(uk, k), counts.cpu().numpy()
    if per_process or not active():
        return words, counts
    parts = allgather_object((words, counts))
    keys = np.concatenate([p[0] for p in parts])
    counts = np.concatenate([p[1] for p in parts])
    order = enc.lexsort_keys(keys)
    return keys[order], counts[order]
