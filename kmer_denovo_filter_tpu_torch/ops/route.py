"""Kernel K10 wrapper: the route of the sharded engine, every key row to
its owner shard.

The TPU's routing is XLA inside the jitted shard program,
``kmer_denovo_filter_tpu/parallel/sharded.py`` ``hash_owner`` (:51) and
``_bucketize`` (:61): a one-hot cumsum into buckets of a fixed capacity.
Here the buckets have none: :func:`route` sorts the rows stably by their
owner (:func:`hash_owner`) and returns the order, the bucket sizes and
the rows gathered in that order.  A CUDA tensor launches K10
(``csrc/route.cu``, a counting sort in three launches: per-block owner
histograms, their owner-major scan, a stable scatter); a CPU tensor runs
:func:`plain_route`, a stable ``argsort`` of the owners and a
``bincount``.  Both give the same three tensors.

The sizes stay on the keys' device: a caller that routes several key
tensors launches every route first and then brings all their sizes to
the host together (``parallel.sharded._gather_by_owner``).
"""

import torch

from kmer_denovo_filter_tpu_torch.ops import _cuda
from kmer_denovo_filter_tpu_torch.ops.keys import (
    MAX_K,
    SENTINEL,
    limbs_per_kmer,
)

# CUDA kernel launches since import (or since a caller reset them to 0)
launches = 0

MAX_BINS = 1024  # buckets a route may have (K10's shared histogram)
THREADS = 256    # rows a round of a K10 block
ROUNDS = 16      # rounds a block, at least
MAX_COUNTS = 1 << 22  # per-block counts K10's one-block scan takes

_MASK32 = 0xFFFFFFFF
# a 32-bit value times this (< 2**27) stays below 2**59: no int64 overflow
_MUL = 0x045D9F3B
_SEED = 0x811C9DC5


def _mix32(h):
    """A 32-bit avalanche of int64 *h* in [0, 2**32), exact in int64."""
    h = ((h >> 16) ^ h) * _MUL & _MASK32
    h = ((h >> 16) ^ h) * _MUL & _MASK32
    return (h >> 16) ^ h


def hash_owner(keys, n_shards):
    """(N,) int64 owner shard of each (N,) int64 key or (N, Q) limb row:
    uniform even for biased DNA keys.

    Each limb (non-negative, below 2**63) folds in as its low and high 32
    bits through :func:`_mix32`; every product is masked to 32 bits, so
    the same int64 operations give the same owner on the CPU and on the
    card, and K10's uint32 arithmetic gives it too.  The owner is the
    hash's fixed-point scale to *n_shards*."""
    limbs = keys.unsqueeze(1) if keys.dim() == 1 else keys
    h = torch.full((limbs.shape[0],), _SEED, dtype=torch.int64,
                   device=keys.device)
    for j in range(limbs.shape[1]):
        limb = limbs[:, j]
        h = _mix32(h ^ (limb & _MASK32))
        h = _mix32(h ^ (limb >> 32))
    return (h * n_shards) >> 32


def plain_route(keys, n_shards, sentinel=True):
    """The plain version of K10: ``(order, sizes, routed)`` of (N,) int64
    keys or (N, Q) limb rows, by a stable ``argsort`` of the owners."""
    owner = hash_owner(keys, n_shards)
    if sentinel:
        first = keys if keys.dim() == 1 else keys[:, 0]
        owner = torch.where(first != SENTINEL, owner, n_shards)
    order = torch.argsort(owner, stable=True)
    sizes = torch.bincount(owner, minlength=n_shards + int(sentinel))
    return order, sizes, keys[order]


def plan(n, bins):
    """(blocks, rounds) of K10 over *n* rows and *bins* buckets: blocks
    of ``THREADS * rounds`` rows, :data:`ROUNDS` rounds or more, so that
    the scan has at most :data:`MAX_COUNTS` counts."""
    most = MAX_COUNTS // bins
    rounds = ROUNDS * max(1, -(-n // (most * THREADS * ROUNDS)))
    return -(-n // (THREADS * rounds)), rounds


def route(keys, n_shards, sentinel=True):
    """Route (N,) int64 keys or (N, Q) int64 limb rows to *n_shards*
    owners: returns ``(order, sizes, routed)`` on the keys' device.

    *order* is (N,) int64, the row indices sorted stably by owner;
    *sizes* the (n_shards + 1,) int64 bucket sizes, the last one the
    sentinel rows' (limb 0 :data:`~.keys.SENTINEL`), or (n_shards,) with
    *sentinel* False, when every row is hashed; *routed* is
    ``keys[order]``.  A CUDA tensor launches K10, a CPU tensor runs
    :func:`plain_route`.  More than :data:`MAX_BINS` buckets raise."""
    global launches
    if keys.dim() not in (1, 2) or keys.dtype != torch.int64:
        raise ValueError(f"expected (N,) or (N, Q) int64 keys, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    q = 1 if keys.dim() == 1 else keys.shape[1]
    if not 1 <= q <= limbs_per_kmer(MAX_K):
        raise ValueError(f"rows of {q} limbs: K10 takes 1.."
                         f"{limbs_per_kmer(MAX_K)}")
    bins = n_shards + int(sentinel)
    if n_shards < 1 or bins > MAX_BINS:
        raise ValueError(f"{n_shards} shards: a route has 1..{MAX_BINS} "
                         "buckets, the sentinel bucket included")
    if keys.device.type == "cpu":
        return plain_route(keys, n_shards, sentinel)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    keys = keys.contiguous()
    n = keys.shape[0]
    blocks, rounds = plan(n, bins)
    counts = torch.empty(max(bins * blocks, 1), dtype=torch.int64,
                         device=keys.device)
    order = torch.empty(n, dtype=torch.int64, device=keys.device)
    sizes = torch.empty(bins, dtype=torch.int64, device=keys.device)
    routed = torch.empty_like(keys)
    with torch.cuda.device(keys.device):
        err = _cuda.lib().kdf_route(
            keys.data_ptr(), n, q, n_shards, int(sentinel), rounds, blocks,
            counts.data_ptr(), order.data_ptr(), sizes.data_ptr(),
            routed.data_ptr(), _cuda.stream_of(keys))
    _cuda.check(err, "route")
    launches += 1
    return order, sizes, routed
