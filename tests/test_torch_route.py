"""Kernel K10 (``ops/route.py``, ``csrc/route.cu``): the route of the
sharded engine, on the CPU.

* A numpy model of K10's arithmetic (uint32 owner hash, per-block
  histograms, the owner-major exclusive scan, the in-block stable rank
  by warp, lower warps and earlier rounds) equals ``np.argsort(owner,
  kind="stable")`` and ``np.bincount`` at several block shapes, and the
  port's int64 :func:`hash_owner`.
* The plain route (what a CPU tensor runs) equals that model, and it
  keeps the JAX ``_bucketize`` contract on the same keys: every live row
  in exactly one bucket, the rows of a bucket in input order, sentinel
  rows routed nowhere.  The two hashes differ, so the buckets do too.

Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu.parallel import sharded as jsh
from kmer_denovo_filter_tpu_torch.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops import route as rt

SENTINEL = keys64.SENTINEL
WARP = 32
# (threads, rounds) of a block: K10's, and smaller ones, so that 8,193
# rows span many blocks, rounds and warps
SHAPES = [(rt.THREADS, rt.ROUNDS), (64, 2), (32, 1)]


def random_limbs(n, k, seed, kind="random"):
    """(n, Q) int64 limb rows at k: random keys below each limb's range,
    with every 13th row a sentinel row; or all one key (a homopolymer
    batch), or all sentinel rows."""
    rng = np.random.default_rng(seed)
    q = keys64.limbs_per_kmer(k)
    if kind == "homopolymer":
        return np.zeros((n, q), np.int64)
    if kind == "sentinel":
        return np.full((n, q), SENTINEL, np.int64)
    tops = [1 << (2 * nb) for nb in keys64.limb_bases(k)]
    rows = np.stack([rng.integers(0, top, n, dtype=np.int64)
                     for top in tops], axis=1)
    rows[::13] = SENTINEL
    return rows


def owner_model(rows, n_shards, sentinel=True):
    """K10's owner of each (n, Q) row, in uint32 arithmetic as the kernel
    computes it: each limb's low and high 32 bits through two multiply
    mixes, then (h * S) >> 32 in 64 bits."""
    mul = np.uint32(0x045D9F3B)

    def mix(h):
        h = ((h >> np.uint32(16)) ^ h) * mul
        h = ((h >> np.uint32(16)) ^ h) * mul
        return (h >> np.uint32(16)) ^ h

    limbs = rows.astype(np.uint64)
    h = np.full(rows.shape[0], 0x811C9DC5, np.uint32)
    for j in range(rows.shape[1]):
        h = mix(h ^ (limbs[:, j] & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        h = mix(h ^ (limbs[:, j] >> np.uint64(32)).astype(np.uint32))
    owner = ((h.astype(np.uint64) * np.uint64(n_shards))
             >> np.uint64(32)).astype(np.int64)
    if sentinel:
        owner[rows[:, 0] == SENTINEL] = n_shards
    return owner


def k10_model(owner, bins, threads, rounds):
    """K10's three launches over *owner*: (order, sizes)."""
    n = owner.shape[0]
    tile = threads * rounds
    blocks = -(-n // tile)
    # 1. each block's histogram, written owner-major
    counts = np.zeros((bins, blocks), np.int64)
    for b in range(blocks):
        counts[:, b] = np.bincount(owner[b * tile:(b + 1) * tile],
                                   minlength=bins)
    # 2. one exclusive scan in owner-major order: within an owner the
    # blocks keep their order; a size is the next owner's first offset
    # less its own
    flat = counts.reshape(-1)
    offsets = (np.cumsum(flat) - flat).reshape(bins, blocks)
    if blocks:
        starts = offsets[:, 0]
        sizes = np.append(starts[1:], n) - starts
    else:
        sizes = np.zeros(bins, np.int64)
    # 3. each block walks its rows again, a round of `threads` at a time:
    # a row's slot is its owner's next slot in the block, plus its
    # owner's rows in lower warps of the round, plus those in lower lanes
    # of its warp (__match_any_sync and __popc)
    order = np.full(n, -1, np.int64)
    warps = threads // WARP
    for b in range(blocks):
        nxt = offsets[:, b].copy()
        for r in range(rounds):
            first = b * tile + r * threads
            if first >= n:
                break
            o = owner[first:first + threads]
            padded = np.full(threads, bins, np.int64)  # no row: no owner
            padded[:o.shape[0]] = o
            lanes = padded.reshape(warps, WARP)
            same = lanes[:, :, None] == lanes[:, None, :]
            rank = np.tril(same, -1).sum(axis=2).reshape(-1)
            warp_count = np.zeros((warps, bins + 1), np.int64)
            for w in range(warps):
                warp_count[w] = np.bincount(lanes[w], minlength=bins + 1)
            below = np.cumsum(warp_count, axis=0) - warp_count
            t = np.arange(o.shape[0])
            dest = nxt[o] + below[t // WARP, o] + rank[t]
            order[dest] = first + t
            nxt += np.bincount(o, minlength=bins)
    return order, sizes


@pytest.mark.parametrize("kind", ["random", "homopolymer", "sentinel"])
@pytest.mark.parametrize("k", [31, 63, 201])
@pytest.mark.parametrize("s", [1, 2, 3, 4, 7, 64])
def test_model_is_a_stable_sort_by_owner(s, k, kind):
    """The model of K10 equals a stable argsort by owner and a bincount
    at N = 0, 1 and 8,193, at every block shape; the plain route equals
    it, and its owners are the port's int64 hash."""
    for n in (0, 1, 8193):
        rows = random_limbs(n, k, seed=n + s + k, kind=kind)
        owner = owner_model(rows, s)
        keys = torch.from_numpy(rows if rows.shape[1] > 1 else rows[:, 0])
        hashed = rt.hash_owner(keys, s).numpy()
        assert np.array_equal(owner[rows[:, 0] != SENTINEL],
                              hashed[rows[:, 0] != SENTINEL])
        want = np.argsort(owner, kind="stable")
        counts = np.bincount(owner, minlength=s + 1)
        for threads, rounds in SHAPES:
            order, sizes = k10_model(owner, s + 1, threads, rounds)
            assert np.array_equal(order, want), (n, threads, rounds)
            assert np.array_equal(sizes, counts), (n, threads, rounds)
        got_order, got_sizes, routed = rt.route(keys, s)
        assert np.array_equal(got_order.numpy(), want)
        assert np.array_equal(got_sizes.numpy(), counts)
        assert torch.equal(routed, keys[got_order])


@pytest.mark.parametrize("k", [31, 63])
@pytest.mark.parametrize("s", [1, 3, 64])
def test_route_without_a_sentinel_bucket(s, k):
    """The multi-host exchange and the table build hash every row: S
    buckets, sentinel rows among them."""
    rows = random_limbs(8193, k, seed=s)
    owner = owner_model(rows, s, sentinel=False)
    assert owner.max() < s
    keys = torch.from_numpy(rows if rows.shape[1] > 1 else rows[:, 0])
    assert np.array_equal(owner, rt.hash_owner(keys, s).numpy())
    order, sizes = k10_model(owner, s, rt.THREADS, rt.ROUNDS)
    got = rt.route(keys, s, sentinel=False)
    assert np.array_equal(got[0].numpy(), order)
    assert np.array_equal(got[1].numpy(), sizes)
    assert got[1].shape == (s,)
    assert torch.equal(got[2], keys[got[0]])


def test_homopolymer_batch_goes_to_one_bucket():
    """One key in every row: one bucket takes all, in input order."""
    keys = torch.full((8193,), 12345, dtype=torch.int64)
    order, sizes, routed = rt.route(keys, 4)
    assert sorted(sizes.tolist()) == [0, 0, 0, 0, 8193]
    assert torch.equal(order, torch.arange(8193))
    assert torch.equal(routed, keys)


@pytest.mark.parametrize("n", [0, 4095, 4096, 4097, 1 << 20, 1 << 34])
@pytest.mark.parametrize("bins", [1, 5, 1024])
def test_plan_holds_every_row(n, bins):
    """K10's blocks cover every row, and the scan's counts stay within
    its limit."""
    blocks, rounds = rt.plan(n, bins)
    assert rounds >= rt.ROUNDS and rounds % rt.ROUNDS == 0
    assert blocks * rt.THREADS * rounds >= n
    assert (blocks - 1) * rt.THREADS * rounds < max(n, 1)
    assert blocks * bins <= rt.MAX_COUNTS


def test_route_refuses_what_k10_does_not_take():
    keys = torch.zeros(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="buckets"):
        rt.route(keys, rt.MAX_BINS)
    with pytest.raises(ValueError, match="buckets"):
        rt.route(keys, 0)
    rt.route(keys, rt.MAX_BINS, sentinel=False)
    with pytest.raises(ValueError, match="int64"):
        rt.route(keys.to(torch.int32), 2)
    with pytest.raises(ValueError, match="limbs"):
        rt.route(torch.zeros((4, 8), dtype=torch.int64), 2)


def test_route_takes_a_non_contiguous_view():
    rows = torch.from_numpy(random_limbs(1000, 63, seed=5))
    view = rows[::2]
    got = rt.route(view, 3)
    ref = rt.route(view.contiguous(), 3)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _words(n, k, seed):
    """(n, W) uint32 words of random k-mers (trailing bits zero), with
    every 7th row the JAX sentinel, and the port's keys of them."""
    rng = np.random.default_rng(seed)
    w = enc.words_per_kmer(k)
    words = rng.integers(0, 1 << 32, (n, w), dtype=np.uint64).astype(
        np.uint32)
    spare = 32 * w - 2 * k
    words[:, -1] &= np.uint32((0xFFFFFFFF << spare) & 0xFFFFFFFF)
    words[::7] = keys64.SENTINEL32
    keys = (keys64.words_to_keys64(words, k) if k <= keys64.NARROW_K
            else keys64.words_to_limbs(words, k))
    return words, keys


@pytest.mark.parametrize("s", [1, 2, 4, 7])
@pytest.mark.parametrize("k", [31, 63])
def test_plain_route_keeps_the_bucketize_contract(s, k):
    """The plain route and the JAX ``_bucketize`` (JAX on the CPU) on the
    same keys: each puts every live row in exactly one bucket, keeps
    each bucket's rows in input order, and routes no sentinel row."""
    n = 3001
    words, keys = _words(n, k, seed=s + k)
    live = ~(words == keys64.SENTINEL32).all(axis=1)
    w = words.shape[1]
    buckets, slot, overflow = jsh._bucketize(jnp.asarray(words), s, n, w)
    buckets, slot = np.asarray(buckets), np.asarray(slot)
    assert not bool(overflow)
    assert (slot[~live] == -1).all() and (slot[live] >= 0).all()
    jax_owner = slot // n
    for d in range(s):
        rows = np.flatnonzero(live & (jax_owner == d))
        assert np.array_equal(slot[rows] % n, np.arange(rows.size))
        assert np.array_equal(buckets[d, :rows.size], words[rows])
    order, sizes, routed = rt.route(keys, s)
    sizes = sizes.tolist()
    parts = np.split(order.numpy(), np.cumsum(sizes)[:-1])
    assert len(parts) == s + 1
    for part in parts:
        assert (np.diff(part) > 0).all()
    assert np.array_equal(np.sort(np.concatenate(parts[:s])),
                          np.flatnonzero(live))
    assert np.array_equal(parts[s], np.flatnonzero(~live))
    assert sum(sizes[:s]) == int(live.sum()) == int((slot >= 0).sum())
    assert torch.equal(routed, keys[order])
