"""A CPU model of kernel K9's register network with its payload
(``csrc/block_sort.cuh``, ``block_sort<Sort::kCarried>`` and
``<Sort::kLexicographic>``; ``csrc/seg_sort.cu``, ``seg_sort_kernel``),
held against its plain version ``dev.segment_sort``.  Integer outputs,
exact equality.

The CUDA kernel runs only on the card; this file transcribes its steps
in numpy: element i = 16 t + r in register r of thread t, strides 1..8
between registers, 16..256 by lane-xor shuffles, 512..4096 in the
transposed layout through the swizzled shared buffers, each element a
(key, payload) pair.  Carried, pairs compare by key; lexicographic, by
key, then payload.  A shuffle stage's lane takes its partner's pair only
when it is strictly the one it keeps, so a payload is never dropped or
duplicated; the non-strict keys-only rule of K9d would duplicate one
(checked below).  K9dw sorts with the same network
(``tests/test_torch_seg_dedup_wide_model.py``).  The model is on no
path.
"""

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch.experiments.x_fused import pair_order
from kmer_denovo_filter_tpu_torch.ops import device as tdev
from kmer_denovo_filter_tpu_torch.ops import segsort
from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL
from tests.test_torch_seg_dedup_model import LOG_SEG, REGS, THREADS, swizzle

SEG = segsort.SEGMENT


MODES = ("carried", "lexicographic")


def before(ka, pa, kb, pb, mode):
    """``sorts_before<kSort>``: (ka, pa) before (kb, pb), elementwise."""
    if mode == "carried":
        return ka < kb
    return (ka < kb) | ((ka == kb) & (pa < pb))


def compare_exchange(a, pa, b, pb, ascending, mode):
    """``compare_exchange<kSort>``: the pairs after the exchange, (a, pa)
    at the lower position."""
    swap = before(b, pb, a, pa, mode) == ascending
    return (np.where(swap, b, a), np.where(swap, pb, pa),
            np.where(swap, a, b), np.where(swap, pa, pb))


def shuffle_take(keep_min, mine, pmine, other, pother, mode, strict=True):
    """Whether a lane takes its partner's pair in a shuffle stage: the
    strict rule of ``block_sort``, or (strict False) K9d's keys-only
    rule applied to pairs, which takes an equal key."""
    if strict:
        return np.where(keep_min, before(other, pother, mine, pmine, mode),
                        before(mine, pmine, other, pother, mode))
    return (other < mine) == keep_min


def block_sort_pay(key, pay, log_p, buf, pbuf, mode="carried", strict=True):
    """``block_sort<kSort>`` with a payload (*mode* "carried" or
    "lexicographic"): *key*, *pay* are (THREADS, REGS), element 16 t + r
    at [t, r] for the p / 16 holders; *buf*, *pbuf* the shared buffers (p
    slots each).  Rows past the holders are garbage in the natural
    layout."""
    p = 1 << log_p
    holders = p // REGS
    n_tr = p >> 9
    assert holders % 32 == 0
    t_all = np.arange(THREADS)[:, None]
    t_h = np.arange(holders)[:, None]
    r = np.arange(REGS)[None, :]
    natural = swizzle(t_h * REGS + r)
    transposed = swizzle(t_all + (np.arange(n_tr)[None, :] << 9))
    for j in range(1, log_p + 1):
        if j > 9:
            buf[natural], pbuf[natural] = key[:holders], pay[:holders]
            key[:, :n_tr], pay[:, :n_tr] = buf[transposed], pbuf[transposed]
            for b in range(LOG_SEG - 1, 8, -1):
                if b >= j:
                    continue
                rb = 1 << (b - 9)
                for rr in range(n_tr):
                    if rr & rb == 0:
                        (key[:, rr], pay[:, rr], key[:, rr | rb],
                         pay[:, rr | rb]) = compare_exchange(
                            key[:, rr], pay[:, rr], key[:, rr | rb],
                            pay[:, rr | rb], ((rr >> (j - 9)) & 1) == 0,
                            mode)
            buf[transposed], pbuf[transposed] = key[:, :n_tr], pay[:, :n_tr]
            key[:holders], pay[:holders] = buf[natural], pbuf[natural]
        t = np.arange(holders)
        for b in range(8, 3, -1):
            if b >= j:
                continue
            lanes = 1 << (b - 4)
            partner = t ^ lanes
            assert (partner >> 5 == t >> 5).all()  # inside the warp
            other, pother = key[partner].copy(), pay[partner].copy()
            keep_min = ((((t >> (j - 4)) & 1) == 0)
                        == ((t & lanes) == 0))[:, None]
            mine, pmine = key[:holders], pay[:holders]
            take = shuffle_take(keep_min, mine, pmine, other, pother, mode,
                                strict)
            key[:holders] = np.where(take, other, mine)
            pay[:holders] = np.where(take, pother, pmine)
        for b in range(3, -1, -1):
            if b >= j:
                continue
            rb = 1 << b
            for rr in range(REGS):
                if rr & rb == 0:
                    (key[:holders, rr], pay[:holders, rr],
                     key[:holders, rr | rb], pay[:holders, rr | rb]) = (
                        compare_exchange(
                            key[:holders, rr], pay[:holders, rr],
                            key[:holders, rr | rb], pay[:holders, rr | rb],
                            (((t * REGS + rr) >> j) & 1) == 0, mode))
    return key, pay


def natural_out(key, pay, holders):
    """The holders' registers in position order (what the kernels store
    through the swizzled buffers and read back coalesced)."""
    return key[:holders].reshape(-1).copy(), pay[:holders].reshape(-1).copy()


def seg_sort_block(keys, payload):
    """``seg_sort_kernel<true>`` on one padded segment: thread t takes rows
    t + 512 r as its elements 16 t + r, sorts them (the payload carried),
    writes them in order."""
    key = keys.reshape(REGS, THREADS).T.copy()
    pay = payload.reshape(REGS, THREADS).T.copy()
    block_sort_pay(key, pay, LOG_SEG, np.full(SEG, -5, dtype=np.int64),
                   np.full(SEG, -5, dtype=np.int64))
    return natural_out(key, pay, THREADS)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("log_p", [9, 10, 11, 12, 13])
def test_payload_network_sorts_pairs(log_p, mode):
    """p pairs with many equal keys and repeated payloads, sentinels
    among them: the network's output holds every pair once, keys
    ascending (lexicographic: pairs in their order), and the
    non-holders' garbage never leaks in."""
    rng = np.random.default_rng(log_p)
    p = 1 << log_p
    holders = p // REGS
    key = rng.integers(-3, 3, (THREADS, REGS)).astype(np.int64)
    key[:holders][rng.random((holders, REGS)) < 0.1] = SENTINEL
    pay = rng.integers(-4, 4, (THREADS, REGS)).astype(np.int64)
    pairs = np.stack([key[:holders].reshape(-1),
                      pay[:holders].reshape(-1)], 1)
    want = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    key[holders:], pay[holders:] = 99, 77
    key, pay = block_sort_pay(key, pay, log_p, np.full(p, -5, np.int64),
                              np.full(p, -5, np.int64), mode)
    got = np.stack(natural_out(key, pay, holders), 1)
    assert np.array_equal(got[:, 0], want[:, 0])
    if mode == "carried":
        got = got[np.lexsort((got[:, 1], got[:, 0]))]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_payload_network_keeps_every_payload_on_one_key(mode):
    """All 8,192 keys equal: each of the distinct payloads lands once
    (lexicographic: in order)."""
    rng = np.random.default_rng(1)
    key = np.full((THREADS, REGS), 12345, dtype=np.int64)
    pay = rng.permutation(SEG).reshape(THREADS, REGS).astype(np.int64)
    key, pay = block_sort_pay(key, pay, LOG_SEG, np.full(SEG, -5, np.int64),
                              np.full(SEG, -5, np.int64), mode)
    got = natural_out(key, pay, THREADS)[1]
    if mode == "carried":
        got = np.sort(got)
    assert np.array_equal(got, np.arange(SEG))


def test_keys_only_shuffle_rule_would_duplicate_a_payload():
    """K9d's shuffle rule keeps an equal key from either lane; carried
    over to pairs it loses some payloads and doubles others, which the
    strict rule never does."""
    rng = np.random.default_rng(2)
    key = rng.integers(0, 3, (THREADS, REGS)).astype(np.int64)
    pay = np.arange(SEG, dtype=np.int64).reshape(THREADS, REGS)
    _, bad = block_sort_pay(key.copy(), pay.copy(), LOG_SEG,
                            np.full(SEG, -5, np.int64),
                            np.full(SEG, -5, np.int64), strict=False)
    assert np.unique(bad).size < SEG
    _, good = block_sort_pay(key, pay, LOG_SEG, np.full(SEG, -5, np.int64),
                             np.full(SEG, -5, np.int64))
    assert np.array_equal(np.sort(good.reshape(-1)), np.arange(SEG))


@pytest.mark.parametrize("n", [1, SEG - 1, SEG, 2 * SEG + 777])
def test_k9_model_matches_segment_sort(n):
    """The kernel model over padded segments (random and few-valued keys,
    sentinels, payload -1 on padding) equals the plain version up to the
    order within equal keys."""
    rng = np.random.default_rng(n)
    flat = np.where(rng.random(n) < 0.5, rng.integers(0, 1 << 62, n),
                    rng.integers(0, 20, n)).astype(np.int64)
    flat[rng.random(n) < 0.05] = SENTINEL
    payload = torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32))
    keys = segsort.segments(torch.from_numpy(flat), SENTINEL)
    pays = segsort.segments(payload, -1)
    out = [seg_sort_block(keys[s].numpy(), pays[s].numpy().astype(np.int64))
           for s in range(keys.shape[0])]
    got_keys = torch.from_numpy(np.stack([o[0] for o in out]))
    got_pay = torch.from_numpy(np.stack([o[1] for o in out]).astype(np.int32))
    ref_keys, ref_pay = tdev.segment_sort(keys, pays)
    assert torch.equal(got_keys, ref_keys)
    for g, w in zip(pair_order(got_keys, got_pay),
                    pair_order(ref_keys, ref_pay)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("layout,ways", [("natural", 2), ("transposed", 1)])
def test_payload_buffer_bank_conflicts(layout, ways):
    """The payload's 4-byte shared accesses through the keys' swizzle: a
    warp meets a 2-way bank conflict in the natural layout and none in
    the transposed one, for every register."""
    t = np.arange(THREADS)
    for r in range(REGS):
        i = t * REGS + r if layout == "natural" else t + (r << 9)
        banks = (swizzle(i) % 32).reshape(-1, 32)
        assert max(np.bincount(row).max() for row in banks) == ways
