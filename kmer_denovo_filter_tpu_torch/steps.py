"""The port's device steps, each in both key forms.

A key is one int64 for k <= 31 or a row of Q = ceil(k / 31) int64 limbs
for k = 33..207 (:mod:`.ops.keys`), and most kernels have one wrapper a
form.  This module picks the wrapper from the form: the engine's
counters and index (:mod:`.engine`) and the sharded and multi-host
engines (:mod:`.parallel`) call these steps and no form's wrapper, while
the tests hold each kernel through the ops wrappers themselves.

* :func:`to_device`, :func:`extract`, :func:`window_keys` — a host batch
  up, and K1, or K1w for k > 31;
* :func:`key_tensor`, :func:`live_rows` — host (M, W) uint32 words to
  keys (K11 on a card), and a sorted word table's live rows;
* :func:`tally`, :func:`member`, :func:`rows` — K2, K3 or K7; K4 or K8,
  each through the index's prefix directory;
* :func:`dedup` — K9d, or K9dw for rows, in its unordered form;
* :func:`sort_count`, :func:`to_words` — K12 in either form as (N, Q)
  rows (Q = 1 for k <= 31), and such rows back to host words.
"""

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops import sortcount
from kmer_denovo_filter_tpu_torch.ops.convert import (
    plain_words_to_keys,
    words_tensor,
    words_to_keys,
)
from kmer_denovo_filter_tpu_torch.ops.extract import (
    extract_canonical,
    extract_canonical_wide,
)
from kmer_denovo_filter_tpu_torch.ops.member import (
    probe_member,
    probe_member_wide,
    probe_rows,
    probe_rows_wide,
)
from kmer_denovo_filter_tpu_torch.ops.probe import (
    probe_tally,
    probe_tally_wide,
    probe_tally_weighted,
)
from kmer_denovo_filter_tpu_torch.ops.segsort import seg_dedup, seg_dedup_wide

CPU = torch.device("cpu")


def has_windows(codes, k):
    """True when the (B, L) batch *codes* can hold a window of k."""
    return codes.shape[0] > 0 and codes.shape[1] >= k


def to_device(codes, lengths, device):
    """Host (B, L) uint8 codes and (B,) lengths as tensors on *device*."""
    return (torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8))
            .to(device),
            torch.from_numpy(np.ascontiguousarray(lengths, dtype=np.int32))
            .to(device))


def extract(codes, lengths, k):
    """K1, or K1w for k > 31, on (B, L) codes and (B,) lengths on the
    device: (B, L - k + 1) int64 keys, or (B, L - k + 1, Q) limb rows."""
    if k <= keys64.NARROW_K:
        return extract_canonical(codes, lengths, k)
    return extract_canonical_wide(codes, lengths, k)


def window_keys(codes, lengths, k, device):
    """:func:`extract` over one host batch on *device*, or None when the
    batch holds no window."""
    if not has_windows(codes, k):
        return None
    return extract(*to_device(codes, lengths, device), k)


def key_tensor(words, k, device=CPU):
    """Host (N, W) uint32 words → (N,) int64 keys, or (N, Q) limb rows
    for k > 31, on *device*: on a CUDA device the words go up as they
    are and K11 (:func:`~.ops.convert.words_to_keys`) makes the keys
    there; on the CPU the numpy conversion of :mod:`.ops.keys`, which
    K11's plain version repeats in torch, makes them."""
    if torch.device(device).type == "cuda":
        return words_to_keys(words_tensor(words).to(device), k)
    if k <= keys64.NARROW_K:
        return keys64.words_to_keys64(words, k)
    return keys64.words_to_limbs(words, k)


def live_rows(words, k):
    """(live rows, the last live key) of a sorted (M, W) word table: the
    rows before its trailing all-ones (sentinel) rows, and limb 0 of the
    last of them (0 when none is live), from the host words through
    K11's plain version."""
    live = words.shape[0]
    while live and (words[live - 1] == keys64.SENTINEL32).all():
        live -= 1
    if not live:
        return 0, 0
    last = plain_words_to_keys(words_tensor(words[live - 1:live]), k)
    return live, int(last.reshape(-1)[0])


def member(keys, index):
    """K4, or K8 for a (M, Q) table, through the index's directory: found
    bools."""
    if index.table.dim() == 2:
        return probe_member_wide(keys, index.table, index.directory)
    return probe_member(keys, index.table, index.directory)


def rows(keys, index):
    """K4, or K8 for a (M, Q) table, through the index's directory: table
    rows, -1 where absent."""
    if index.table.dim() == 2:
        return probe_rows_wide(keys, index.table, index.directory)
    return probe_rows(keys, index.table, index.directory)


def tally(keys, index, acc, weights=None, counts=None):
    """``acc += `` the tally of *keys* (weighted when *weights* is
    given, on K9d's or K9dw's slots when *counts* is): K2 or K3 through
    the index's directory, or K7 (both forms) through it for a (M, Q)
    table."""
    if index.table.dim() == 2:
        return probe_tally_wide(keys, index.table, acc, weights,
                                index.directory, counts)
    if weights is None:
        return probe_tally(keys, index.table, acc, index.directory)
    return probe_tally_weighted(keys, weights, index.table, acc,
                                index.directory, counts)


def dedup(flat):
    """K9d on flat (N,) keys, or K9dw on (N, Q) limb rows, unordered:
    each segment's keys and weights left in its slots, with its count
    and whether K9d passed it through (``(keys, weights, counts,
    passed)``, :func:`~.ops.segsort.seg_dedup`).  :func:`tally` reads no
    order among a slot's keys."""
    if flat.dim() == 2:
        return seg_dedup_wide(flat, ordered=False)
    return seg_dedup(flat, ordered=False)


def sort_count(flat, k):
    """K12 on flat (N,) keys or (N, Q) limb rows at *k*: the distinct
    live keys ascending as (N', Q) rows (Q = 1 for k <= 31) and their
    int64 counts, on the keys' device; one host sync on a card."""
    if flat.dim() == 2:
        return sortcount.sort_count_wide(flat, k)
    keys, counts = sortcount.sort_count(flat, k)
    return keys[:, None], counts


def to_words(rows, k):
    """(N, Q) int64 limb rows (tensor or array; Q = 1 for k <= 31) →
    (N, W) uint32 host words."""
    if k > keys64.NARROW_K:
        return keys64.limbs_to_words(rows, k)
    return keys64.keys64_to_words(rows[:, 0], k)
