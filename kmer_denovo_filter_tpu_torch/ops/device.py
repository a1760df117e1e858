"""Plain PyTorch versions of the engine's device steps, on int64 keys.

Counterparts of :mod:`kmer_denovo_filter_tpu.ops.device`
(``extract_canonical_windows`` :33, ``sort_count`` :121,
``small_table_tally`` :281, ``small_table_member`` :313,
``small_tally_step`` :337, ``small_tally_steps`` :351,
``small_scan_hits_step`` :368, ``lookup_sorted`` :657).  They run on
any device: the kernel wrappers (:mod:`.extract`, :mod:`.probe`,
:mod:`.member`) use them for CPU tensors, the CPU tests hold them
against the JAX functions, and ``chip_smoke.py`` holds the CUDA kernels
against them on the card.  :func:`sort_count` and :func:`dedup_windows`
are no kernel's plain version: the engine calls them on every device.

Keys are the right-aligned int64 form of :mod:`.keys`; invalid windows
hold :data:`~.keys.SENTINEL`, which is never found and never tallied.
The all-pairs sweeps and tile joins of the JAX package become a binary
search (``torch.searchsorted``): on a GPU the probe is O(N log M) where
the TPU sweep was O(N·M).
"""

import torch

from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL


def extract_canonical_windows(codes, lengths, k):
    """Canonical int64 keys of every window of a padded read batch.

    Args:
        codes: (B, L) uint8 2-bit base codes; 4 marks N/padding.
        lengths: (B,) int32 true read lengths.
        k: odd k-mer length, 3..31.

    Returns:
        keys: (B, S) int64, S = L - k + 1; :data:`SENTINEL` where the
            window holds a code >= 4 or runs past the read's length.
        valid: (B, S) bool.
    """
    b, length = codes.shape
    s = length - k + 1
    if s <= 0:
        raise ValueError(f"reads shorter than k={k}")
    c = codes.to(torch.int64)
    bad = c >= 4
    clean = torch.where(bad, 0, c)
    comp = 3 - clean
    fwd = torch.zeros((b, s), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for i in range(k):
        fwd <<= 2
        fwd |= clean[:, i:i + s]
        rc |= comp[:, i:i + s] << (2 * i)
    canon = torch.minimum(fwd, rc)  # k odd: fwd != rc, no ties
    n_bad = torch.nn.functional.pad(bad.to(torch.int32).cumsum(1), (1, 0))
    bad_in_window = n_bad[:, k:k + s] - n_bad[:, :s]
    starts = torch.arange(s, device=codes.device)
    valid = (bad_in_window == 0) & (
        starts[None, :] + k <= lengths[:, None].to(torch.int64))
    return torch.where(valid, canon, SENTINEL), valid


def sort_count(flat):
    """Distinct live keys of a flat (N,) int64 window stream, ascending,
    and their int64 counts; the sentinel is dropped (JAX ``sort_count``
    plus the StreamCounter's sentinel mask, engine.py:381)."""
    keys, counts = dedup_windows(flat)
    if keys.numel() and bool(keys[-1] == SENTINEL):
        keys, counts = keys[:-1], counts[:-1]
    return keys, counts


def dedup_windows(flat):
    """The batch dedup in front of the weighted tally: distinct keys of
    a flat (N,) int64 window stream, ascending (a sentinel row, if any,
    last), with int64 multiplicities as weights.  The int64 counterpart
    of the JAX dedup-first front half (``pallas_join._dedup_compact``),
    over the whole batch instead of 8,192-row local chunks."""
    return torch.unique(flat, sorted=True, return_counts=True)


def _locate(table, keys):
    """Lower-bound row of each key in the sorted *table* (clamped) and
    whether the key is a live key found there."""
    idx = torch.searchsorted(table, keys).clamp_(max=table.shape[0] - 1)
    return idx, (table[idx] == keys) & (keys != SENTINEL)


def weighted_tally(table, keys, weights, acc):
    """``acc[j] += sum(weights[i] : keys[i] == table[j])``, in place;
    returns *acc*.  *table*: (M,) int64 sorted (trailing sentinel rows
    allowed; they stay 0); *keys*, *weights*: (N,) int64; *acc*: (M,)
    int64.  The plain version of kernel K3."""
    if table.shape[0] == 0 or keys.numel() == 0:
        return acc
    idx, hit = _locate(table, keys)
    acc.index_add_(0, idx[hit], weights[hit])
    return acc


def small_table_tally(table, flat_keys):
    """Per-table-key hit counts of *flat_keys* against a sorted table.

    *table*: (M,) int64 sorted keys (sentinel rows allowed; they count
    0).  *flat_keys*: (N,) int64 window keys.  Returns (M,) int64.  The
    plain version of kernel K2.
    """
    counts = torch.zeros(table.shape[0], dtype=torch.int64,
                         device=table.device)
    return weighted_tally(table, flat_keys, torch.ones_like(flat_keys),
                          counts)


def member(table, keys):
    """(N,) bool: which *keys* are in the sorted (M,) int64 *table*;
    sentinel keys are never found.  The plain version of kernel K4
    (JAX ``small_table_member`` / ``lookup_sorted``)."""
    if table.shape[0] == 0:
        return torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    return _locate(table, keys)[1]


def find_rows(table, keys):
    """(N,) int64: the row of each key in the sorted (M,) int64 *table*,
    -1 where it is absent or a sentinel.  The plain version of kernel K4's
    row output (JAX ``lookup_sorted``'s positions)."""
    if table.shape[0] == 0:
        return torch.full(keys.shape, -1, dtype=torch.int64,
                          device=keys.device)
    idx, hit = _locate(table, keys)
    return torch.where(hit, idx, -1)


def small_tally_step(table, acc, codes, lengths, k):
    """One parent-scan step: extract → tally, added into *acc* in place
    (the JAX step returns a new array).  Returns *acc*."""
    keys, _valid = extract_canonical_windows(codes, lengths, k)
    acc += small_table_tally(table, keys.reshape(-1))
    return acc


def small_tally_steps(table, acc, codes_nb, lengths_nb, k):
    """:func:`small_tally_step` over NB stacked batches (NB, B, L)."""
    for codes, lengths in zip(codes_nb, lengths_nb):
        small_tally_step(table, acc, codes, lengths, k)
    return acc


def small_scan_hits_step(table, codes, lengths, k):
    """Anchoring step: (B, S) bool window hit mask of a read batch
    against *table* (extract → member)."""
    keys, _valid = extract_canonical_windows(codes, lengths, k)
    return member(table, keys.reshape(-1)).reshape(keys.shape)
