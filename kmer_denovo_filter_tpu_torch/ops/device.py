"""Plain PyTorch versions of the parent-scan step, on int64 keys.

Counterparts of :mod:`kmer_denovo_filter_tpu.ops.device`
(``extract_canonical_windows`` :33, ``small_table_tally`` :281,
``small_tally_step`` :337, ``small_tally_steps`` :351).  They run on
any device: the kernel wrappers (:mod:`.extract`, :mod:`.probe`) use
them for CPU tensors, the CPU tests hold them against the JAX
functions, and ``chip_smoke.py`` holds the CUDA kernels against them
on the card.

Keys are the right-aligned int64 form of :mod:`.keys`; invalid windows
hold :data:`~.keys.SENTINEL`.  The all-pairs sweep of the JAX package
becomes a binary search (``torch.searchsorted``) plus a scatter-add: on
a GPU the probe is O(N log M) where the TPU sweep was O(N·M).
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


def small_table_tally(table, flat_keys):
    """Per-table-key hit counts of *flat_keys* against a sorted table.

    *table*: (M,) int64 sorted keys (sentinel rows allowed; they count
    0).  *flat_keys*: (N,) int64 window keys.  Returns (M,) int64.
    """
    m = table.shape[0]
    counts = torch.zeros(m, dtype=torch.int64, device=table.device)
    if m == 0 or flat_keys.numel() == 0:
        return counts
    idx = torch.searchsorted(table, flat_keys).clamp_(max=m - 1)
    hit = (table[idx] == flat_keys) & (flat_keys != SENTINEL)
    rows = idx[hit]
    counts.index_add_(0, rows, torch.ones_like(rows))
    return counts


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
