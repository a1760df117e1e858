# Copied from kmer_denovo_filter_tpu/ops/encode.py
"""Host-side (numpy) k-mer key packing and string codecs.

Key representation used across the whole engine:

* A k-mer is packed into ``W = ceil(2k / 32)`` uint32 words,
  **big-endian by base**: base 0 occupies bits 31..30 of word 0,
  base 16 occupies bits 31..30 of word 1, and so on.  Unused trailing
  bits of the last word are zero.
* With A=0 < C=1 < G=2 < T=3, lexicographic comparison of k-mer
  strings equals numeric comparison of the packed words in word order,
  so the canonical form (min of forward and reverse complement,
  reference kmer_utils.py:35–38) is the word-wise minimum.
* Because k must be odd (reference utils.py:307), 2k is never a
  multiple of 32, so a real canonical key can never be all-ones in
  every word; the all-ones pattern is reserved as the invalid/padding
  sentinel that sorts after every real key.

This module is pure numpy; the jnp twin lives in
:mod:`kmer_denovo_filter_tpu_torch.ops.device`.
"""

import numpy as np

BASE_CODES = {"A": 0, "C": 1, "G": 2, "T": 3}
_CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# ASCII byte -> 2-bit code, 4 for anything else (N, lowercase handled)
ASCII_TO_CODE = np.full(256, 4, dtype=np.uint8)
for _b, _c in BASE_CODES.items():
    ASCII_TO_CODE[ord(_b)] = _c
    ASCII_TO_CODE[ord(_b.lower())] = _c


def words_per_kmer(k):
    return (2 * k + 31) // 32


def strings_to_codes(kmers, k):
    """(N, k) uint8 code matrix from equal-length k-mer strings."""
    if not kmers:
        return np.zeros((0, k), dtype=np.uint8)
    buf = np.frombuffer("".join(kmers).encode("ascii"), dtype=np.uint8)
    return ASCII_TO_CODE[buf].reshape(len(kmers), k)


def pack_codes(codes):
    """Pack (N, k) 2-bit codes into (N, W) uint32 words (big-endian)."""
    n, k = codes.shape
    w = words_per_kmer(k)
    out = np.zeros((n, w), dtype=np.uint32)
    c = codes.astype(np.uint32)
    for i in range(k):
        word = i // 16
        shift = 2 * (15 - (i % 16))
        out[:, word] |= (c[:, i] & 3) << shift
    return out


def rc_codes(codes):
    """Reverse-complement of (N, k) code rows (3 - code; 4/N stays odd)."""
    comp = (3 - codes.astype(np.int16)).astype(np.uint8)
    comp[codes >= 4] = 4
    return comp[:, ::-1]


def canonical_keys(codes):
    """Canonical packed keys + validity for (N, k) code rows."""
    valid = ~(codes >= 4).any(axis=1)
    fwd = pack_codes(codes)
    rev = pack_codes(rc_codes(np.where(codes[:, :] >= 4, 0, codes)))
    # restore: rc of masked N is meaningless but valid=False there
    canon = np.where(_lex_less(fwd, rev)[:, None], fwd, rev)
    canon[~valid] = np.uint32(0xFFFFFFFF)
    return canon, valid


def _lex_less(a, b):
    """Row-wise lexicographic a < b for (N, W) uint32 arrays."""
    n, w = a.shape
    lt = np.zeros(n, dtype=bool)
    eq = np.ones(n, dtype=bool)
    for j in range(w):
        lt |= eq & (a[:, j] < b[:, j])
        eq &= a[:, j] == b[:, j]
    return lt | eq  # ties (palindrome-free since k odd) pick fwd


def kmers_to_keys(kmers, k):
    """Canonical packed keys for canonical k-mer strings.

    Input strings are assumed already canonical (as produced by
    :func:`kmer_denovo_filter_tpu_torch.kmer.canonicalize`); they are packed
    directly without re-canonicalising.
    """
    codes = strings_to_codes(kmers, k)
    return pack_codes(codes)


def keys_to_kmers(keys, k):
    """Decode (N, W) packed keys back to k-mer strings."""
    n = keys.shape[0]
    codes = np.zeros((n, k), dtype=np.uint8)
    for i in range(k):
        word = i // 16
        shift = 2 * (15 - (i % 16))
        codes[:, i] = (keys[:, word] >> shift) & 3
    chars = _CODE_TO_BASE[codes]
    return [bytes(row).decode("ascii") for row in chars]


def lexsort_keys(keys):
    """Indices sorting (N, W) uint32 keys lexicographically by row."""
    cols = [keys[:, j] for j in range(keys.shape[1] - 1, -1, -1)]
    return np.lexsort(cols)


def unique_with_counts(keys, weights=None):
    """Sorted unique rows of (N, W) keys + summed counts (numpy path)."""
    if keys.shape[0] == 0:
        return keys, np.zeros(0, dtype=np.int64)
    order = lexsort_keys(keys)
    s = keys[order]
    newgrp = np.empty(s.shape[0], dtype=bool)
    newgrp[0] = True
    newgrp[1:] = (s[1:] != s[:-1]).any(axis=1)
    group = np.cumsum(newgrp) - 1
    if weights is None:
        counts = np.bincount(group).astype(np.int64)
    else:
        counts = np.bincount(group, weights=weights[order]).astype(np.int64)
    return s[newgrp], counts


def searchsorted_rows(sorted_keys, queries):
    """Row-wise searchsorted: index of each query row in sorted_keys.

    Returns ``(idx, found)``.  Implemented by packing the W uint32
    words into a single comparable void/structured view.
    """
    m, w = sorted_keys.shape
    if m == 0:
        return (np.zeros(queries.shape[0], dtype=np.int64),
                np.zeros(queries.shape[0], dtype=bool))
    big_s = _to_big(sorted_keys)
    big_q = _to_big(queries)
    idx = np.searchsorted(big_s, big_q)
    found = np.zeros(queries.shape[0], dtype=bool)
    inb = idx < m
    found[inb] = big_s[idx[inb]] == big_q[inb]
    return idx, found


def _to_big(keys):
    """Pack (N, W) uint32 rows into sortable big integers."""
    w = keys.shape[1]
    out = keys[:, 0].astype(object)
    for j in range(1, w):
        out = out * 4294967296 + keys[:, j].astype(object)
    if w <= 2:  # fits uint64 exactly
        out64 = (keys[:, 0].astype(np.uint64) << np.uint64(32))
        if w == 2:
            out64 |= keys[:, 1].astype(np.uint64)
        return out64
    return out
