"""Plain PyTorch versions of the engine's device steps, on int64 keys.

Counterparts of :mod:`kmer_denovo_filter_tpu.ops.device`
(``extract_canonical_windows`` :33, ``sort_count`` :121,
``small_table_tally`` :281, ``small_table_member`` :313,
``small_tally_step`` :337, ``small_tally_steps`` :351,
``small_scan_hits_step`` :368, ``lookup_sorted`` :657).  They run on
any device: the kernel wrappers (:mod:`.extract`, :mod:`.probe`,
:mod:`.member`, :mod:`.segsort`, :mod:`.sortcount`) use them for CPU
tensors, the CPU tests hold them against the JAX functions, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
:func:`dedup_windows` is no kernel's plain version: the whole-batch
dedup form of the experiments (``BatchDedupCounter``) calls it on every
device.

Keys are the right-aligned int64 form of :mod:`.keys`; invalid windows
hold :data:`~.keys.SENTINEL`, which is never found and never tallied.
The all-pairs sweeps and tile joins of the JAX package become a binary
search (``torch.searchsorted``): on a GPU the probe is O(N log M) where
the TPU sweep was O(N·M).

Wide keys (k = 33..207) are (N, Q) int64 limb rows.  Their functions
(``*_wide``, the plain versions of kernels K1w, K7, K8 and K9dw) reduce
rows to int64 ranks by :func:`unique_rows` (Q stable sorts) and then
search in one dimension.  The JAX wide path's route hash
(``pallas_join.route_hash_np``/``_route_hash``), tile partitions
(``build_tile_partitions_wide``), routing (``_route_wide``), the
log-shift compaction and ``u_chunk`` capacity of ``_dedup_compact_wide``
and VMEM window ladders (``max_wide_w_part_tally``/``_member``,
``wide_dd_w_part_cap``) are TPU workarounds with no counterpart: a
binary search has no window and no capacity that can overflow.
"""

import torch

from kmer_denovo_filter_tpu_torch.ops.keys import (
    BASES_PER_LIMB,
    SENTINEL,
    limb_bases,
)


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
    valid = _valid_windows(bad, lengths, k)
    return torch.where(valid, canon, SENTINEL), valid


def _valid_windows(bad, lengths, k):
    """(B, S) bool: window free of bad codes and inside its read."""
    s = bad.shape[1] - k + 1
    n_bad = torch.nn.functional.pad(bad.to(torch.int32).cumsum(1), (1, 0))
    bad_in_window = n_bad[:, k:k + s] - n_bad[:, :s]
    starts = torch.arange(s, device=bad.device)
    return (bad_in_window == 0) & (
        starts[None, :] + k <= lengths[:, None].to(torch.int64))


def sort_count(flat):
    """Distinct live keys of a flat (N,) int64 window stream, ascending,
    and their int64 counts; the sentinel is dropped (JAX ``sort_count``
    plus the StreamCounter's sentinel mask, engine.py:381).  The plain
    version of kernel K12 (``sortcount.sort_count``)."""
    keys, counts = dedup_windows(flat)
    if keys.numel() and bool(keys[-1] == SENTINEL):
        keys, counts = keys[:-1], counts[:-1]
    return keys, counts


def dedup_windows(flat):
    """A whole-batch dedup in front of the weighted tally: distinct keys
    of a flat (N,) int64 window stream, ascending (a sentinel row, if
    any, last), with int64 multiplicities as weights.  The int64
    counterpart of the JAX dedup-first front half
    (``pallas_join._dedup_compact``), over the whole batch instead of
    8,192-row local chunks (kernel K9d, ``segsort.seg_dedup``, is the
    segment-local form the engine runs at k <= 31)."""
    return torch.unique(flat, sorted=True, return_counts=True)


def segment_sort(keys, payload=None):
    """Each row of (S, 8192) int64 *keys* sorted ascending, an (S, 8192)
    int32 *payload* gathered along: the plain version of kernel K9
    (``segsort.seg_sort``).  Returns (keys, payload or None)."""
    srt, order = torch.sort(keys, dim=1)
    return srt, None if payload is None else torch.gather(payload, 1, order)


def segment_runs(keys):
    """Per-row run-length count of (S, 8192) int64 *keys*: the plain
    version of kernel K9d (``segsort.seg_dedup``).  Returns (S, 8192)
    int64 keys and weights and (S,) int32 counts: row s holds its
    counts[s] distinct live keys ascending with their multiplicities at
    the front, then :data:`SENTINEL` keys of weight 0.  Sentinel keys
    form no run."""
    srt = torch.sort(keys, dim=1).values
    live = srt != SENTINEL
    start = live.clone()
    start[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    counts = start.sum(1)
    seg, col = start.nonzero(as_tuple=True)  # row-major: by segment, then col
    rank = start.cumsum(1)[seg, col] - 1
    last = rank == counts[seg] - 1
    nxt = torch.where(last, live.sum(1)[seg], torch.roll(col, -1))
    out_keys = torch.full_like(srt, SENTINEL)
    out_weights = torch.zeros_like(srt)
    out_keys[seg, rank] = srt[seg, col]
    out_weights[seg, rank] = nxt - col
    return out_keys, out_weights, counts.to(torch.int32)


def segment_compact(keys, weights, counts):
    """The first counts[s] rows of each row s of (S, 8192) *keys* and
    *weights* (kernel K9d's slots; (S, 8192, Q) keys for K9dw's), as one
    (U,) stream of keys ((U, Q) rows) and one of weights, in row order.
    On the card the boolean gather reads the total back to the host (a
    sync); kernels K3 and K7 read the slots in place and need none of
    it."""
    live = (torch.arange(keys.shape[1], device=keys.device)[None, :]
            < counts[:, None])
    return keys[live], weights[live]


def _locate(table, keys):
    """Lower-bound row of each key in the sorted *table* (clamped) and
    whether the key is a live key found there."""
    idx = torch.searchsorted(table, keys).clamp_(max=table.shape[0] - 1)
    return idx, (table[idx] == keys) & (keys != SENTINEL)


def weighted_tally(table, keys, weights, acc):
    """``acc[j] += sum(weights[i] : keys[i] == table[j])``, in place;
    returns *acc*.  *table*: (M,) int64 sorted (trailing sentinel rows
    allowed; they stay 0); *keys*, *weights*: (N,) int64; *acc*: (M,)
    int64.  The plain version of kernel K3 (of its slots form after
    :func:`segment_compact`)."""
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


# ── wide keys (k = 33..207): (N, Q) int64 limb rows (ops/keys.py) ──────


def extract_canonical_windows_wide(codes, lengths, k):
    """Canonical limb rows of every window of a padded read batch.

    The wide counterpart of :func:`extract_canonical_windows` (JAX
    ``extract_canonical_windows``, its W >= 3 branch), for any odd k the
    keys carry.  Like the JAX function it packs once per position and
    slices per limb: ``pack[t]`` holds bases t .. t + 30 and ``rpack[u]``
    the complements of bases u, u - 1, .., u - 30, so forward limb j of
    window t is ``pack[t + 31j]`` and reverse-complement limb j (bases
    ``3 - base[k - 1 - i]``, i = 31j ..) is ``rpack[t + k - 1 - 31j]``,
    a short last limb shifted down.  The canonical key is the
    lexicographic minimum of the two limb rows.

    Returns:
        keys: (B, S, Q) int64; a row of :data:`SENTINEL` where the
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
    span = BASES_PER_LIMB - 1
    ahead = torch.nn.functional.pad(clean, (0, span))
    behind = torch.nn.functional.pad(3 - clean, (span, 0))
    pack = torch.zeros((b, length), dtype=torch.int64, device=codes.device)
    rpack = torch.zeros_like(pack)
    for i in range(BASES_PER_LIMB):
        pack |= ahead[:, i:i + length] << (2 * (span - i))
        rpack |= behind[:, span - i:span - i + length] << (2 * (span - i))
    fwd, rc = [], []
    for j, nb in enumerate(limb_bases(k)):
        drop = 2 * (BASES_PER_LIMB - nb)
        first = BASES_PER_LIMB * j
        fwd.append(pack[:, first:first + s] >> drop)
        rc.append(rpack[:, k - 1 - first:k - 1 - first + s] >> drop)
    lt = torch.zeros((b, s), dtype=torch.bool, device=codes.device)
    eq = torch.ones_like(lt)
    for f, r in zip(fwd, rc):
        lt |= eq & (f < r)
        eq &= f == r
    valid = _valid_windows(bad, lengths, k)
    keys = torch.stack([torch.where(valid, torch.where(lt, f, r), SENTINEL)
                        for f, r in zip(fwd, rc)], dim=-1)
    return keys, valid


def lexsort_rows(rows):
    """Permutation sorting (N, Q) int64 *rows* lexicographically: Q
    stable sorts, from the last limb to the first."""
    order = torch.arange(rows.shape[0], device=rows.device)
    for j in range(rows.shape[1] - 1, -1, -1):
        order = order[torch.sort(rows[order, j], stable=True).indices]
    return order


def unique_rows(rows):
    """``torch.unique(rows, dim=0, sorted=True, return_inverse=True,
    return_counts=True)`` by :func:`lexsort_rows`: the distinct rows
    ascending, each input row's index among them, and their counts."""
    n = rows.shape[0]
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=rows.device)
        return rows, empty, empty
    order = lexsort_rows(rows)
    srt = rows[order]
    new = torch.ones(n, dtype=torch.bool, device=rows.device)
    new[1:] = (srt[1:] != srt[:-1]).any(1)
    inverse = torch.empty_like(order)
    inverse[order] = new.cumsum(0) - 1
    starts = new.nonzero().squeeze(1)
    counts = torch.diff(starts, append=starts.new_tensor([n]))
    return srt[starts], inverse, counts


def dedup_windows_wide(flat):
    """Distinct rows of a flat (N, Q) window stream, ascending (a
    sentinel row, if any, last), with int64 multiplicities: the JAX
    dedup-first front half, ``pallas_join._dedup_compact_wide``, over
    the whole batch (kernel K9dw, ``segsort.seg_dedup_wide``, is the
    segment-local form the engine runs in front of K7 weighted)."""
    uniq, _inverse, counts = unique_rows(flat)
    return uniq, counts


def segment_runs_wide(rows):
    """Per-segment run-length count of (S, 8192, Q) limb rows: the plain
    version of kernel K9dw (``segsort.seg_dedup_wide``).  Returns
    (S, 8192, Q) int64 keys, (S, 8192) int64 weights and (S,) int32
    counts: segment s holds its counts[s] distinct live rows ascending
    with their multiplicities at the front, then :data:`SENTINEL` rows of
    weight 0.  Sentinel rows form no run."""
    s, seg, q = rows.shape
    sid = torch.arange(s, device=rows.device).repeat_interleave(seg)
    uniq, _inverse, weights = unique_rows(
        torch.cat([sid[:, None], rows.reshape(-1, q)], 1))
    live = uniq[:, 1] != SENTINEL
    uniq, weights = uniq[live], weights[live]
    useg = uniq[:, 0]
    counts = torch.bincount(useg, minlength=s)
    rank = (torch.arange(useg.shape[0], device=rows.device)
            - (counts.cumsum(0) - counts)[useg])
    out_keys = torch.full_like(rows, SENTINEL)
    out_weights = torch.zeros((s, seg), dtype=torch.int64,
                              device=rows.device)
    out_keys[useg, rank] = uniq[:, 1:]
    out_weights[useg, rank] = weights
    return out_keys, out_weights, counts.to(torch.int32)


def sort_count_wide(flat):
    """Distinct live rows of a flat (N, Q) window stream, ascending,
    and their int64 counts; the sentinel row is dropped (JAX
    ``sort_count`` for W >= 3 plus the StreamCounter's sentinel mask).
    The plain version of kernel K12 on rows
    (``sortcount.sort_count_wide``)."""
    keys, counts = dedup_windows_wide(flat)
    if keys.shape[0] and bool(keys[-1, 0] == SENTINEL):
        keys, counts = keys[:-1], counts[:-1]
    return keys, counts


def _locate_wide(table, keys):
    """Row of each (N, Q) key in the sorted (M, Q) *table* (clamped) and
    whether it is a live key found there: rows become int64 ranks over
    table and keys together, then a 1-D search."""
    m = table.shape[0]
    ranks = unique_rows(torch.cat([table, keys]))[1]
    table_ranks, key_ranks = ranks[:m], ranks[m:]
    idx = torch.searchsorted(table_ranks, key_ranks).clamp_(max=m - 1)
    return idx, (table_ranks[idx] == key_ranks) & (keys[:, 0] != SENTINEL)


def weighted_tally_wide(table, keys, weights, acc):
    """``acc[j] += sum(weights[i] : keys[i] == table[j])`` over limb rows,
    in place; returns *acc*.  *table*: (M, Q) int64 sorted (trailing
    sentinel rows allowed); *keys*: (N, Q); *weights*: (N,) int64;
    *acc*: (M,) int64.  The plain version of kernel K7, weighted (of its
    slots form after :func:`segment_compact`)."""
    if table.shape[0] == 0 or keys.shape[0] == 0:
        return acc
    idx, hit = _locate_wide(table, keys)
    acc.index_add_(0, idx[hit], weights[hit])
    return acc


def small_table_tally_wide(table, flat_keys):
    """(M,) int64 hit counts of (N, Q) *flat_keys* per row of the sorted
    (M, Q) *table*: the plain version of kernel K7, unweighted (JAX
    ``join_tally_flat_wide``)."""
    counts = torch.zeros(table.shape[0], dtype=torch.int64,
                         device=table.device)
    ones = torch.ones(flat_keys.shape[0], dtype=torch.int64,
                      device=flat_keys.device)
    return weighted_tally_wide(table, flat_keys, ones, counts)


def member_wide(table, keys):
    """(N,) bool: which (N, Q) *keys* are rows of the sorted (M, Q)
    *table*; sentinel keys are never found.  The plain version of kernel
    K8 (JAX ``join_member_step_wide``'s found bits)."""
    if table.shape[0] == 0:
        return torch.zeros(keys.shape[0], dtype=torch.bool,
                           device=keys.device)
    return _locate_wide(table, keys)[1]


def find_rows_wide(table, keys):
    """(N,) int64: the table row of each (N, Q) key, -1 where it is
    absent or a sentinel.  The plain version of K8's row output."""
    if table.shape[0] == 0:
        return torch.full((keys.shape[0],), -1, dtype=torch.int64,
                          device=keys.device)
    idx, hit = _locate_wide(table, keys)
    return torch.where(hit, idx, -1)
