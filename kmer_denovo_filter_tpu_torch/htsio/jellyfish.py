# Copied from kmer_denovo_filter_tpu/htsio/jellyfish.py
"""Jellyfish 2 ``binary/sorted`` index support (``--ref-jf`` compat + export).

Reference users pass prebuilt ``.jf`` reference indexes
(``--ref-jf``, reference cli.py:173 and tests/conftest.py:103).  The
``binary/sorted`` format — what ``jellyfish count -o`` writes when the
table fits one chunk — is a JSON header followed by fixed-width
(key, count) records, so it can be ingested directly into the device
key representation.  The mmap'd ``binary/hash`` format (huge WGS
indexes) is not parsed; callers fall back to rebuilding from the
reference FASTA, which yields an identical canonical k-mer set.
"""

import json

import numpy as np


class JellyfishParseError(ValueError):
    pass


def read_jf_header(path):
    """Return (header_dict, data_offset) for a .jf file."""
    with open(path, "rb") as fh:
        prefix = fh.read(9)
        if len(prefix) < 9 or not prefix.isdigit():
            raise JellyfishParseError(f"not a jellyfish file: {path}")
        hlen = int(prefix)
        hdr = fh.read(hlen)
    try:
        meta = json.loads(hdr.decode("utf-8", "replace").rstrip("\x00"))
    except json.JSONDecodeError as e:
        raise JellyfishParseError(f"bad jellyfish header in {path}: {e}")
    return meta, 9 + hlen


def load_sorted_jf(path, expect_k=None):
    """Load a ``binary/sorted`` .jf index into (keys, counts).

    Returns ``(keys, counts, k)`` where *keys* is the engine's
    (N, W) uint32 big-endian word representation in FILE order (which
    is jellyfish's internal matrix-hash order, NOT numeric key order —
    callers sort before building an index) and *counts* is int64.
    """
    meta, off = read_jf_header(path)
    if meta.get("format") != "binary/sorted":
        raise JellyfishParseError(
            f"unsupported jellyfish format {meta.get('format')!r} in {path}"
        )
    key_len = meta["key_len"]          # bits = 2k
    k = key_len // 2
    if expect_k is not None and k != expect_k:
        raise JellyfishParseError(
            f"{path} is a k={k} index, expected k={expect_k}")
    key_bytes = (key_len + 7) // 8
    if key_bytes > 8:
        raise JellyfishParseError(
            f"{path}: k={k} sorted .jf keys exceed 64 bits; rebuild "
            f"the reference set from FASTA instead")
    # fixed-width little-endian count; real files carry the width in
    # counter_len (bytes) — 4 observed from jellyfish 2.x `count`
    val_bytes = int(meta.get("counter_len", 4))
    rec = key_bytes + val_bytes
    data = np.fromfile(path, dtype=np.uint8, offset=off)
    n = data.shape[0] // rec
    data = data[:n * rec].reshape(n, rec)
    # key: little-endian integer, bases packed big-endian within 2k bits
    key_le = data[:, :key_bytes].astype(np.uint64)
    keys_int = np.zeros(n, dtype=np.uint64)
    for b in range(key_bytes):
        keys_int |= key_le[:, b] << np.uint64(8 * b)
    counts = data[:, key_bytes:].astype(np.uint64)
    cvals = np.zeros(n, dtype=np.int64)
    for b in range(val_bytes):
        cvals |= counts[:, b].astype(np.int64) << (8 * b)
    # Convert to the engine layout: 32W-bit left-aligned words.
    from kmer_denovo_filter_tpu_torch.ops.encode import words_per_kmer
    w = words_per_kmer(k)
    shifted = keys_int << np.uint64(32 * w - key_len)
    keys = np.zeros((n, w), dtype=np.uint32)
    for j in range(w):
        keys[:, j] = (shifted >> np.uint64(32 * (w - 1 - j))).astype(
            np.uint32)
    return keys, cvals, k


def write_sorted_jf(path, keys, counts, k):
    """Write a ``binary/sorted`` .jf file from engine-layout keys.

    The exact inverse of :func:`load_sorted_jf`: 9-digit ASCII header
    length + JSON metadata + fixed-width little-endian (key, count)
    records, so exported indexes interoperate with jellyfish-ecosystem
    tooling and round-trip losslessly through this module (the export
    analog of the reference's cached ``{ref}.k{k}.jf`` artifacts,
    reference core/jellyfish_wrappers.py:286-332).  k <= 31 only (the
    format's sorted variant carries <= 64-bit keys).
    """
    from kmer_denovo_filter_tpu_torch.ops.encode import words_per_kmer
    key_len = 2 * k
    key_bytes = (key_len + 7) // 8
    if key_bytes > 8:
        raise JellyfishParseError(
            f"binary/sorted .jf keys are <= 64 bits (k <= 31); got "
            f"k={k}")
    w = words_per_kmer(k)
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n = keys.shape[0]
    # engine layout (32W-bit left-aligned words) -> right-aligned int
    packed = np.zeros(n, dtype=np.uint64)
    for j in range(w):
        packed |= keys[:, j].astype(np.uint64) << np.uint64(
            32 * (w - 1 - j))
    packed >>= np.uint64(32 * w - key_len)
    order = np.argsort(packed, kind="stable")
    packed = packed[order]
    cvals = np.asarray(counts, dtype=np.int64)[order]
    meta = {
        "alignment": 8, "canonical": True,
        "cmdline": "kmer_denovo_filter_tpu export",
        "counter_len": 4, "format": "binary/sorted",
        "key_len": key_len, "max_reprobe": 126,
        "size": max(16, 1 << (n - 1).bit_length() if n else 4),
        "val_len": 4,
    }
    hdr = json.dumps(meta, sort_keys=True).encode()
    rec = np.zeros((n, key_bytes + 4), dtype=np.uint8)
    for b in range(key_bytes):
        rec[:, b] = (packed >> np.uint64(8 * b)).astype(np.uint8)
    for b in range(4):
        rec[:, key_bytes + b] = ((cvals >> (8 * b)) & 0xFF).astype(
            np.uint8)
    with open(path, "wb") as fh:
        fh.write(f"{len(hdr):09d}".encode())
        fh.write(hdr)
        fh.write(rec.tobytes())


# ── binary/hash (quotiented matrix-hash array) ─────────────────────
#
# Jellyfish's mmap'd hash files (the WGS-scale intermediates) store an
# open-addressing array rather than sorted records: an invertible
# GF(2) bit-matrix M maps each key to M·k, the low l = log2(size)
# bits select the slot, and only the high (key_len − l) quotient bits
# are stored in it (plus the reprobe step that displaced the entry
# from its home slot).  Readers recover M·k from (slot, step,
# quotient) and multiply by M⁻¹.
#
# Layout implemented here (documented + conformance-tested; byte
# parity with a real jellyfish WGS hash file is untestable in this
# environment — no jellyfish binary, no network — so the loader is
# gated on the header fields it understands and errors verbosely
# otherwise):
#   header: 9-digit ASCII length + JSON with format "binary/hash",
#     key_len (bits), val_len (count bytes), size (slots, power of
#     two), matrix1 {"c": key_len, "columns": [key_len-bit ints]},
#     reprobes (displacement table), max_reprobe.
#   data: `size` consecutive slots, each
#     1 byte  status (0 empty / 1 occupied)
#     1 byte  reprobe step index
#     Q bytes little-endian quotient, Q = ceil((key_len − l) / 8)
#     val_len bytes little-endian count.


def _matrix_apply(columns, keys_int, key_len):
    """y = M·x over GF(2), both vectors LSB-first integers: bit i of
    *x* selects ``columns[i]``; bit r of *y* is output row r (and
    ``columns[i]`` encodes M[r][i] at bit r)."""
    out = np.zeros_like(keys_int)
    for i, col in enumerate(columns):
        bit = (keys_int >> np.uint64(i)) & np.uint64(1)
        out ^= np.where(bit.astype(bool), np.uint64(col),
                        np.uint64(0))
    return out


def _matrix_invert(columns, key_len):
    """Columns of M⁻¹ (Gauss–Jordan over GF(2) on int-encoded columns)."""
    # row r of M as an LSB-first integer: bit i = M[r][i]
    rows = []
    inv_rows = []
    for r in range(key_len):
        acc = 0
        for i in range(key_len):
            acc |= ((columns[i] >> r) & 1) << i
        rows.append(acc)
        inv_rows.append(1 << r)  # identity row r
    for col in range(key_len):
        mask = 1 << col
        pivot = next((r for r in range(col, key_len)
                      if rows[r] & mask), None)
        if pivot is None:
            raise JellyfishParseError("matrix1 is singular")
        rows[col], rows[pivot] = rows[pivot], rows[col]
        inv_rows[col], inv_rows[pivot] = inv_rows[pivot], inv_rows[col]
        for r in range(key_len):
            if r != col and (rows[r] & mask):
                rows[r] ^= rows[col]
                inv_rows[r] ^= inv_rows[col]
    # rows is now I, inv_rows holds M⁻¹'s rows; re-encode as columns
    cols_out = []
    for i in range(key_len):
        acc = 0
        for r in range(key_len):
            acc |= ((inv_rows[r] >> i) & 1) << r
        cols_out.append(acc)
    return cols_out


def _random_invertible_columns(key_len, rng):
    while True:
        cols = [int(rng.integers(1, 1 << key_len, dtype=np.uint64))
                for _ in range(key_len)]
        try:
            _matrix_invert(cols, key_len)
            return cols
        except JellyfishParseError:
            continue


DEFAULT_REPROBES = [0, 1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 66, 78,
                    91, 105, 120]


def write_hash_jf(path, keys, counts, k, size=None, seed=0):
    """Write a ``binary/hash`` .jf from engine-layout keys (k ≤ 31)."""
    key_len = 2 * k
    if key_len > 62:
        raise JellyfishParseError("hash .jf writer supports k <= 31")
    from kmer_denovo_filter_tpu_torch.ops.encode import words_per_kmer
    w = words_per_kmer(k)
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n = keys.shape[0]
    packed = np.zeros(n, dtype=np.uint64)
    for j in range(w):
        packed |= keys[:, j].astype(np.uint64) << np.uint64(
            32 * (w - 1 - j))
    packed >>= np.uint64(32 * w - key_len)
    if size is None:
        size = max(16, 1 << int(np.ceil(np.log2(max(n, 1) * 2))))
    l = int(np.log2(size))
    rng = np.random.default_rng(seed)
    columns = _random_invertible_columns(key_len, rng)
    mk = _matrix_apply(columns, packed, key_len)
    home = (mk & np.uint64(size - 1)).astype(np.int64)
    quot = (mk >> np.uint64(l)).astype(np.uint64)

    q_bytes = max(1, (key_len - l + 7) // 8)
    val_len = 4
    slot_nb = 2 + q_bytes + val_len
    data = np.zeros(size * slot_nb, dtype=np.uint8)
    cvals = np.asarray(counts, dtype=np.int64)
    for i in range(n):
        placed = False
        for step, off in enumerate(DEFAULT_REPROBES):
            s = (int(home[i]) + off) % size
            base = s * slot_nb
            if data[base] == 0:
                data[base] = 1
                data[base + 1] = step
                q = int(quot[i])
                for b in range(q_bytes):
                    data[base + 2 + b] = (q >> (8 * b)) & 0xFF
                c = int(cvals[i])
                for b in range(val_len):
                    data[base + 2 + q_bytes + b] = (c >> (8 * b)) & 0xFF
                placed = True
                break
        if not placed:
            return write_hash_jf(path, keys, counts, k, size=size * 2,
                                 seed=seed)
    meta = {
        "alignment": 8, "canonical": True,
        "cmdline": "kmer_denovo_filter_tpu hash export",
        "counter_len": val_len, "format": "binary/hash",
        "key_len": key_len,
        "matrix1": {"c": key_len, "columns": columns},
        "max_reprobe": len(DEFAULT_REPROBES) - 1,
        "reprobes": DEFAULT_REPROBES,
        "size": size, "val_len": val_len,
    }
    hdr = json.dumps(meta, sort_keys=True).encode()
    with open(path, "wb") as fh:
        fh.write(f"{len(hdr):09d}".encode())
        fh.write(hdr)
        fh.write(data.tobytes())


def load_hash_jf(path, expect_k=None):
    """Load a ``binary/hash`` .jf into engine-layout (keys, counts, k).

    Keys return in slot order (callers sort); inverts the header's
    matrix1 to reconstruct each stored key from its slot, reprobe
    step and quotient.
    """
    meta, off = read_jf_header(path)
    if meta.get("format") != "binary/hash":
        raise JellyfishParseError(
            f"unsupported jellyfish format {meta.get('format')!r} "
            f"in {path}")
    key_len = meta["key_len"]
    k = key_len // 2
    if expect_k is not None and k != expect_k:
        raise JellyfishParseError(
            f"{path} is a k={k} index, expected k={expect_k}")
    if key_len > 62:
        raise JellyfishParseError("hash .jf loader supports k <= 31")
    size = meta["size"]
    if size & (size - 1):
        raise JellyfishParseError(f"{path}: size {size} not a power "
                                  "of two")
    l = int(np.log2(size))
    columns = meta["matrix1"]["columns"]
    if len(columns) != key_len:
        raise JellyfishParseError(f"{path}: matrix1 has "
                                  f"{len(columns)} columns, expected "
                                  f"{key_len}")
    reprobes = meta.get("reprobes", DEFAULT_REPROBES)
    val_len = int(meta.get("val_len", meta.get("counter_len", 4)))
    q_bytes = max(1, (key_len - l + 7) // 8)
    slot_nb = 2 + q_bytes + val_len

    data = np.fromfile(path, dtype=np.uint8, offset=off)
    if data.shape[0] < size * slot_nb:
        raise JellyfishParseError(f"{path}: truncated hash array")
    slots = data[:size * slot_nb].reshape(size, slot_nb)
    occ = slots[:, 0] == 1
    steps = slots[occ, 1].astype(np.int64)
    if steps.size and steps.max() >= len(reprobes):
        raise JellyfishParseError(f"{path}: reprobe step out of range")
    idx = np.nonzero(occ)[0]
    quot = np.zeros(idx.shape[0], dtype=np.uint64)
    for b in range(q_bytes):
        quot |= slots[occ, 2 + b].astype(np.uint64) << np.uint64(8 * b)
    cvals = np.zeros(idx.shape[0], dtype=np.int64)
    for b in range(val_len):
        cvals |= slots[occ, 2 + q_bytes + b].astype(np.int64) << (8 * b)
    offs = np.asarray(reprobes, dtype=np.int64)[steps]
    home = (idx - offs) % size
    mk = (quot << np.uint64(l)) | home.astype(np.uint64)
    inv_cols = _matrix_invert(columns, key_len)
    keys_int = _matrix_apply(inv_cols, mk, key_len)

    from kmer_denovo_filter_tpu_torch.ops.encode import words_per_kmer
    w = words_per_kmer(k)
    shifted = keys_int << np.uint64(32 * w - key_len)
    keys = np.zeros((keys_int.shape[0], w), dtype=np.uint32)
    for j in range(w):
        keys[:, j] = (shifted >> np.uint64(32 * (w - 1 - j))).astype(
            np.uint32)
    return keys, cvals, k


def load_jf(path, expect_k=None):
    """Load any supported .jf variant: dispatch on the header format."""
    meta, _off = read_jf_header(path)
    fmt = meta.get("format")
    if fmt == "binary/sorted":
        return load_sorted_jf(path, expect_k=expect_k)
    if fmt == "binary/hash":
        return load_hash_jf(path, expect_k=expect_k)
    raise JellyfishParseError(
        f"unsupported jellyfish format {fmt!r} in {path}")
