# Copied from kmer_denovo_filter_tpu/htsio/native.py
"""ctypes bridge to the C++ host accelerator (kdf_native).

Builds ``kdf_native.so`` with g++ on first use, from the port's own
``_native/kdf_native.cpp``, into the package's gitignored
``build/native/<sha256 of the source>/`` directory (the cache rule of
``ops/_cuda.py``): nothing is ever written next to the source, and a
stale or foreign binary is never loaded.  Exposes:

* :func:`bgzf_inflate` — thread-parallel BGZF decompression (the
  ``samtools -@ N`` analog).
* :func:`bam_scan` — BAM record scan into flat numpy arrays.
* :func:`bam_codes` — 2-bit base-code extraction for the device
  input pipeline, skipping flag-excluded records.

Every entry point degrades gracefully: when the toolchain or build is
unavailable, ``AVAILABLE`` is False and callers use the pure-Python
path (identical semantics, validated by tests/test_native.py).
"""

import ctypes
import logging
import os
import subprocess

import numpy as np

logger = logging.getLogger(__name__)

_DIR = os.path.join(os.path.dirname(__file__), "_native")
_SRC = os.path.join(_DIR, "kdf_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "native")

_lib = None
AVAILABLE = False


def available():
    """Build/load the native library if needed and report success.

    ``AVAILABLE`` only reflects the *last* load attempt; callers that
    may run before any native entry point has been touched must use
    this accessor instead of reading the flag.
    """
    return _load()


def _src_hash():
    import hashlib
    with open(_SRC, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


class _InflateResult(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_int64),
                ("error", ctypes.c_int32)]


def _build(lib_path):
    """Compile the source to *lib_path* (write-then-rename, so a
    concurrent loader never sees a partial library)."""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", tmp_path, "-lz"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.debug("kdf_native build failed to launch: %s", e)
        return False
    if res.returncode != 0:
        logger.warning("kdf_native build failed: %s", res.stderr[:500])
        return False
    os.replace(tmp_path, lib_path)
    return True


def _load():
    global _lib, AVAILABLE
    if _lib is not None:
        return AVAILABLE
    try:
        lib_path = os.path.join(_BUILD_DIR, _src_hash(), "kdf_native.so")
        if not os.path.isfile(lib_path) and not _build(lib_path):
            AVAILABLE = False
            _lib = False
            return False
        lib = ctypes.CDLL(lib_path)
        lib.bgzf_inflate_file.restype = _InflateResult
        lib.bgzf_inflate_file.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.kdf_free.argtypes = [ctypes.c_void_p]
        lib.bam_count_records.restype = ctypes.c_int64
        lib.bam_count_records.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.bam_scan_records.restype = ctypes.c_int32
        lib.bam_extract_codes.restype = ctypes.c_int64
        lib.kdf_ht_build.restype = ctypes.c_void_p
        lib.kdf_ht_build.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
        lib.kdf_ht_free.argtypes = [ctypes.c_void_p]
        lib.kdf_ht_tally.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.kdf_ht_member.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        _lib = lib
        AVAILABLE = True
    except OSError as e:
        logger.debug("kdf_native unavailable: %s", e)
        _lib = False
        AVAILABLE = False
    return AVAILABLE


def bgzf_inflate(path, threads=None):
    """Decompress a whole BGZF file; returns bytes or None on failure."""
    if not _load():
        return None
    if threads is None:
        threads = min(os.cpu_count() or 1, 16)
    res = _lib.bgzf_inflate_file(path.encode(), int(threads))
    if res.error != 0:
        logger.debug("bgzf_inflate_file(%s) error=%d", path, res.error)
        return None
    try:
        out = ctypes.string_at(res.data, res.size)
    finally:
        _lib.kdf_free(res.data)
    return out


def bam_scan(data, body_offset):
    """Scan BAM records starting at *body_offset* of inflated *data*.

    Returns a dict of numpy arrays: rec_offsets, rec_sizes, tids, poss,
    flags, mapqs, l_seqs, ref_spans — or None when unavailable.
    """
    if not _load():
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    body = buf[body_offset:]
    ptr = body.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    n = _lib.bam_count_records(ptr, body.shape[0])
    arrays = {
        "rec_offsets": np.zeros(n, dtype=np.int64),
        "rec_sizes": np.zeros(n, dtype=np.int32),
        "tids": np.zeros(n, dtype=np.int32),
        "poss": np.zeros(n, dtype=np.int32),
        "flags": np.zeros(n, dtype=np.uint16),
        "mapqs": np.zeros(n, dtype=np.uint8),
        "l_seqs": np.zeros(n, dtype=np.int32),
        "ref_spans": np.zeros(n, dtype=np.int32),
    }
    got = _lib.bam_scan_records(
        ptr, body.shape[0], n,
        arrays["rec_offsets"].ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)),
        arrays["rec_sizes"].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        arrays["tids"].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        arrays["poss"].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        arrays["flags"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        arrays["mapqs"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        arrays["l_seqs"].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        arrays["ref_spans"].ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)))
    if got != n:
        return None
    # offsets are relative to body start; rebase to full data
    arrays["rec_offsets"] += body_offset
    arrays["n"] = n
    return arrays


def bam_codes(data, scan, exclude_flags):
    """2-bit code extraction for non-excluded records.

    Returns (codes_flat uint8, code_offsets int64) where offset -1
    marks an excluded record, or None when unavailable.
    """
    if not _load():
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    keep = (scan["flags"] & np.uint16(exclude_flags)) == 0
    total = int(scan["l_seqs"][keep].sum())
    codes = np.zeros(max(total, 1), dtype=np.uint8)
    offsets = np.zeros(scan["n"], dtype=np.int64)
    used = _lib.bam_extract_codes(
        ptr,
        scan["rec_offsets"].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        scan["rec_sizes"].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        scan["flags"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        scan["l_seqs"].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        scan["n"], ctypes.c_uint16(exclude_flags),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if used != total:
        return None
    return codes[:total], offsets


class HostHashTable:
    """Multithreaded open-addressing table over packed 64-bit k-mer keys.

    The random-access half of the heterogeneous probe pipeline: the
    device extracts/canonicalises windows; this table answers
    membership/tally queries at host-memory speed.  Only valid for
    W<=2 word keys (k<=31); callers fall back to the device path
    otherwise.  Sentinel (all-ones) queries never match.
    """

    def __init__(self, keys64):
        if not _load():
            raise RuntimeError("native library unavailable")
        self._keys = np.ascontiguousarray(keys64, dtype=np.uint64)
        self.n = self._keys.shape[0]
        self._handle = _lib.kdf_ht_build(
            self._keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            self.n)
        if not self._handle:
            raise MemoryError("kdf_ht_build failed")
        self._threads = min(os.cpu_count() or 1, 16)

    def tally(self, queries64, tally):
        """Add 1 to tally[i] for each query equal to key i."""
        q = np.ascontiguousarray(queries64, dtype=np.uint64)
        assert tally.dtype == np.int64 and tally.shape[0] >= self.n
        _lib.kdf_ht_tally(
            self._handle,
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            q.shape[0],
            tally.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._threads)

    def member(self, queries64, want_index=False):
        q = np.ascontiguousarray(queries64, dtype=np.uint64)
        out = np.zeros(q.shape[0], dtype=np.uint8)
        idx = np.zeros(q.shape[0], dtype=np.int64) if want_index else None
        _lib.kdf_ht_member(
            self._handle,
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            q.shape[0],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            if want_index else
            ctypes.cast(None, ctypes.POINTER(ctypes.c_int64)),
            self._threads)
        if want_index:
            return out.astype(bool), idx
        return out.astype(bool)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                _lib.kdf_ht_free(self._handle)
        except Exception:
            pass
