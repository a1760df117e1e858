# Copied from kmer_denovo_filter_tpu/htsio/cram_codecs.py
"""CRAM 3.0 primitive codecs: ITF-8 / LTF-8 varints, the MSB-first
core bitstream, and the rANS 4x8 entropy codec (orders 0 and 1).

Self-contained replacement for the htslib machinery the reference
reaches through pysam when fed CRAM trios (reference cli.py:13-24,
core/bam_scanner.py:1).  The rANS implementation follows the CRAM 3.0
specification's 4-way interleaved, 8-bit-renormalising variant with
12-bit frequencies; it is exercised by self round-trip tests
(tests/test_cram.py) since no htslib binary exists in this image.
"""

import struct
import zlib

import numpy as np


class CramFormatError(ValueError):
    pass


# --------------------------------------------------------------- varints

def read_itf8(buf, pos):
    """CRAM ITF-8: 32-bit int, 1-5 bytes, leading-ones length prefix.

    Returns (value, new_pos).  Values are the raw 32-bit pattern;
    callers treating a field as signed apply :func:`to_signed32`.
    """
    b0 = buf[pos]
    if b0 < 0x80:
        return b0, pos + 1
    if b0 < 0xC0:
        return ((b0 & 0x3F) << 8) | buf[pos + 1], pos + 2
    if b0 < 0xE0:
        return (((b0 & 0x1F) << 16) | (buf[pos + 1] << 8)
                | buf[pos + 2]), pos + 3
    if b0 < 0xF0:
        return (((b0 & 0x0F) << 24) | (buf[pos + 1] << 16)
                | (buf[pos + 2] << 8) | buf[pos + 3]), pos + 4
    return (((b0 & 0x0F) << 28) | (buf[pos + 1] << 20)
            | (buf[pos + 2] << 12) | (buf[pos + 3] << 4)
            | (buf[pos + 4] & 0x0F)), pos + 5


def write_itf8(value):
    v = value & 0xFFFFFFFF
    if v < 0x80:
        return bytes((v,))
    if v < 0x4000:
        return bytes((0x80 | (v >> 8), v & 0xFF))
    if v < 0x200000:
        return bytes((0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF))
    if v < 0x10000000:
        return bytes((0xE0 | (v >> 24), (v >> 16) & 0xFF,
                      (v >> 8) & 0xFF, v & 0xFF))
    return bytes((0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                  (v >> 4) & 0xFF, v & 0x0F))


def read_ltf8(buf, pos):
    """CRAM LTF-8: 64-bit int, 1-9 bytes."""
    b0 = buf[pos]
    if b0 < 0x80:
        return b0, pos + 1
    n_extra = 0
    mask = 0x80
    while n_extra < 8 and (b0 & mask):
        n_extra += 1
        mask >>= 1
    val = (b0 & (mask - 1)) if n_extra < 8 else 0
    for i in range(n_extra):
        val = (val << 8) | buf[pos + 1 + i]
    return val, pos + 1 + n_extra


def write_ltf8(value):
    v = value & 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes((v,))
    out = []
    n = (v.bit_length() + 7) // 8  # payload bytes
    # prefix byte must fit (8 - n - 1) value bits when n < 8
    while n < 8 and (v >> (8 * n)) >= (1 << (7 - n)):
        n += 1
    if n >= 8:
        prefix = 0xFF
        n = 8
    else:
        prefix = (0xFF << (8 - n)) & 0xFF | (v >> (8 * n))
    out.append(prefix)
    for i in range(n - 1, -1, -1):
        out.append((v >> (8 * i)) & 0xFF)
    return bytes(out)


def to_signed32(v):
    return v - 0x100000000 if v >= 0x80000000 else v


def read_itf8_array(buf, pos):
    n, pos = read_itf8(buf, pos)
    out = []
    for _ in range(n):
        v, pos = read_itf8(buf, pos)
        out.append(v)
    return out, pos


def write_itf8_array(values):
    return write_itf8(len(values)) + b"".join(
        write_itf8(v) for v in values)


# --------------------------------------------------------- core bitstream

class BitReader:
    """MSB-first bit reader over the CORE block bytes."""

    __slots__ = ("data", "byte", "bit")

    def __init__(self, data):
        self.data = data
        self.byte = 0
        self.bit = 0  # bits consumed of current byte

    def read(self, n):
        v = 0
        while n:
            if self.byte >= len(self.data):
                raise CramFormatError("core bitstream exhausted")
            avail = 8 - self.bit
            take = min(n, avail)
            cur = self.data[self.byte]
            v = (v << take) | (
                (cur >> (avail - take)) & ((1 << take) - 1))
            self.bit += take
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
            n -= take
        return v

    def read_bit(self):
        return self.read(1)


class BitWriter:
    __slots__ = ("out", "cur", "bit")

    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.bit = 0

    def write(self, value, n):
        while n:
            take = min(n, 8 - self.bit)
            self.cur |= ((value >> (n - take)) & ((1 << take) - 1)) \
                << (8 - self.bit - take)
            self.bit += take
            n -= take
            if self.bit == 8:
                self.out.append(self.cur)
                self.cur = 0
                self.bit = 0

    def getvalue(self):
        if self.bit:
            return bytes(self.out) + bytes((self.cur,))
        return bytes(self.out)


# ------------------------------------------------------------- rANS 4x8

_TOTFREQ = 4096          # 12-bit normalised frequencies
_RANS_L = 1 << 23        # lower renormalisation bound


def _normalise_freqs(hist):
    """Scale a histogram to sum exactly _TOTFREQ, keeping nonzeros."""
    total = int(hist.sum())
    if total == 0:
        return None
    freqs = np.zeros(256, dtype=np.int64)
    nz = np.nonzero(hist)[0]
    scaled = hist[nz].astype(np.float64) * (_TOTFREQ / total)
    f = np.maximum(1, np.round(scaled).astype(np.int64))
    freqs[nz] = f
    # repair rounding drift against the largest bins
    diff = int(f.sum()) - _TOTFREQ
    order = nz[np.argsort(-hist[nz])]
    i = 0
    while diff != 0:
        s = order[i % len(order)]
        if diff > 0 and freqs[s] > 1:
            freqs[s] -= 1
            diff -= 1
        elif diff < 0:
            freqs[s] += 1
            diff += 1
        i += 1
    return freqs


def _write_freqs_o0(freqs):
    """Serialise an order-0 table with the spec's symbol RLE."""
    out = bytearray()
    rle = 0
    for j in range(256):
        if not freqs[j]:
            continue
        if rle:
            rle -= 1
        else:
            out.append(j)
            if j and freqs[j - 1]:
                k = j + 1
                while k < 256 and freqs[k]:
                    k += 1
                rle = k - (j + 1)
                out.append(rle)
        f = int(freqs[j])
        if f < 128:
            out.append(f)
        else:
            out.append(128 | (f >> 8))
            out.append(f & 0xFF)
    out.append(0)
    return bytes(out)


def _read_freqs_o0(buf, pos):
    freqs = np.zeros(256, dtype=np.int64)
    rle = 0
    j = buf[pos]
    pos += 1
    while True:
        f = buf[pos]
        pos += 1
        if f >= 128:
            f = ((f & 0x7F) << 8) | buf[pos]
            pos += 1
        freqs[j] = f
        if rle:
            rle -= 1
            j += 1
        else:
            nj = buf[pos]
            pos += 1
            if nj == j + 1:
                rle = buf[pos]
                pos += 1
            j = nj
        if j == 0 and rle == 0:
            break
    return freqs, pos


def rans_encode_o0(data):
    """rANS 4x8 order-0 compressed body (after the 9-byte header)."""
    n = len(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    hist = np.bincount(arr, minlength=256)
    freqs = _normalise_freqs(hist)
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])
    table = _write_freqs_o0(freqs)

    # encode back-to-front, 4 interleaved states
    states = [_RANS_L] * 4
    out_rev = bytearray()
    fq = freqs
    cm = cum
    for i in range(n - 1, -1, -1):
        j = i & 3
        s = arr[i]
        x = states[j]
        f = int(fq[s])
        x_max = ((_RANS_L >> 12) << 8) * f
        while x >= x_max:
            out_rev.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << 12) + (x % f) + int(cm[s])
    head = b"".join(struct.pack("<I", states[j]) for j in range(4))
    return table + head + bytes(reversed(out_rev))


def rans_decode_o0(buf, out_sz):
    freqs, pos = _read_freqs_o0(buf, 0)
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])
    # symbol lookup over the 12-bit slot space
    sym_of = np.zeros(_TOTFREQ, dtype=np.uint8)
    for s in np.nonzero(freqs)[0]:
        sym_of[cum[s]:cum[s + 1]] = s
    states = list(struct.unpack_from("<4I", buf, pos))
    pos += 16
    out = bytearray(out_sz)
    fq = freqs
    cm = cum
    for i in range(out_sz):
        j = i & 3
        x = states[j]
        m = x & 0xFFF
        s = sym_of[m]
        out[i] = s
        x = int(fq[s]) * (x >> 12) + m - int(cm[s])
        while x < _RANS_L:
            x = (x << 8) | (buf[pos] if pos < len(buf) else 0)
            pos += 1
        states[j] = x
    return bytes(out)


def rans_encode_o1(data):
    """rANS 4x8 order-1: 256 previous-byte contexts, 4 quarter streams."""
    n = len(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    isz4 = n >> 2
    # context histogram: ctx 0 precedes each quarter's first byte
    hist = np.zeros((256, 256), dtype=np.int64)
    prev = np.empty(n, dtype=np.uint8)
    prev[1:] = arr[:-1]
    prev[0] = 0
    for q in range(1, 4):
        prev[q * isz4] = 0
    np.add.at(hist, (prev, arr), 1)

    freqs = {}
    cums = {}
    parts = bytearray()
    present = [i for i in range(256) if hist[i].any()]
    pset = set(present)
    rle = 0
    for idx, i in enumerate(present):
        if rle:
            rle -= 1
        else:
            parts.append(i)
            if i and (i - 1) in pset:
                k = i + 1
                while k < 256 and k in pset:
                    k += 1
                rle = k - (i + 1)
                parts.append(rle)
        f = _normalise_freqs(hist[i])
        c = np.zeros(257, dtype=np.int64)
        np.cumsum(f, out=c[1:])
        freqs[i] = f
        cums[i] = c
        parts += _write_freqs_o0(f)
    parts.append(0)

    states = [_RANS_L] * 4
    out_rev = bytearray()
    # encode each quarter back-to-front; tail bytes ride state 3
    bounds = [(0, isz4), (isz4, 2 * isz4), (2 * isz4, 3 * isz4),
              (3 * isz4, n)]
    max_len = max(e - s for s, e in bounds) if n else 0
    for step in range(max_len - 1, -1, -1):
        for j in range(3, -1, -1):
            s0, e0 = bounds[j]
            i = s0 + step
            if i >= e0:
                continue
            s = arr[i]
            ctx = arr[i - 1] if i > s0 else 0
            x = states[j]
            f = int(freqs[ctx][s])
            x_max = ((_RANS_L >> 12) << 8) * f
            while x >= x_max:
                out_rev.append(x & 0xFF)
                x >>= 8
            states[j] = ((x // f) << 12) + (x % f) + int(cums[ctx][s])
    head = b"".join(struct.pack("<I", states[j]) for j in range(4))
    return bytes(parts) + head + bytes(reversed(out_rev))


def rans_decode_o1(buf, out_sz):
    freqs = {}
    sym_ofs = {}
    cums = {}
    pos = 0
    rle = 0
    i = buf[pos]
    pos += 1
    while True:
        f, pos = _read_freqs_o0(buf, pos)
        c = np.zeros(257, dtype=np.int64)
        np.cumsum(f, out=c[1:])
        so = np.zeros(_TOTFREQ, dtype=np.uint8)
        for s in np.nonzero(f)[0]:
            so[c[s]:c[s + 1]] = s
        freqs[i] = f
        cums[i] = c
        sym_ofs[i] = so
        if rle:
            rle -= 1
            i += 1
        else:
            ni = buf[pos]
            pos += 1
            if ni == i + 1:
                rle = buf[pos]
                pos += 1
            i = ni
        if i == 0 and rle == 0:
            break
    states = list(struct.unpack_from("<4I", buf, pos))
    pos += 16
    out = bytearray(out_sz)
    isz4 = out_sz >> 2
    ptrs = [0, isz4, 2 * isz4, 3 * isz4]
    ctxs = [0, 0, 0, 0]
    bounds = [isz4, 2 * isz4, 3 * isz4, out_sz]
    max_len = max((bounds[j] - (j * isz4) for j in range(4)),
                  default=0)
    for _step in range(max_len):
        for j in range(4):
            i2 = ptrs[j]
            if i2 >= bounds[j]:
                continue
            x = states[j]
            m = x & 0xFFF
            ctx = ctxs[j]
            s = sym_ofs[ctx][m]
            out[i2] = s
            x = int(freqs[ctx][s]) * (x >> 12) + m - int(cums[ctx][s])
            while x < _RANS_L:
                x = (x << 8) | (buf[pos] if pos < len(buf) else 0)
                pos += 1
            states[j] = x
            ctxs[j] = s
            ptrs[j] = i2 + 1
    return bytes(out)


def rans_compress(data, order=0):
    """Full rANS 4x8 block: order byte + sizes + body."""
    if len(data) == 0:
        body = b""
        return struct.pack("<BII", order, 0, 0)
    body = rans_encode_o1(data) if order else rans_encode_o0(data)
    return struct.pack("<BII", order, len(body), len(data)) + body


def rans_decompress(data):
    order, comp_sz, raw_sz = struct.unpack_from("<BII", data, 0)
    if raw_sz == 0:
        return b""
    body = data[9:9 + comp_sz]
    if order == 0:
        return rans_decode_o0(body, raw_sz)
    if order == 1:
        return rans_decode_o1(body, raw_sz)
    raise CramFormatError(f"unknown rANS order {order}")


# --------------------------------------------------------- block methods

METHOD_RAW = 0
METHOD_GZIP = 1
METHOD_BZIP2 = 2
METHOD_LZMA = 3
METHOD_RANS = 4


def decompress_block(method, data, raw_size):
    if method == METHOD_RAW:
        return bytes(data)
    if method == METHOD_GZIP:
        return zlib.decompress(data, zlib.MAX_WBITS | 32)
    if method == METHOD_BZIP2:
        import bz2
        return bz2.decompress(data)
    if method == METHOD_LZMA:
        import lzma
        return lzma.decompress(data)
    if method == METHOD_RANS:
        return rans_decompress(data)
    raise CramFormatError(f"unsupported CRAM block method {method}")
