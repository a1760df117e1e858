# Copied from kmer_denovo_filter_tpu/htsio/bgzf.py
"""BGZF (blocked gzip) reader/writer.

BGZF is the block-compressed gzip variant used by BAM, bgzipped VCF and
tabix (SAM spec §4.1).  Each block is an independent gzip member with a
``BC`` extra subfield recording the compressed block size, enabling
random access via 48+16-bit *virtual offsets*
(``coffset << 16 | uoffset``).

The reference tool obtained this functionality from pysam
(``pysam.tabix_compress``, reference vcf/pipeline.py:334) and htslib.
This implementation is self-contained on top of :mod:`zlib`.
"""

import os
import struct
import zlib

# Fixed gzip header for a BGZF block: magic, CM=deflate, FLG=FEXTRA,
# MTIME=0, XFL=0, OS=255, XLEN=6, then subfield SI1=66 SI2=67 SLEN=2.
_BGZF_HEADER = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43\x02\x00"
# 28-byte empty terminal block (EOF marker), per SAM spec §4.1.2.
BGZF_EOF = (
    b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43\x02\x00"
    b"\x1b\x00\x03\x00\x00\x00\x00\x00\x00\x00\x00\x00"
)

# Uncompressed payload cap per block: 0xFF00 (htslib's choice) leaves
# room for worst-case deflate expansion within the 16-bit BSIZE field.
_MAX_BLOCK = 0xFF00


def is_bgzf(path):
    """Return True when *path* starts with a BGZF block header."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(18)
    except OSError:
        return False
    return (
        len(head) >= 18
        and head[:4] == b"\x1f\x8b\x08\x04"
        and head[12:14] == b"\x42\x43"
    )


def bgzf_compress_block(data, level=6):
    """Compress up to 64 KiB of *data* into one BGZF block (bytes)."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = co.compress(data) + co.flush()
    # stored BSIZE = total block length - 1; total = 16 hdr + 2 bsize
    # + payload + 4 crc + 4 isize = len(payload) + 26
    bsize = len(payload) + 25
    block = (
        _BGZF_HEADER
        + struct.pack("<H", bsize)
        + payload
        + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    )
    return block


class BgzfWriter:
    """Streaming BGZF writer with virtual-offset tracking.

    ``tell_virtual()`` returns the virtual file offset of the next byte
    to be written, which is what BAI/tabix indexing needs.
    """

    def __init__(self, path, level=6):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._coffset = 0  # compressed offset of current block start
        self._level = level
        self.closed = False

    def tell_virtual(self):
        return (self._coffset << 16) | len(self._buf)

    def write(self, data):
        self._buf += data
        while len(self._buf) >= _MAX_BLOCK:
            self._flush_block(self._buf[:_MAX_BLOCK])
            del self._buf[:_MAX_BLOCK]

    def _flush_block(self, chunk):
        block = bgzf_compress_block(bytes(chunk), self._level)
        self._fh.write(block)
        self._coffset += len(block)

    def flush(self):
        if self._buf:
            self._flush_block(self._buf)
            self._buf.clear()

    def close(self):
        if self.closed:
            return
        self.flush()
        self._fh.write(BGZF_EOF)
        self._fh.close()
        self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfReader:
    """Sequential BGZF reader with virtual-offset ``seek``/``tell``.

    Decompresses block-at-a-time; ``read(n)`` never crosses an EOF
    block.  Also accepts plain gzip and uncompressed files for
    convenience (BGZF is a gzip subset; plain files pass through).
    """

    def __init__(self, path):
        self._fh = open(path, "rb")
        head = self._fh.read(2)
        self._fh.seek(0)
        self._plain = head[:2] != b"\x1f\x8b"
        self._block = b""
        self._block_pos = 0      # position within current block
        self._block_coffset = 0  # compressed offset of current block
        self._next_coffset = 0

    def tell_virtual(self):
        if self._plain:
            return self._fh.tell() - (len(self._block) - self._block_pos)
        return (self._block_coffset << 16) | self._block_pos

    def seek_virtual(self, voffset):
        if self._plain:
            self._fh.seek(voffset)
            self._block = b""
            self._block_pos = 0
            return
        coffset = voffset >> 16
        uoffset = voffset & 0xFFFF
        self._fh.seek(coffset)
        self._next_coffset = coffset
        self._block = b""
        self._block_pos = 0
        if not self._load_block():
            raise EOFError("seek past end of BGZF file")
        self._block_pos = uoffset

    def _load_block(self):
        """Load the next block; return False at EOF."""
        if self._plain:
            self._block_coffset = self._fh.tell()
            self._block = self._fh.read(_MAX_BLOCK)
            self._block_pos = 0
            return bool(self._block)
        coffset = self._next_coffset
        self._fh.seek(coffset)
        header = self._fh.read(12)
        if len(header) < 12:
            return False
        if header[:4] != b"\x1f\x8b\x08\x04":
            # Tolerate plain-gzip members (no BC subfield): inflate via
            # a streaming decompressobj until member end.
            self._fh.seek(coffset)
            return self._load_gzip_member()
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = self._fh.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
                "<H", extra[i + 2:i + 4])[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            self._fh.seek(coffset)
            return self._load_gzip_member()
        payload_len = bsize - 12 - xlen - 8
        payload = self._fh.read(payload_len)
        footer = self._fh.read(8)
        isize = struct.unpack("<I", footer[4:8])[0]
        data = zlib.decompress(payload, -15, isize or 1)
        self._block = data
        self._block_pos = 0
        self._block_coffset = coffset
        self._next_coffset = coffset + bsize
        return bool(data) or isize == 0 and self._load_block()

    def _load_gzip_member(self):
        coffset = self._fh.tell()
        d = zlib.decompressobj(31)
        chunks = []
        while True:
            raw = self._fh.read(65536)
            if not raw:
                break
            chunks.append(d.decompress(raw))
            if d.eof:
                # rewind unused bytes
                self._fh.seek(-len(d.unused_data), os.SEEK_CUR)
                break
        data = b"".join(chunks)
        if not data and not chunks:
            return False
        self._block = data
        self._block_pos = 0
        self._block_coffset = coffset
        self._next_coffset = self._fh.tell()
        return bool(data)

    def read(self, n=-1):
        out = []
        if n < 0:
            while True:
                if self._block_pos >= len(self._block):
                    if not self._load_block():
                        break
                out.append(self._block[self._block_pos:])
                self._block_pos = len(self._block)
            return b"".join(out)
        remaining = n
        while remaining > 0:
            if self._block_pos >= len(self._block):
                if not self._load_block():
                    break
            take = self._block[self._block_pos:self._block_pos + remaining]
            self._block_pos += len(take)
            remaining -= len(take)
            out.append(take)
        return b"".join(out)

    def iter_lines_voffsets(self):
        """Yield ``(vstart, line_bytes, vend)`` per newline-terminated line.

        ``vstart`` is the virtual offset of the line's first byte and
        ``vend`` the virtual offset just past its newline — the values
        tabix/BAI chunk indexing needs.
        """
        carry = b""
        carry_vstart = None
        while True:
            if self._block_pos >= len(self._block):
                if not self._load_block():
                    break
            vbase_c = self._block_coffset
            pos = self._block_pos
            data = self._block
            self._block_pos = len(data)
            start = pos
            while True:
                nl = data.find(b"\n", start)
                if nl < 0:
                    rest = data[start:]
                    if rest:
                        if carry_vstart is None:
                            carry_vstart = (vbase_c << 16) | start
                        carry += rest
                    break
                vstart = carry_vstart if carry_vstart is not None \
                    else (vbase_c << 16) | start
                line = carry + data[start:nl + 1]
                carry = b""
                carry_vstart = None
                vend = (vbase_c << 16) | (nl + 1)
                if nl + 1 >= len(data):
                    # vend at block boundary → next block's start offset
                    save = self._block_pos
                    vend = (self._next_coffset << 16) if not self._plain \
                        else (vbase_c + len(data)) << 0
                    self._block_pos = save
                yield vstart, line, vend
                start = nl + 1
        if carry:
            yield carry_vstart, carry, self.tell_virtual()

    def read_exact(self, n):
        data = self.read(n)
        if len(data) != n:
            raise EOFError(f"expected {n} bytes, got {len(data)}")
        return data

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def bgzf_compress_file(src_path, dst_path, level=6):
    """bgzip a plain text file (equivalent of pysam.tabix_compress)."""
    with open(src_path, "rb") as src, BgzfWriter(dst_path, level) as dst:
        while True:
            chunk = src.read(_MAX_BLOCK)
            if not chunk:
                break
            dst.write(chunk)


class ParallelBgzfReader:
    """Sequential BGZF reader with pooled block inflation.

    The consumer thread walks compressed block headers (cheap file
    reads) and submits payloads to a thread pool — ``zlib.decompress``
    releases the GIL, so blocks inflate in parallel while results pop
    in order.  Exposes the ``read``/``read_exact`` subset the
    streaming scan paths use.  Strict BGZF only (the BAM spec requires
    it): a non-BGZF member raises, it does not silently degrade.
    """

    def __init__(self, path, threads=None, depth=None):
        import collections
        import concurrent.futures

        self._fh = open(path, "rb")
        head = self._fh.read(4)
        self._fh.seek(0)
        if head[:4] != b"\x1f\x8b\x08\x04":
            self._fh.close()
            raise ValueError(f"not a BGZF file: {path}")
        if threads is None:
            threads = int(os.environ.get(
                "KDF_BGZF_THREADS",
                min(8, os.cpu_count() or 1)))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, threads),
            thread_name_prefix="kdf-bgzf")
        self._depth = depth or max(4, threads * 8)
        self._futs = collections.deque()
        self._buf = b""
        self._pos = 0
        self._header_eof = False

    def _submit(self):
        while len(self._futs) < self._depth and not self._header_eof:
            header = self._fh.read(12)
            if len(header) < 12:
                self._header_eof = True
                return
            if header[:4] != b"\x1f\x8b\x08\x04":
                raise ValueError("non-BGZF member in stream")
            (xlen,) = struct.unpack("<H", header[10:12])
            extra = self._fh.read(xlen)
            bsize = None
            i = 0
            while i + 4 <= len(extra):
                si1, si2 = extra[i], extra[i + 1]
                (slen,) = struct.unpack("<H", extra[i + 2:i + 4])
                if si1 == 66 and si2 == 67 and slen == 2:
                    (raw,) = struct.unpack("<H", extra[i + 4:i + 6])
                    bsize = raw + 1
                    break
                i += 4 + slen
            if bsize is None:
                raise ValueError("BGZF member without BC subfield")
            payload = self._fh.read(bsize - 12 - xlen - 8)
            footer = self._fh.read(8)
            (isize,) = struct.unpack("<I", footer[4:8])
            self._futs.append(self._pool.submit(
                zlib.decompress, payload, -15, isize or 1))

    def _next_block(self):
        self._submit()
        while self._futs:
            data = self._futs.popleft().result()
            self._submit()
            if data:
                return data
        return b""

    def read(self, n=-1):
        out = []
        got = 0
        while n < 0 or got < n:
            if self._pos >= len(self._buf):
                self._buf = self._next_block()
                self._pos = 0
                if not self._buf:
                    break
            take = (len(self._buf) - self._pos if n < 0
                    else min(n - got, len(self._buf) - self._pos))
            out.append(self._buf[self._pos:self._pos + take])
            self._pos += take
            got += take
        return b"".join(out)

    def read_exact(self, n):
        data = self.read(n)
        if len(data) != n:
            raise EOFError(f"expected {n} bytes, got {len(data)}")
        return data

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
