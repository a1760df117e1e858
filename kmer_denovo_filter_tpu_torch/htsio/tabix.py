# Copied from kmer_denovo_filter_tpu/htsio/tabix.py
"""Tabix (.tbi) index writer (htslib-free).

Equivalent of ``pysam.tabix_index`` (reference vcf/pipeline.py:339,
1302) for the presets the pipelines use: ``vcf`` and ``bed``.
"""

import struct

from kmer_denovo_filter_tpu_torch.htsio.bgzf import (
    BgzfReader,
    BgzfWriter,
    bgzf_compress_file,
)
from kmer_denovo_filter_tpu_torch.htsio.bam import reg2bin

_PRESETS = {
    # (format, col_seq, col_beg, col_end, meta_char, skip)
    "vcf": (2, 1, 2, 0, ord("#"), 0),
    "bed": (0x10000, 1, 2, 3, ord("#"), 0),
}


def tabix_index(path, preset="vcf", meta_char="#", force=True):
    """Build ``path + ".tbi"`` for a position-sorted bgzipped text file."""
    fmt, col_seq, col_beg, col_end, _meta, skip = _PRESETS[preset]
    meta = ord(meta_char)
    names = []
    name_to_tid = {}
    bins_per_ref = []
    linear_per_ref = []

    with BgzfReader(path) as fh:
        for vstart, line, vend in fh.iter_lines_voffsets():
            if line[0] == meta or not line.strip():
                continue
            fields = line.rstrip(b"\r\n").split(b"\t")
            seq = fields[col_seq - 1].decode()
            beg = int(fields[col_beg - 1])
            if fmt & 0x10000 or preset == "bed":
                end = int(fields[col_end - 1]) if col_end else beg + 1
            else:  # 1-based inclusive (VCF): use REF length for the span
                beg -= 1
                if preset == "vcf" and len(fields) > 3:
                    end = beg + max(len(fields[3]), 1)
                else:
                    end = beg + 1
            if seq not in name_to_tid:
                name_to_tid[seq] = len(names)
                names.append(seq)
                bins_per_ref.append({})
                linear_per_ref.append({})
            tid = name_to_tid[seq]
            b = reg2bin(beg, max(end, beg + 1))
            chunks = bins_per_ref[tid].setdefault(b, [])
            if chunks and chunks[-1][1] == vstart:
                chunks[-1] = (chunks[-1][0], vend)
            else:
                chunks.append((vstart, vend))
            for win in range(beg >> 14, ((max(end, beg + 1) - 1) >> 14) + 1):
                lin = linear_per_ref[tid]
                if win not in lin or vstart < lin[win]:
                    lin[win] = vstart

    name_blob = b"".join(n.encode() + b"\x00" for n in names)
    with BgzfWriter(path + ".tbi") as out:
        out.write(b"TBI\x01")
        out.write(struct.pack("<8i", len(names), fmt, col_seq, col_beg,
                              col_end, meta, skip, len(name_blob)))
        out.write(name_blob)
        for tid in range(len(names)):
            bins = bins_per_ref[tid]
            out.write(struct.pack("<i", len(bins)))
            for b in sorted(bins):
                chunks = bins[b]
                out.write(struct.pack("<Ii", b, len(chunks)))
                for s, e in chunks:
                    out.write(struct.pack("<QQ", s, e))
            lin = linear_per_ref[tid]
            n_intv = (max(lin) + 1) if lin else 0
            out.write(struct.pack("<i", n_intv))
            prev = 0
            for i in range(n_intv):
                v = lin.get(i, prev)
                prev = v
                out.write(struct.pack("<Q", v))
    return path + ".tbi"


def tabix_compress(src, dst, force=True):
    """bgzip *src* into *dst* (pysam.tabix_compress equivalent)."""
    bgzf_compress_file(src, dst)
    return dst


class TabixFile:
    """Minimal tabix reader: region queries over a bgzipped text file."""

    def __init__(self, path, tbi_path=None):
        self.path = path
        tbi = tbi_path or path + ".tbi"
        with BgzfReader(tbi) as fh:
            if fh.read_exact(4) != b"TBI\x01":
                raise ValueError(f"not a tabix index: {tbi}")
            (n_ref, self.fmt, self.col_seq, self.col_beg, self.col_end,
             self.meta, self.skip, l_nm) = struct.unpack(
                "<8i", fh.read_exact(32))
            names = fh.read_exact(l_nm).split(b"\x00")[:-1]
            self.names = [n.decode() for n in names]
            self._bins = []
            self._linear = []
            for _ in range(n_ref):
                (n_bin,) = struct.unpack("<i", fh.read_exact(4))
                bins = {}
                for _ in range(n_bin):
                    b, n_chunk = struct.unpack("<Ii", fh.read_exact(8))
                    chunks = [struct.unpack("<QQ", fh.read_exact(16))
                              for _ in range(n_chunk)]
                    bins[b] = chunks
                (n_intv,) = struct.unpack("<i", fh.read_exact(4))
                lin = struct.unpack(f"<{n_intv}Q",
                                    fh.read_exact(8 * n_intv))
                self._bins.append(bins)
                self._linear.append(lin)

    @staticmethod
    def _reg2bins(beg, end):
        """All bins overlapping [beg, end) (SAM spec §5.3)."""
        out = [0]
        end -= 1
        for base, shift in ((1, 26), (9, 23), (73, 20),
                            (585, 17), (4681, 14)):
            out.extend(range(base + (beg >> shift),
                             base + (end >> shift) + 1))
        return out

    def query(self, chrom, start, end):
        """Yield data lines (str) overlapping [start, end) 0-based."""
        if chrom not in self.names:
            return
        tid = self.names.index(chrom)
        chunks = []
        for b in self._reg2bins(start, end):
            chunks.extend(self._bins[tid].get(b, ()))
        if not chunks:
            return
        lin = self._linear[tid]
        min_off = lin[min(start >> 14, len(lin) - 1)] if lin else 0
        chunks = sorted(c for c in chunks if c[1] > min_off)
        is_bed = bool(self.fmt & 0x10000)
        with BgzfReader(self.path) as fh:
            for cbeg, cend in chunks:
                fh.seek_virtual(max(cbeg, min_off))
                while fh.tell_virtual() < cend:
                    line = bytearray()
                    while True:
                        ch = fh.read(1)
                        if not ch:
                            break
                        if ch == b"\n":
                            break
                        line += ch
                    if not line:
                        break
                    text = line.decode()
                    if text.startswith(chr(self.meta)):
                        continue
                    fields = text.split("\t")
                    if fields[self.col_seq - 1] != chrom:
                        continue
                    beg = int(fields[self.col_beg - 1])
                    if not is_bed:
                        rend = beg - 1 + max(
                            len(fields[3]) if len(fields) > 3 else 1, 1)
                        beg -= 1
                    else:
                        rend = (int(fields[self.col_end - 1])
                                if self.col_end else beg + 1)
                    if beg < end and rend > start:
                        yield text
