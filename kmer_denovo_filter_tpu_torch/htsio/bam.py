# Copied from kmer_denovo_filter_tpu/htsio/bam.py
"""BAM reader/writer with a pysam-like record API and a packed fast path.

Replaces the reference's pysam.AlignmentFile usage (reference
core/bam_scanner.py:18, vcf/pipeline.py:635, discovery/pipeline.py:726)
and the ``samtools fasta -F 0xD00`` streaming path (reference
core/jellyfish_wrappers.py:158–165) with a native implementation:

* :class:`AlignedRead` — lazily-decoded record exposing the subset of
  the pysam ``AlignedSegment`` API the pipelines use (aligned pairs,
  reference positions, CIGAR, tags, flags).
* :class:`BamReader` — streaming iteration, region ``fetch`` via an
  in-memory per-contig interval index (no BAI required for reading),
  and :meth:`iter_packed` which yields 2-bit-packed numpy read batches
  for the TPU k-mer engine without materialising sequence strings.
* :class:`BamWriter` — coordinate-sort + BAI binning index writer
  (equivalent of ``pysam.sort`` + ``pysam.index``,
  reference vcf/pipeline.py:1355–1356).
"""

import os
import struct

import numpy as np

from kmer_denovo_filter_tpu_torch.htsio.bgzf import BgzfReader, BgzfWriter

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAP = 0x4
FLAG_MUNMAP = 0x8
FLAG_REVERSE = 0x10
FLAG_MREVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

_SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_CIGAR_OPS = "MIDNSHP=X"
# nibble code -> 2-bit base code (A=0 C=1 G=2 T=3), 4 = ambiguous/N
_NT16_TO_2BIT = np.full(16, 4, dtype=np.uint8)
_NT16_TO_2BIT[1] = 0  # A
_NT16_TO_2BIT[2] = 1  # C
_NT16_TO_2BIT[4] = 2  # G
_NT16_TO_2BIT[8] = 3  # T

# ops that consume reference: M D N = X  → indices 0,2,3,7,8
_REF_CONSUME = frozenset((0, 2, 3, 7, 8))
# ops that consume query: M I S = X → 0,1,4,7,8
_QRY_CONSUME = frozenset((0, 1, 4, 7, 8))


class AlignedRead:
    """One BAM alignment record (lazily decoded from the raw buffer)."""

    __slots__ = (
        "_raw", "tid", "pos", "mapping_quality", "flag",
        "next_tid", "next_pos", "tlen",
        "_l_read_name", "_n_cigar", "_l_seq",
        "_refs", "_qname", "_cigar", "_seq", "_qual", "_tags",
        "_ref_end",
    )

    def __init__(self, raw, refs):
        self._raw = raw
        self._refs = refs
        (self.tid, self.pos, self._l_read_name, self.mapping_quality,
         _bin, self._n_cigar, self.flag, self._l_seq,
         self.next_tid, self.next_pos, self.tlen) = struct.unpack_from(
            "<iiBBHHHiiii", raw, 0)
        self._qname = None
        self._cigar = None
        self._seq = None
        self._qual = None
        self._tags = None
        self._ref_end = None

    # ── identity / flags ───────────────────────────────────────────
    @property
    def query_name(self):
        if self._qname is None:
            off = 32
            self._qname = self._raw[off:off + self._l_read_name - 1].decode()
        return self._qname

    @property
    def is_unmapped(self):
        return bool(self.flag & FLAG_UNMAP)

    @property
    def is_secondary(self):
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self):
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    @property
    def is_duplicate(self):
        return bool(self.flag & FLAG_DUP)

    @property
    def is_paired(self):
        return bool(self.flag & FLAG_PAIRED)

    @property
    def is_proper_pair(self):
        return bool(self.flag & FLAG_PROPER_PAIR)

    @property
    def is_reverse(self):
        return bool(self.flag & FLAG_REVERSE)

    @property
    def mate_is_unmapped(self):
        return bool(self.flag & FLAG_MUNMAP)

    # ── coordinates ────────────────────────────────────────────────
    @property
    def reference_id(self):
        return self.tid

    @property
    def reference_name(self):
        if self.tid < 0:
            return None
        return self._refs[self.tid][0]

    @property
    def reference_start(self):
        return self.pos

    @property
    def cigartuples(self):
        if self._n_cigar == 0:
            return None
        if self._cigar is None:
            off = 32 + self._l_read_name
            vals = struct.unpack_from(f"<{self._n_cigar}I", self._raw, off)
            self._cigar = [(v & 0xF, v >> 4) for v in vals]
        return self._cigar

    @property
    def reference_end(self):
        """0-based exclusive end of the alignment on the reference."""
        if self.is_unmapped:
            return None
        if self._ref_end is None:
            span = 0
            ct = self.cigartuples
            if ct:
                for op, length in ct:
                    if op in _REF_CONSUME:
                        span += length
            self._ref_end = self.pos + span
        return self._ref_end

    @property
    def query_length(self):
        return self._l_seq

    @property
    def query_sequence(self):
        if self._l_seq == 0:
            return None
        if self._seq is None:
            off = 32 + self._l_read_name + 4 * self._n_cigar
            nbytes = (self._l_seq + 1) // 2
            packed = self._raw[off:off + nbytes]
            chars = []
            for b in packed:
                chars.append(_SEQ_NT16[b >> 4])
                chars.append(_SEQ_NT16[b & 0xF])
            self._seq = "".join(chars[:self._l_seq])
        return self._seq

    @property
    def query_qualities(self):
        if self._l_seq == 0:
            return None
        if self._qual is None:
            off = (32 + self._l_read_name + 4 * self._n_cigar
                   + (self._l_seq + 1) // 2)
            q = self._raw[off:off + self._l_seq]
            if q and q[0] == 0xFF:
                self._qual = None
                return None
            self._qual = list(q)
        return self._qual

    def seq_codes(self):
        """Return the read as a 2-bit numpy code array (4 = N)."""
        off = 32 + self._l_read_name + 4 * self._n_cigar
        nbytes = (self._l_seq + 1) // 2
        packed = np.frombuffer(self._raw, dtype=np.uint8,
                               count=nbytes, offset=off)
        nibbles = np.empty(nbytes * 2, dtype=np.uint8)
        nibbles[0::2] = packed >> 4
        nibbles[1::2] = packed & 0xF
        return _NT16_TO_2BIT[nibbles[:self._l_seq]]

    # ── tags ───────────────────────────────────────────────────────
    def _parse_tags(self):
        if self._tags is not None:
            return self._tags
        off = (32 + self._l_read_name + 4 * self._n_cigar
               + (self._l_seq + 1) // 2 + self._l_seq)
        tags = {}
        raw = self._raw
        n = len(raw)
        while off + 3 <= n:
            tag = raw[off:off + 2].decode("ascii", "replace")
            typ = chr(raw[off + 2])
            off += 3
            if typ == "A":
                tags[tag] = chr(raw[off]); off += 1
            elif typ == "c":
                tags[tag] = struct.unpack_from("<b", raw, off)[0]; off += 1
            elif typ == "C":
                tags[tag] = raw[off]; off += 1
            elif typ == "s":
                tags[tag] = struct.unpack_from("<h", raw, off)[0]; off += 2
            elif typ == "S":
                tags[tag] = struct.unpack_from("<H", raw, off)[0]; off += 2
            elif typ == "i":
                tags[tag] = struct.unpack_from("<i", raw, off)[0]; off += 4
            elif typ == "I":
                tags[tag] = struct.unpack_from("<I", raw, off)[0]; off += 4
            elif typ == "f":
                tags[tag] = struct.unpack_from("<f", raw, off)[0]; off += 4
            elif typ in ("Z", "H"):
                end = raw.index(b"\x00", off)
                tags[tag] = raw[off:end].decode("ascii", "replace")
                off = end + 1
            elif typ == "B":
                sub = chr(raw[off]); cnt = struct.unpack_from(
                    "<I", raw, off + 1)[0]
                off += 5
                fmt = {"c": "b", "C": "B", "s": "h", "S": "H",
                       "i": "i", "I": "I", "f": "f"}[sub]
                size = struct.calcsize(fmt)
                tags[tag] = list(struct.unpack_from(
                    f"<{cnt}{fmt}", raw, off))
                off += cnt * size
            else:
                break  # unknown tag type — stop parsing
        self._tags = tags
        return tags

    def has_tag(self, tag):
        return tag in self._parse_tags()

    def get_tag(self, tag):
        return self._parse_tags()[tag]

    def set_tag(self, tag, value, value_type=None):
        """Append/replace a tag (re-encodes the record's tag block)."""
        tags = dict(self._parse_tags())
        tags[tag] = value
        if value_type is None:
            value_type = "i" if isinstance(value, int) else "Z"
        # Rebuild raw buffer with the updated tag block.
        fixed_end = (32 + self._l_read_name + 4 * self._n_cigar
                     + (self._l_seq + 1) // 2 + self._l_seq)
        blob = bytearray(self._raw[:fixed_end])
        for t, v in tags.items():
            if t == tag:
                vt = value_type
            else:
                vt = "i" if isinstance(v, int) else (
                    "f" if isinstance(v, float) else "Z")
            blob += t.encode()
            if vt == "i":
                blob += b"i" + struct.pack("<i", v)
            elif vt == "f":
                blob += b"f" + struct.pack("<f", v)
            elif vt == "A":
                blob += b"A" + v.encode()[:1]
            else:
                blob += b"Z" + str(v).encode() + b"\x00"
        self._raw = bytes(blob)
        self._tags = tags

    # ── aligned-pairs helpers (pysam-compatible semantics) ─────────
    def get_aligned_pairs(self, matches_only=False):
        """(query_pos, ref_pos) pairs from the CIGAR, like pysam.

        Soft-clipped query bases appear with ``ref_pos=None``; deleted /
        skipped reference bases appear with ``query_pos=None``
        (matching pysam's ``matches_only=False`` output).  Hard clips
        and padding are not reported.
        """
        ct = self.cigartuples
        if not ct:
            return []
        pairs = []
        q = 0
        r = self.pos
        for op, length in ct:
            if op in (0, 7, 8):  # M, =, X
                for i in range(length):
                    pairs.append((q + i, r + i))
                q += length
                r += length
            elif op == 1 or op == 4:  # I, S
                if not matches_only:
                    for i in range(length):
                        pairs.append((q + i, None))
                q += length
            elif op == 2 or op == 3:  # D, N
                if not matches_only:
                    for i in range(length):
                        pairs.append((None, r + i))
                r += length
            # H (5), P (6): consume nothing reported
        return pairs

    def get_reference_positions(self, full_length=False):
        """Reference positions per query base, like pysam.

        With ``full_length=True`` returns one entry per query base with
        ``None`` for soft-clipped/inserted bases; otherwise only the
        aligned positions.
        """
        ct = self.cigartuples
        if not ct:
            return [None] * self._l_seq if full_length else []
        out = []
        r = self.pos
        for op, length in ct:
            if op in (0, 7, 8):
                out.extend(range(r, r + length))
                r += length
            elif op == 1 or op == 4:
                if full_length:
                    out.extend([None] * length)
            elif op == 2 or op == 3:
                r += length
        return out

    def raw_tags(self):
        """The raw BAM-encoded tag block (bytes after seq/qual)."""
        fixed_end = (32 + self._l_read_name + 4 * self._n_cigar
                     + (self._l_seq + 1) // 2 + self._l_seq)
        return self._raw[fixed_end:]

    def to_raw(self, tid_override=None):
        """Serialised record body (without the block_size prefix)."""
        if tid_override is None:
            return self._raw
        raw = bytearray(self._raw)
        struct.pack_into("<i", raw, 0, tid_override)
        return bytes(raw)


def encode_read(query_name, flag, tid, pos, mapq, cigartuples, seq, quals,
                next_tid=-1, next_pos=-1, tlen=0, tags=b""):
    """Build a raw BAM record body from field values (for writers/tests)."""
    name_b = query_name.encode() + b"\x00"
    ct = cigartuples or []
    cigar_b = b"".join(struct.pack("<I", (length << 4) | op)
                       for op, length in ct)
    l_seq = len(seq) if seq else 0
    seq_b = bytearray((l_seq + 1) // 2)
    code = {c: i for i, c in enumerate(_SEQ_NT16)}
    for i, ch in enumerate(seq or ""):
        v = code.get(ch.upper(), 15)
        if i % 2 == 0:
            seq_b[i // 2] |= v << 4
        else:
            seq_b[i // 2] |= v
    if quals is None:
        qual_b = b"\xff" * l_seq
    else:
        qual_b = bytes(quals)
    fixed = struct.pack(
        "<iiBBHHHiiii", tid, pos, len(name_b), mapq,
        reg2bin(pos, pos + 1) if pos >= 0 else 4680, len(ct), flag,
        l_seq, next_tid, next_pos, tlen)
    return fixed + name_b + cigar_b + bytes(seq_b) + qual_b + tags


class BamReader:
    """Whole-file BAM reader with an in-memory interval index.

    Replaces random access via BAI with a one-pass load + per-contig
    sorted index: ``fetch(chrom, start, end)`` runs a binary search on
    read starts with a prefix-max of ends (exact overlap semantics).
    This matches the access pattern of both pipelines, which either
    stream the whole file or fetch a bounded set of loci.
    """

    def __init__(self, path, reference_filename=None):
        del reference_filename  # CRAM unsupported in round 1 (gated upstream)
        self.path = path
        from kmer_denovo_filter_tpu_torch.htsio import native

        data = native.bgzf_inflate(path)
        if data is None:
            with BgzfReader(path) as fh:
                data = fh.read()
        if data[:4] != b"BAM\x01":
            raise ValueError(f"not a BAM file: {path}")
        l_text = struct.unpack_from("<i", data, 4)[0]
        self.header_text = data[8:8 + l_text].decode("utf-8", "replace")
        off = 8 + l_text
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        refs = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, off)[0]
            name = data[off + 4:off + 4 + l_name - 1].decode()
            l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
            refs.append((name, l_ref))
            off += 8 + l_name
        self.refs = refs
        self._data = data
        self._body_offset = off
        self._scan = native.bam_scan(data, off) if native.AVAILABLE \
            else None
        self._records = None
        self._tid_index = None

    @property
    def records(self):
        """All AlignedRead records (built lazily from the raw buffer)."""
        if self._records is None:
            records = []
            data = self._data
            refs = self.refs
            if self._scan is not None:
                offs = self._scan["rec_offsets"]
                sizes = self._scan["rec_sizes"]
                for i in range(self._scan["n"]):
                    o = offs[i]
                    records.append(
                        AlignedRead(data[o:o + sizes[i]], refs))
            else:
                off = self._body_offset
                n = len(data)
                while off + 4 <= n:
                    (block_size,) = struct.unpack_from("<i", data, off)
                    records.append(
                        AlignedRead(data[off + 4:off + 4 + block_size],
                                    refs))
                    off += 4 + block_size
            self._records = records
        return self._records

    # ── pysam-ish surface ──────────────────────────────────────────
    @property
    def references(self):
        return [r[0] for r in self.refs]

    @property
    def lengths(self):
        return [r[1] for r in self.refs]

    @property
    def nreferences(self):
        return len(self.refs)

    def get_tid(self, name):
        for i, (n, _) in enumerate(self.refs):
            if n == name:
                return i
        return -1

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def _build_index(self):
        if self._tid_index is not None:
            return
        idx = {}
        for rec in self.records:
            if rec.tid >= 0:
                idx.setdefault(rec.tid, []).append(rec)
        for tid, recs in idx.items():
            recs.sort(key=lambda r: r.pos)
        self._tid_index = idx
        # prefix max of reference_end for overlap binary search
        self._prefix_max_end = {}
        for tid, recs in idx.items():
            ends = []
            cur = 0
            for r in recs:
                e = r.reference_end if not r.is_unmapped else r.pos + 1
                cur = max(cur, e if e is not None else r.pos + 1)
                ends.append(cur)
            self._prefix_max_end[tid] = ends

    def fetch(self, contig=None, start=None, end=None, until_eof=False):
        """Iterate reads.

        * no args → all records with a placed position (tid >= 0), in
          file (coordinate) order — pysam ``fetch()`` semantics.
        * ``contig="*"`` → unplaced unmapped records.
        * ``contig, start, end`` → reads overlapping [start, end).
        * ``until_eof=True`` → every record in file order.
        """
        if until_eof:
            yield from self.records
            return
        if contig is None:
            for rec in self.records:
                if rec.tid >= 0:
                    yield rec
            return
        if contig == "*":
            any_unplaced = False
            for rec in self.records:
                if rec.tid < 0:
                    any_unplaced = True
                    yield rec
            if not any_unplaced and not self.records:
                return
            return
        tid = self.get_tid(contig)
        if tid < 0:
            raise ValueError(f"unknown contig: {contig}")
        self._build_index()
        recs = self._tid_index.get(tid, [])
        if not recs:
            return
        if start is None:
            yield from recs
            return
        if end is None:
            end = self.refs[tid][1]
        import bisect
        pmax = self._prefix_max_end[tid]
        # leftmost record index whose prefix-max-end > start
        lo = bisect.bisect_right(pmax, start)
        for i in range(lo, len(recs)):
            rec = recs[i]
            if rec.pos >= end:
                break
            e = rec.reference_end if not rec.is_unmapped else rec.pos + 1
            if e is None:
                e = rec.pos + 1
            if e > start:
                yield rec

    # ── packed fast path for the TPU engine ────────────────────────
    def iter_packed(self, exclude_flags=0, batch_reads=8192, records=None):
        """Yield (codes, lengths) numpy batches of 2-bit read codes.

        ``codes`` is (B, Lmax) uint8 with 4 for N / padding, ``lengths``
        is (B,) int32.  Replaces the reference's
        ``samtools fasta -F 0xD00 | jellyfish count`` producer side —
        canonical counting is strand-invariant so no reverse-complement
        restore is needed.
        """
        if records is None and self._scan is not None:
            yield from self._iter_packed_native(exclude_flags, batch_reads)
            return
        batch = []
        src = self.records if records is None else records
        for rec in src:
            if rec.flag & exclude_flags:
                continue
            if rec._l_seq == 0:
                continue
            batch.append(rec.seq_codes())
            if len(batch) >= batch_reads:
                yield _pad_batch(batch)
                batch = []
        if batch:
            yield _pad_batch(batch)

    def _iter_packed_native(self, exclude_flags, batch_reads):
        """Packed batches via the C++ scanner (no per-record Python)."""
        for out, blens, _idx in self._iter_packed_native_indexed(
                exclude_flags, batch_reads):
            yield out, blens

    def _iter_packed_native_indexed(self, exclude_flags, batch_reads):
        from kmer_denovo_filter_tpu_torch.htsio import native

        res = native.bam_codes(self._data, self._scan, exclude_flags)
        if res is None:
            batch, idxs = [], []
            for i, rec in enumerate(self.records):
                if rec.flag & exclude_flags or rec._l_seq == 0:
                    continue
                batch.append(rec.seq_codes())
                idxs.append(i)
                if len(batch) >= batch_reads:
                    out, blens = _pad_batch(batch)
                    yield out, blens, np.asarray(idxs, dtype=np.int64)
                    batch, idxs = [], []
            if batch:
                out, blens = _pad_batch(batch)
                yield out, blens, np.asarray(idxs, dtype=np.int64)
            return
        codes_flat, offsets = res
        keep = (offsets >= 0) & (self._scan["l_seqs"] > 0)
        rec_idx = np.nonzero(keep)[0]
        lens = self._scan["l_seqs"][keep].astype(np.int32)
        starts = offsets[keep]
        n = lens.shape[0]
        for lo in range(0, n, batch_reads):
            hi = min(lo + batch_reads, n)
            blens = lens[lo:hi]
            bstarts = starts[lo:hi]
            lmax = int(blens.max()) if hi > lo else 1
            b = hi - lo
            out = np.full((b, lmax), 4, dtype=np.uint8)
            total = int(blens.sum())
            read_id = np.repeat(np.arange(b), blens)
            col = (np.arange(total)
                   - np.repeat(np.cumsum(blens) - blens, blens))
            src_idx = np.repeat(bstarts, blens) + col
            out[read_id, col] = codes_flat[src_idx]
            yield out, blens, rec_idx[lo:hi]

    def iter_packed_indexed(self, exclude_flags=0, batch_reads=8192):
        """Packed batches plus each row's record index for sparse
        lazy decode via :meth:`record_at` — the producer side of the
        two-pass anchoring scan (device hit mask first, Python record
        objects only for the informative minority)."""
        if self._scan is None:
            return None
        return self._iter_packed_native_indexed(exclude_flags,
                                                batch_reads)

    def record_at(self, i):
        """Decode one record by scan index (lazy sparse access)."""
        o = int(self._scan["rec_offsets"][i])
        size = int(self._scan["rec_sizes"][i])
        return AlignedRead(self._data[o:o + size], self.refs)


def _stripe_items(gen, stripe):
    """Yield items of *gen* owned by this stripe: index ≡ h (mod n)."""
    if stripe is None:
        yield from gen
        return
    h, n = stripe
    for i, item in enumerate(gen):
        if i % n == h:
            yield item


def packed_batches(path, exclude_flags=0, batch_reads=8192, stripe=None):
    """Packed read batches, choosing whole-file vs streaming decode.

    Small files inflate once and reuse the native scan; files above
    ``KDF_STREAM_THRESHOLD_BYTES`` (default 1 GiB compressed) stream
    with O(batch) memory — the whole-BAM counting scans of WGS
    pipelines go through here.

    ``stripe=(h, n)`` restricts the yield to input shard *h* of *n*
    (multi-host per-host feeds): the streaming path stripes whole
    chunks (non-owned chunks skip code extraction and batching), the
    whole-file path stripes batches.  The union of all stripes is
    exactly the unstriped stream.
    """
    import os as _os

    threshold = int(_os.environ.get(
        "KDF_STREAM_THRESHOLD_BYTES", 1 << 30))
    try:
        size = _os.path.getsize(path)
    except OSError:
        size = 0
    if size > threshold:
        return stream_packed(path, exclude_flags, batch_reads,
                             stripe=stripe)
    return _stripe_items(
        BamReader(path).iter_packed(exclude_flags, batch_reads), stripe)


class BaiIndex:
    """BAI reader for random-access region fetches on huge BAMs."""

    def __init__(self, path):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"not a BAI index: {path}")
        (n_ref,) = struct.unpack_from("<i", data, 4)
        off = 8
        self.bins = []
        self.linear = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    chunks.append(struct.unpack_from("<QQ", data, off))
                    off += 16
                bins[b] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            lin = struct.unpack_from(f"<{n_intv}Q", data, off)
            off += 8 * n_intv
            self.bins.append(bins)
            self.linear.append(lin)

    @staticmethod
    def _reg2bins(beg, end):
        out = [0]
        end -= 1
        for base, shift in ((1, 26), (9, 23), (73, 20),
                            (585, 17), (4681, 14)):
            out.extend(range(base + (beg >> shift),
                             base + (end >> shift) + 1))
        return out

    def chunks_for(self, tid, start, end):
        """Merged candidate (vstart, vend) chunks for a region."""
        if tid < 0 or tid >= len(self.bins):
            return []
        chunks = []
        for b in self._reg2bins(start, max(end, start + 1)):
            chunks.extend(self.bins[tid].get(b, ()))
        lin = self.linear[tid]
        min_off = lin[min(start >> 14, len(lin) - 1)] if lin else 0
        chunks = sorted(c for c in chunks if c[1] > min_off)
        merged = []
        for cbeg, cend in chunks:
            cbeg = max(cbeg, min_off)
            if merged and cbeg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], cend))
            else:
                merged.append((cbeg, cend))
        return merged


def read_bam_header(path):
    """(header_text, refs) without touching the alignment records."""
    with BgzfReader(path) as fh:
        if fh.read_exact(4) != b"BAM\x01":
            raise ValueError(f"not a BAM file: {path}")
        l_text = struct.unpack("<i", fh.read_exact(4))[0]
        header_text = fh.read_exact(l_text).decode("utf-8", "replace")
        n_ref = struct.unpack("<i", fh.read_exact(4))[0]
        refs = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", fh.read_exact(4))[0]
            name = fh.read_exact(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", fh.read_exact(4))[0]
            refs.append((name, l_ref))
    return header_text, refs


class IndexedBamReader:
    """Random-access BAM reader over the BAI index (no full inflate).

    The WGS-scale counterpart of :class:`BamReader` for targeted-fetch
    workloads (VCF-mode per-variant child fetches, Kraken2 locus
    fetches, informative-read extraction): region queries seek BGZF
    virtual offsets from the BAI, touching only the needed blocks.
    """

    def __init__(self, path, reference_filename=None):
        del reference_filename
        self.path = path
        self.header_text, self.refs = read_bam_header(path)
        bai_path = path + ".bai"
        if not os.path.isfile(bai_path):
            alt = path.rsplit(".", 1)[0] + ".bai"
            if os.path.isfile(alt):
                bai_path = alt
        self._bai = BaiIndex(bai_path)

    @property
    def references(self):
        return [r[0] for r in self.refs]

    def get_tid(self, name):
        for i, (n, _) in enumerate(self.refs):
            if n == name:
                return i
        return -1

    def close(self):
        pass

    def fetch(self, contig=None, start=None, end=None, until_eof=False):
        if until_eof:
            yield from stream_records(self.path)
            return
        if contig is None:
            for rec in stream_records(self.path):
                if rec.tid >= 0:
                    yield rec
            return
        if contig == "*":
            for rec in stream_records(self.path):
                if rec.tid < 0:
                    yield rec
            return
        tid = self.get_tid(contig)
        if tid < 0:
            raise ValueError(f"unknown contig: {contig}")
        if start is None:
            start = 0
        if end is None:
            end = self.refs[tid][1]
        with BgzfReader(self.path) as fh:
            for cbeg, cend in self._bai.chunks_for(tid, start, end):
                fh.seek_virtual(cbeg)
                while fh.tell_virtual() < cend:
                    szb = fh.read(4)
                    if len(szb) < 4:
                        break
                    (block_size,) = struct.unpack("<i", szb)
                    raw = fh.read_exact(block_size)
                    rec = AlignedRead(raw, self.refs)
                    if rec.tid != tid or rec.pos >= end:
                        if rec.tid > tid or (rec.tid == tid
                                             and rec.pos >= end):
                            break
                        continue
                    rend = rec.reference_end if not rec.is_unmapped                         else rec.pos + 1
                    if rend is None:
                        rend = rec.pos + 1
                    if rend > start:
                        yield rec


def is_cram(path):
    try:
        with open(path, "rb") as fh:
            return fh.read(4) == b"CRAM"
    except OSError:
        return False


def resolve_alignment_input(path, reference_filename=None):
    """BAM path for *path*; CRAM inputs are converted once (cached
    sibling ``.converted.bam``) so every streaming/indexed BAM
    consumer accepts CRAM transparently (the reference's pysam-level
    CRAM acceptance, reference cli.py:13-24)."""
    if is_cram(path):
        from kmer_denovo_filter_tpu_torch.htsio.cram import \
            converted_bam_path
        return converted_bam_path(path, reference_filename)
    return path


def open_bam(path, reference_filename=None):
    """BamReader for small files, IndexedBamReader above the streaming
    threshold (targeted-fetch consumers only need the pysam-ish API).
    CRAM inputs are converted to BAM once and read from the cache."""
    path = resolve_alignment_input(path, reference_filename)
    threshold = int(os.environ.get(
        "KDF_STREAM_THRESHOLD_BYTES", 1 << 30))
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    if size > threshold:
        return IndexedBamReader(path, reference_filename)
    return BamReader(path, reference_filename)


def stream_records(path):
    """Yield AlignedRead records with O(buffer) memory (no full inflate).

    The record-object counterpart of :func:`stream_packed` for
    whole-genome streaming consumers that need flags/CIGAR/tags (the
    discovery anchoring scan and informative-BAM writer).  Records are
    yielded in file order, including unplaced-unmapped records at EOF.
    """
    with BgzfReader(path) as fh:
        if fh.read_exact(4) != b"BAM\x01":
            raise ValueError(f"not a BAM file: {path}")
        l_text = struct.unpack("<i", fh.read_exact(4))[0]
        fh.read_exact(l_text)
        n_ref = struct.unpack("<i", fh.read_exact(4))[0]
        refs = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", fh.read_exact(4))[0]
            name = fh.read_exact(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", fh.read_exact(4))[0]
            refs.append((name, l_ref))
        buf = b""
        pos = 0
        while True:
            if len(buf) - pos < 4:
                buf = buf[pos:] + fh.read(8 << 20)
                pos = 0
                if len(buf) < 4:
                    break
            (block_size,) = struct.unpack_from("<i", buf, pos)
            while len(buf) - pos < 4 + block_size:
                more = fh.read(8 << 20)
                if not more:
                    break
                buf = buf[pos:] + more
                pos = 0
            if len(buf) - pos < 4 + block_size:
                break
            yield AlignedRead(buf[pos + 4:pos + 4 + block_size], refs)
            pos += 4 + block_size


def _emit_code_batches(codes_flat, lens, starts, rec_idx, batch_reads):
    """(codes, lengths, record-index) batches from flat native codes.

    Uniform read lengths (the Illumina common case) take a reshape or
    2-D gather; the ragged repeat/cumsum construction is the fallback.
    """
    n = lens.shape[0]
    for lo in range(0, n, batch_reads):
        hi = min(lo + batch_reads, n)
        blens = lens[lo:hi]
        bstarts = starts[lo:hi]
        b = hi - lo
        l0 = int(blens[0]) if b else 1
        if b and (blens == l0).all():
            if b == 1 or (np.diff(bstarts) == l0).all():
                s0 = int(bstarts[0])
                out = codes_flat[s0:s0 + b * l0].reshape(b, l0)
            else:
                out = codes_flat[bstarts[:, None]
                                 + np.arange(l0)[None, :]]
            yield out, blens, rec_idx[lo:hi]
            continue
        lmax = int(blens.max()) if hi > lo else 1
        out = np.full((b, lmax), 4, dtype=np.uint8)
        total = int(blens.sum())
        read_id = np.repeat(np.arange(b), blens)
        col = (np.arange(total)
               - np.repeat(np.cumsum(blens) - blens, blens))
        src_idx = np.repeat(bstarts, blens) + col
        out[read_id, col] = codes_flat[src_idx]
        yield out, blens, rec_idx[lo:hi]


def _skip_stream_header(fh):
    """Read past a streaming BAM header, returning the refs list."""
    if fh.read_exact(4) != b"BAM\x01":
        raise ValueError("not a BAM file")
    l_text = struct.unpack("<i", fh.read_exact(4))[0]
    fh.read_exact(l_text)
    n_ref = struct.unpack("<i", fh.read_exact(4))[0]
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack("<i", fh.read_exact(4))[0]
        name = fh.read_exact(l_name)[:-1].decode()
        l_ref = struct.unpack("<i", fh.read_exact(4))[0]
        refs.append((name, l_ref))
    return refs


def stream_scan_chunks(path, chunk_bytes=64 << 20):
    """Yield (data, scan, refs) for whole-record chunks of a streaming
    BAM — the native chunk scanner walks record boundaries in C++
    (stopping cleanly at a trailing partial record), so no per-record
    Python runs for WGS-scale streams.  Yields nothing before raising
    if the native scanner is unavailable; callers hold a fallback.
    """
    from kmer_denovo_filter_tpu_torch.htsio import native
    from kmer_denovo_filter_tpu_torch.htsio.bgzf import ParallelBgzfReader

    if not native.available():
        raise RuntimeError("native scanner unavailable")
    try:
        fh_cls = ParallelBgzfReader(path)
    except ValueError:
        fh_cls = BgzfReader(path)  # plain/odd gzip: serial fallback
    with fh_cls as fh:
        refs = _skip_stream_header(fh)
        carry = b""
        while True:
            fresh = fh.read(chunk_bytes)
            data = carry + fresh
            if len(data) < 4:
                break
            scan = native.bam_scan(data, 0)
            if scan is None:
                raise RuntimeError("native scanner unavailable")
            if scan["n"] == 0:
                if not fresh:
                    break  # trailing partial record: truncated file
                carry = data
                continue
            consumed = int(scan["rec_offsets"][-1]
                           + scan["rec_sizes"][-1])
            yield data, scan, refs
            carry = data[consumed:]
            if not fresh and not carry:
                break
            if not fresh:
                break


def stream_packed(path, exclude_flags=0, batch_reads=8192, stripe=None):
    """Memory-bounded packed batches straight off the BGZF stream.

    Unlike :class:`BamReader` (which inflates the whole file — the
    right trade for targeted-fetch workloads), this walks records
    incrementally with O(chunk) memory, which is what whole-genome
    parent/child counting scans need (WGS BAMs decompress to several
    hundred GB).  Yields the same (codes, lengths) batches as
    ``iter_packed``.  With the native scanner present the walk runs
    in C++ per chunk; the pure-Python record walk is the fallback.

    ``stripe=(h, n)`` keeps only chunk stripe *h* of *n* (native path;
    non-owned chunks still advance the record walk but skip extraction
    and batching) or batch stripe *h* (Python fallback).
    """
    from kmer_denovo_filter_tpu_torch.htsio import native

    if native.available():
        def _extract_codes(item):
            data, scan, _refs = item
            res = native.bam_codes(data, scan, exclude_flags)
            if res is None:
                raise RuntimeError("native scanner unavailable")
            return scan, res

        def _native_stream():
            from kmer_denovo_filter_tpu_torch.utils import prefetch_batches

            # Three-stage pipeline: (inflate + record walk) → 2-bit
            # code extraction → batch emit, each stage one thread
            # ahead of the next (the C++ calls release the GIL, so
            # the stages genuinely overlap — measured 1.06 → 1.5 M
            # reads/s decode-only on the 2-core dev host).
            chunks = _stripe_items(stream_scan_chunks(path), stripe)
            extracted = (_extract_codes(item)
                         for item in prefetch_batches(chunks, depth=2))
            for scan, (codes_flat, offsets) in prefetch_batches(
                    extracted, depth=2):
                keep = (offsets >= 0) & (scan["l_seqs"] > 0)
                lens = scan["l_seqs"][keep].astype(np.int32)
                starts = offsets[keep]
                idx = np.nonzero(keep)[0]
                for out, blens, _idx in _emit_code_batches(
                        codes_flat, lens, starts, idx, batch_reads):
                    yield out, blens
        # fall back only BEFORE the first yield — a mid-stream failure
        # must propagate rather than silently re-stream from scratch
        gen = _native_stream()
        try:
            first = next(gen)
        except StopIteration:
            return
        except RuntimeError as e:
            if "native scanner unavailable" not in str(e):
                raise
            first = None
        if first is not None:
            yield first
            yield from gen
            return
    yield from _stripe_items(
        _stream_packed_python(path, exclude_flags, batch_reads), stripe)


def _stream_packed_python(path, exclude_flags=0, batch_reads=8192):
    """Pure-Python record walk (no native scanner)."""
    with BgzfReader(path) as fh:
        if fh.read_exact(4) != b"BAM\x01":
            raise ValueError(f"not a BAM file: {path}")
        l_text = struct.unpack("<i", fh.read_exact(4))[0]
        fh.read_exact(l_text)
        n_ref = struct.unpack("<i", fh.read_exact(4))[0]
        for _ in range(n_ref):
            l_name = struct.unpack("<i", fh.read_exact(4))[0]
            fh.read_exact(l_name + 4)

        batch = []
        buf = b""
        pos = 0
        while True:
            if len(buf) - pos < 4:
                buf = buf[pos:] + fh.read(8 << 20)
                pos = 0
                if len(buf) < 4:
                    break
            (block_size,) = struct.unpack_from("<i", buf, pos)
            while len(buf) - pos < 4 + block_size:
                more = fh.read(8 << 20)
                if not more:
                    break
                buf = buf[pos:] + more
                pos = 0
            if len(buf) - pos < 4 + block_size:
                break
            rec = buf[pos + 4:pos + 4 + block_size]
            pos += 4 + block_size
            flag = struct.unpack_from("<H", rec, 14)[0]
            if flag & exclude_flags:
                continue
            (l_seq,) = struct.unpack_from("<i", rec, 16)
            if l_seq == 0:
                continue
            l_read_name = rec[8]
            (n_cigar,) = struct.unpack_from("<H", rec, 12)
            off = 32 + l_read_name + 4 * n_cigar
            nbytes = (l_seq + 1) // 2
            packed = np.frombuffer(rec, dtype=np.uint8, count=nbytes,
                                   offset=off)
            nibbles = np.empty(nbytes * 2, dtype=np.uint8)
            nibbles[0::2] = packed >> 4
            nibbles[1::2] = packed & 0xF
            batch.append(_NT16_TO_2BIT[nibbles[:l_seq]])
            if len(batch) >= batch_reads:
                yield _pad_batch(batch)
                batch = []
        if batch:
            yield _pad_batch(batch)


def _pad_batch(code_list):
    lengths = np.array([len(c) for c in code_list], dtype=np.int32)
    lmax = int(lengths.max())
    out = np.full((len(code_list), lmax), 4, dtype=np.uint8)
    for i, c in enumerate(code_list):
        out[i, :len(c)] = c
    return out, lengths


# ── BAI index support ──────────────────────────────────────────────


def reg2bin(beg, end):
    """Compute the BAI bin for [beg, end) (SAM spec §5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BamWriter:
    """BAM writer; records are buffered so ``sort_and_index`` can run."""

    def __init__(self, path, header_text, refs):
        self.path = path
        self.header_text = header_text
        self.refs = refs
        self._bodies = []  # (tid, pos, raw_body)

    def write(self, read):
        self._bodies.append((read.tid, read.pos, read.to_raw()))

    def write_raw(self, tid, pos, raw):
        self._bodies.append((tid, pos, raw))

    def close(self, sort=False, index=False):
        if sort:
            # samtools coordinate order: by tid then pos, tid -1 last
            self._bodies.sort(
                key=lambda t: (t[0] if t[0] >= 0 else 1 << 30, t[1]))
        voffsets = []
        with BgzfWriter(self.path) as out:
            hdr = self.header_text.encode()
            out.write(b"BAM\x01" + struct.pack("<i", len(hdr)) + hdr)
            out.write(struct.pack("<i", len(self.refs)))
            for name, length in self.refs:
                nb = name.encode() + b"\x00"
                out.write(struct.pack("<i", len(nb)) + nb
                          + struct.pack("<i", length))
            for tid, pos, raw in self._bodies:
                vstart = out.tell_virtual()
                out.write(struct.pack("<i", len(raw)) + raw)
                vend = out.tell_virtual()
                voffsets.append((tid, pos, raw, vstart, vend))
        if index:
            self._write_bai(voffsets)

    def _write_bai(self, voffsets):
        n_ref = len(self.refs)
        bins_per_ref = [dict() for _ in range(n_ref)]
        linear_per_ref = [dict() for _ in range(n_ref)]
        n_unplaced = 0
        for tid, pos, raw, vstart, vend in voffsets:
            if tid < 0:
                n_unplaced += 1
                continue
            # parse n_cigar + flags to get the reference span
            (_, _, _, _, _, n_cigar, flag, _) = struct.unpack_from(
                "<iiBBHHHi", raw, 0)
            l_read_name = raw[8]
            span = 0
            if n_cigar:
                vals = struct.unpack_from(
                    f"<{n_cigar}I", raw, 32 + l_read_name)
                for v in vals:
                    if (v & 0xF) in _REF_CONSUME:
                        span += v >> 4
            end = pos + max(span, 1)
            b = reg2bin(pos, end)
            chunks = bins_per_ref[tid].setdefault(b, [])
            if chunks and chunks[-1][1] == vstart:
                chunks[-1] = (chunks[-1][0], vend)
            else:
                chunks.append((vstart, vend))
            for win in range(pos >> 14, ((end - 1) >> 14) + 1):
                lin = linear_per_ref[tid]
                if win not in lin or vstart < lin[win]:
                    lin[win] = vstart
        with open(self.path + ".bai", "wb") as fh:
            fh.write(b"BAI\x01" + struct.pack("<i", n_ref))
            for tid in range(n_ref):
                bins = bins_per_ref[tid]
                fh.write(struct.pack("<i", len(bins)))
                for b in sorted(bins):
                    chunks = bins[b]
                    fh.write(struct.pack("<Ii", b, len(chunks)))
                    for s, e in chunks:
                        fh.write(struct.pack("<QQ", s, e))
                lin = linear_per_ref[tid]
                n_intv = (max(lin) + 1) if lin else 0
                fh.write(struct.pack("<i", n_intv))
                prev = 0
                for i in range(n_intv):
                    v = lin.get(i, prev)
                    prev = v
                    fh.write(struct.pack("<Q", v))
            fh.write(struct.pack("<Q", n_unplaced))
