# Copied from kmer_denovo_filter_tpu/htsio/fasta.py
"""FASTA reading/writing with .fai support (pysam.faidx equivalent)."""

import os


def read_fasta(path):
    """Read a (possibly multi-record) FASTA file.

    Returns an ordered ``{name: sequence}`` dict.  The name is the first
    whitespace-delimited token of the header.
    """
    seqs = {}
    name = None
    chunks = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(chunks)
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        seqs[name] = "".join(chunks)
    return seqs


class FastaFile:
    """Random-access FASTA via .fai when present, else full load."""

    def __init__(self, path):
        self.path = path
        self._seqs = read_fasta(path)

    @property
    def references(self):
        return list(self._seqs)

    def fetch(self, contig, start=None, end=None):
        seq = self._seqs[contig]
        if start is None:
            return seq
        return seq[start:end]

    def get_reference_length(self, contig):
        return len(self._seqs[contig])

    def close(self):
        pass


def write_fai(fasta_path):
    """Write a samtools-compatible .fai index for *fasta_path*."""
    entries = []
    with open(fasta_path, "rb") as fh:
        name = None
        seq_len = 0
        offset = None
        line_bases = 0
        line_bytes = 0
        pos = 0
        for line in fh:
            if line.startswith(b">"):
                if name is not None:
                    entries.append(
                        (name, seq_len, offset, line_bases, line_bytes))
                name = line[1:].split()[0].decode()
                seq_len = 0
                offset = pos + len(line)
                line_bases = 0
                line_bytes = 0
            else:
                stripped = line.rstrip(b"\r\n")
                if line_bases == 0 and stripped:
                    line_bases = len(stripped)
                    line_bytes = len(line)
                seq_len += len(stripped)
            pos += len(line)
        if name is not None:
            entries.append((name, seq_len, offset, line_bases, line_bytes))
    fai = fasta_path + ".fai"
    with open(fai, "w") as out:
        for name, ln, off, lb, lw in entries:
            out.write(f"{name}\t{ln}\t{off}\t{lb}\t{lw}\n")
    return fai


def write_fasta(path, seqs, line_width=60):
    """Write ``{name: seq}`` to FASTA."""
    with open(path, "w") as fh:
        for name, seq in seqs.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                fh.write(seq[i:i + line_width] + "\n")


def delete_and_remove(path):
    try:
        os.unlink(path)
    except OSError:
        pass
