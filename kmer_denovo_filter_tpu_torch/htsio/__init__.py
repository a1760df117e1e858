# Copied from kmer_denovo_filter_tpu/htsio/__init__.py
"""Self-contained htslib-free I/O stack: BGZF, BAM(+BAI), FASTA(+fai), VCF, tabix.

The reference tool relies on pysam/htslib and the samtools binary for
all alignment and variant I/O (e.g. reference core/bam_scanner.py:18,
vcf/pipeline.py:13).  This package provides the equivalent
functionality natively so the TPU build has no external binary
dependencies on its hot path.  A C++ accelerator for BGZF inflation and
BAM record parsing lives in ``_native/`` and is used transparently when
it can be built; the pure-Python/numpy path is the always-available
fallback with identical semantics.
"""

from kmer_denovo_filter_tpu_torch.htsio.bgzf import (  # noqa: F401
    BgzfReader,
    BgzfWriter,
    bgzf_compress_block,
    is_bgzf,
)
from kmer_denovo_filter_tpu_torch.htsio.bam import (  # noqa: F401
    BamReader,
    BamWriter,
    AlignedRead,
    FLAG_PAIRED,
    FLAG_PROPER_PAIR,
    FLAG_UNMAP,
    FLAG_MUNMAP,
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_QCFAIL,
    FLAG_DUP,
    FLAG_SUPPLEMENTARY,
)
from kmer_denovo_filter_tpu_torch.htsio.fasta import (  # noqa: F401
    read_fasta,
    FastaFile,
    write_fai,
)
