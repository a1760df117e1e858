"""VCF-mode pipeline (``kmer-denovo``)."""
