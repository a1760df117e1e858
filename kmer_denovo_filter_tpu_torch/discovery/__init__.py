"""VCF-free discovery pipeline (kmer-discovery)."""
