"""``python -m kmer_denovo_filter_tpu_torch`` runs ``kmer-denovo-torch``."""

from kmer_denovo_filter_tpu_torch.cli import vcf_main

if __name__ == "__main__":
    vcf_main()
