"""``python -m kmer_denovo_filter_tpu_torch`` runs the legacy combined
command (``cli.main``): VCF mode with ``--vcf``, discovery without it."""

from kmer_denovo_filter_tpu_torch.cli import main

if __name__ == "__main__":
    main()
