"""Command-line interface of the port: ``kmer-denovo-torch``.

Flag-compatible with ``kmer-denovo``: the parser is the JAX package's
:func:`kmer_denovo_filter_tpu.cli.parse_vcf_args` (that module imports
jax only inside its multi-host join, which the port does not call).
The parent scans run on the CUDA device; there is no CPU fallback.
"""

import torch

from kmer_denovo_filter_tpu.cli import parse_vcf_args


def vcf_main(argv=None):
    """Entry point for ``kmer-denovo-torch`` (VCF mode on CUDA)."""
    from kmer_denovo_filter_tpu_torch.vcf.pipeline import run_pipeline
    run_pipeline(parse_vcf_args(argv), torch.device("cuda"))
