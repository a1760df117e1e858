"""kmer_denovo_filter_tpu_torch — PyTorch/CUDA port of the k-mer engine.

The JAX package :mod:`kmer_denovo_filter_tpu` is the reference; this
package is held against it output for output.  Slice 1 ports the
VCF-mode pipeline (``kmer-denovo``): the parent scan runs as two
hand-written CUDA kernels (``csrc/``) on an NVIDIA Hopper card, with
plain PyTorch versions of both for CPU tensors.

Host code with no JAX dependency (BAM/VCF I/O, the k-mer string
oracle, key packing, Kraken2, reports) is imported from the JAX
package rather than copied.  This package imports ``torch`` and never
``jax``.
"""

__version__ = "0.1.0"
