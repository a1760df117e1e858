"""kmer_denovo_filter_tpu_torch — PyTorch/CUDA port of the k-mer engine.

The JAX package :mod:`kmer_denovo_filter_tpu` is the reference; this
package is held against it output for output.  Slice 1 ported the
VCF-mode pipeline (``kmer-denovo``), slice 2 the discovery pipeline
(``kmer-discovery``).  Their device work runs as hand-written CUDA
kernels (``csrc/``) on an NVIDIA Hopper card — K1 window extraction,
K2 and K3 filtered tallies, K4 membership — with plain PyTorch versions
of each for CPU tensors.

Host code (BAM/CRAM/VCF I/O, the k-mer string oracle, key packing,
Kraken2, reports, argument parsing) is kept as copies of the JAX
package's modules, each headed ``Copied from ...`` and held in step by
``tests/test_torch_copies.py``.  This package imports ``torch`` and
never ``jax`` nor the JAX package.
"""

__version__ = "0.1.0"
