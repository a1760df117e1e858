"""kmer_denovo_filter_tpu_torch — PyTorch/CUDA port of the k-mer engine.

The JAX package :mod:`kmer_denovo_filter_tpu` is the reference; this
package is held against it output for output.  It runs the whole of the
reference's surface: ``kmer-denovo-torch`` (VCF mode),
``kmer-discovery-torch`` (discovery), ``kmer-report-torch``, k = 1..207
(k > 31 as rows of int64 limbs), the ``scripts/x_*.py`` experiments
(:mod:`.experiments`), the sharded engine over a mesh of devices and
N-process runs over ``torch.distributed`` (:mod:`.parallel`), and the
``KDF_PROFILE`` trace (:mod:`.profiling`).

Its device work runs as hand-written CUDA kernels (``csrc/``) on an
NVIDIA Hopper card: K1 and K1w window extraction, K2 and K3 filtered
tallies, K4 membership, K7 and K8 their wide counterparts, K9 the
segment sort, K9d and K9dw the segment dedups, and the prefix-directory
builder; each has a plain PyTorch version that CPU tensors take.

Host code (BAM/CRAM/VCF I/O, the k-mer string oracle, key packing,
Kraken2, reports, argument parsing) is kept as copies of the JAX
package's modules, each headed ``Copied from ...`` and held in step by
``tests/test_torch_copies.py``.  This package imports ``torch`` and
never ``jax`` nor the JAX package.
"""

__version__ = "0.1.0"
