"""The port's copied host I/O on the GIAB mini trio equals the JAX
package's: packed read batches, BAM headers, FASTA and ``.jf`` loading."""

import os

import numpy as np
import pytest

from kmer_denovo_filter_tpu.htsio import bam as jbam
from kmer_denovo_filter_tpu.htsio import fasta as jfasta
from kmer_denovo_filter_tpu.htsio import jellyfish as jjf
from kmer_denovo_filter_tpu_torch.htsio import bam as tbam
from kmer_denovo_filter_tpu_torch.htsio import fasta as tfasta
from kmer_denovo_filter_tpu_torch.htsio import jellyfish as tjf
from kmer_denovo_filter_tpu_torch.htsio import native as tnative
from tests.conftest import GIAB_DATA_EXISTS, GIAB_DIR

pytestmark = pytest.mark.skipif(not GIAB_DATA_EXISTS,
                                reason="GIAB data unavailable")


@pytest.mark.parametrize("name", ["HG002_child.bam", "HG004_mother.bam"])
def test_packed_batches_equal(name):
    path = os.path.join(GIAB_DIR, name)
    got = list(tbam.packed_batches(path, exclude_flags=0xD00))
    ref = list(jbam.packed_batches(path, exclude_flags=0xD00))
    assert len(got) == len(ref) > 0
    for (c, l), (rc, rl) in zip(got, ref):
        assert np.array_equal(c, rc) and np.array_equal(l, rl)


def test_bam_header_equal():
    path = os.path.join(GIAB_DIR, "HG003_father.bam")
    assert tbam.read_bam_header(path) == jbam.read_bam_header(path)


def test_fasta_equal():
    path = os.path.join(GIAB_DIR, "mini_ref.fa")
    got = tfasta.read_fasta(path)
    assert got and got == jfasta.read_fasta(path)


def test_jf_equal():
    path = os.path.join(GIAB_DIR, "mini_ref.fa.k31.jf")
    got = tjf.load_jf(path, expect_k=31)
    ref = jjf.load_jf(path, expect_k=31)
    assert got[2] == ref[2] == 31
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])


def test_native_builds_into_the_port_build_dir():
    """The port's native library builds from its own source into the
    gitignored build directory, never beside the source."""
    if not tnative.available():
        pytest.skip("no C++ toolchain")
    src_dir = os.path.dirname(tnative._SRC)
    assert os.listdir(src_dir) == ["kdf_native.cpp"]
    built = os.path.join(tnative._BUILD_DIR, tnative._src_hash(),
                         "kdf_native.so")
    assert os.path.isfile(built)
