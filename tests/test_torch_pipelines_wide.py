"""The slice as a whole at k = 63 (W = 4 words, Q = 3 limbs): the port's
``kmer-denovo`` and ``kmer-discovery`` on the GIAB mini trio, on the CPU,
against the JAX package's pipelines at the same k, byte for byte.

There are no goldens at k = 63, so one session fixture runs the JAX
pipelines (XLA on the CPU) beside the port.  No ``.jf`` exists beyond
k = 31: Module 0 counts the FASTA and writes ``mini_ref.fa.k63.kdx.npz``
beside it, so each run takes its own copy of ``mini_ref.fa`` and
nothing is written into ``tests/data/giab``.  Discovery runs with the
golden fixture's flags (tests/conftest.py:102–112) minus ``--ref-jf``,
with the k = 63 VCF-mode summary of the same package as
``--candidate-summary``.
"""

import gzip
import os
import shutil

import pytest
import torch

from kmer_denovo_filter_tpu import cli as jcli
from kmer_denovo_filter_tpu.pipeline import (
    run_discovery_pipeline as jax_discovery,
)
from kmer_denovo_filter_tpu.pipeline import run_pipeline as jax_vcf
from kmer_denovo_filter_tpu_torch import cli as tcli
from kmer_denovo_filter_tpu_torch.pipeline import (
    run_discovery_pipeline as port_discovery,
)
from kmer_denovo_filter_tpu_torch.pipeline import run_pipeline as port_vcf
from tests.conftest import GIAB_DIR, GIAB_DISCOVERY_DATA_EXISTS

K = "63"
VCF_OUTPUTS = ["annotated.vcf.gz", "metrics.json", "summary.txt"]
DISCOVERY_OUTPUTS = ["bed", "kmer_coverage.bedgraph", "read_coverage.bed",
                     "metrics.json", "summary.txt", "sv.bedpe"]


def _trio():
    return ["--child", os.path.join(GIAB_DIR, "HG002_child.bam"),
            "--mother", os.path.join(GIAB_DIR, "HG004_mother.bam"),
            "--father", os.path.join(GIAB_DIR, "HG003_father.bam")]


def _vcf_argv(out):
    return _trio() + [
        "--vcf", os.path.join(GIAB_DIR, "candidates.vcf.gz"),
        "--output", os.path.join(out, "annotated.vcf.gz"),
        "--metrics", os.path.join(out, "metrics.json"),
        "--summary", os.path.join(out, "summary.txt"),
        "--proband-id", "HG002", "--kmer-size", K]


def _discovery_argv(out):
    return _trio() + [
        "--ref-fasta", os.path.join(out, "mini_ref.fa"),
        "--out-prefix", os.path.join(out, "giab_discovery"),
        "--min-child-count", "3", "--kmer-size", K,
        "--candidate-summary", os.path.join(out, "summary.txt")]


def _run(out, vcf, discovery, parse_vcf, parse_discovery):
    os.makedirs(out)
    for name in ("mini_ref.fa", "mini_ref.fa.fai"):
        shutil.copy(os.path.join(GIAB_DIR, name), out)
    vcf(parse_vcf(_vcf_argv(out)))
    discovery(parse_discovery(_discovery_argv(out)))
    return out


@pytest.fixture(scope="session")
def runs(tmp_path_factory):
    if not GIAB_DISCOVERY_DATA_EXISTS:
        pytest.skip("GIAB discovery data unavailable")
    root = str(tmp_path_factory.mktemp("wide_k63"))
    before = sorted(os.listdir(GIAB_DIR))
    cpu = torch.device("cpu")
    jax_out = _run(os.path.join(root, "jax"), jax_vcf, jax_discovery,
                   jcli.parse_vcf_args, jcli.parse_discovery_args)
    port_out = _run(os.path.join(root, "port"),
                    lambda a: port_vcf(a, cpu),
                    lambda a: port_discovery(a, cpu),
                    tcli.parse_vcf_args, tcli.parse_discovery_args)
    return jax_out, port_out, before


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("name", VCF_OUTPUTS)
def test_vcf_mode_outputs_byte_equal(runs, name):
    jax_out, port_out, _ = runs
    exp = _read(os.path.join(jax_out, name))
    assert exp and _read(os.path.join(port_out, name)) == exp, name


@pytest.mark.parametrize("suffix", DISCOVERY_OUTPUTS)
def test_discovery_outputs_byte_equal(runs, suffix):
    jax_out, port_out, _ = runs
    name = f"giab_discovery.{suffix}"
    exp = _read(os.path.join(jax_out, name))
    assert _read(os.path.join(port_out, name)) == exp, name


def test_outputs_are_wide_and_nothing_written_into_the_data(runs):
    """The runs found what a k = 63 run finds (not empty outputs), each
    cached its reference set beside its own FASTA copy, and the input
    directory is unchanged."""
    jax_out, port_out, before = runs
    assert sorted(os.listdir(GIAB_DIR)) == before
    for out in (jax_out, port_out):
        assert os.path.isfile(os.path.join(out, f"mini_ref.fa.k{K}.kdx.npz"))
    summary = _read(os.path.join(port_out, "giab_discovery.summary.txt"))
    assert b"63" in summary
    assert _read(os.path.join(port_out, "giab_discovery.bed")).strip()
    assert os.path.isfile(
        os.path.join(port_out, "giab_discovery.informative.bam.bai"))
