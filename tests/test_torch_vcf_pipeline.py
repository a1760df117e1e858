"""The port's ``kmer-denovo`` on the GIAB mini trio, on the CPU, must
reproduce the VCF-mode goldens byte for byte (as tests/test_goldens_self.py
does for the JAX package)."""

import gzip
import os

import pytest
import torch

from kmer_denovo_filter_tpu.cli import parse_vcf_args
from kmer_denovo_filter_tpu_torch import cli
from kmer_denovo_filter_tpu_torch.pipeline import run_pipeline
from tests.conftest import GIAB_DATA_EXISTS, GIAB_DIR

GOLD = os.path.join(os.path.dirname(__file__), "goldens")


def _argv(out_dir):
    return [
        "--child", os.path.join(GIAB_DIR, "HG002_child.bam"),
        "--mother", os.path.join(GIAB_DIR, "HG004_mother.bam"),
        "--father", os.path.join(GIAB_DIR, "HG003_father.bam"),
        "--vcf", os.path.join(GIAB_DIR, "candidates.vcf.gz"),
        "--output", os.path.join(out_dir, "annotated.vcf.gz"),
        "--metrics", os.path.join(out_dir, "metrics.json"),
        "--summary", os.path.join(out_dir, "summary.txt"),
        "--proband-id", "HG002",
    ]


@pytest.fixture(scope="module")
def port_output(tmp_path_factory):
    if not GIAB_DATA_EXISTS:
        pytest.skip("GIAB data unavailable")
    out = str(tmp_path_factory.mktemp("torch_vcf"))
    run_pipeline(parse_vcf_args(_argv(out)), torch.device("cpu"))
    return out


def test_vcf_bytes(port_output):
    exp = gzip.open(os.path.join(GOLD, "annotated.vcf.gz")).read()
    got = gzip.open(os.path.join(port_output, "annotated.vcf.gz")).read()
    assert got == exp


@pytest.mark.parametrize("name", ["metrics.json", "summary.txt"])
def test_vcf_mode_text_outputs(port_output, name):
    exp = open(os.path.join(GOLD, name)).read()
    got = open(os.path.join(port_output, name)).read()
    assert got == exp, name


def test_vcf_main_needs_cuda(tmp_path):
    """``kmer-denovo-torch`` runs on CUDA; without it, it raises before
    any work instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.vcf_main(_argv(str(tmp_path)))
    assert not os.listdir(tmp_path)
