"""The port's ``kmer-discovery`` on the GIAB mini trio, on the CPU, must
reproduce the discovery goldens byte for byte (as
tests/test_goldens_self.py does for the JAX package), with the golden
fixture's flags (tests/conftest.py:102–112)."""

import os
import shutil

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch import cli
from kmer_denovo_filter_tpu_torch.cli import parse_discovery_args
from kmer_denovo_filter_tpu_torch.discovery.pipeline import ensure_ref_index
from kmer_denovo_filter_tpu_torch.htsio.bam import BamReader
from kmer_denovo_filter_tpu_torch.htsio.jellyfish import load_jf
from kmer_denovo_filter_tpu_torch.ops import encode as enc
from kmer_denovo_filter_tpu_torch.pipeline import run_discovery_pipeline
from tests.conftest import GIAB_DIR, GIAB_DISCOVERY_DATA_EXISTS

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
OUTPUTS = ["bed", "kmer_coverage.bedgraph", "read_coverage.bed",
           "metrics.json", "summary.txt", "sv.bedpe"]


def _argv(prefix):
    return [
        "--child", os.path.join(GIAB_DIR, "HG002_child.bam"),
        "--mother", os.path.join(GIAB_DIR, "HG004_mother.bam"),
        "--father", os.path.join(GIAB_DIR, "HG003_father.bam"),
        "--ref-fasta", os.path.join(GIAB_DIR, "mini_ref.fa"),
        "--ref-jf", os.path.join(GIAB_DIR, "mini_ref.fa.k31.jf"),
        "--out-prefix", prefix,
        "--min-child-count", "3",
        "--kmer-size", "31",
        "--candidate-summary", os.path.join(GOLD, "summary.txt"),
    ]


@pytest.fixture(scope="session")
def port_discovery(tmp_path_factory):
    if not GIAB_DISCOVERY_DATA_EXISTS:
        pytest.skip("GIAB discovery data unavailable")
    prefix = str(tmp_path_factory.mktemp("torch_discovery")
                 / "giab_discovery")
    before = sorted(os.listdir(GIAB_DIR))
    run_discovery_pipeline(parse_discovery_args(_argv(prefix)),
                           torch.device("cpu"))
    assert sorted(os.listdir(GIAB_DIR)) == before  # no cache written
    return prefix


@pytest.mark.parametrize("suffix", OUTPUTS)
def test_discovery_outputs_byte_equal(port_discovery, suffix):
    with open(os.path.join(GOLD, f"giab_discovery.{suffix}"), "rb") as fh:
        exp = fh.read()
    with open(f"{port_discovery}.{suffix}", "rb") as fh:
        assert fh.read() == exp, suffix


def test_informative_bam_tagged_and_indexed(port_discovery):
    bam = f"{port_discovery}.informative.bam"
    assert os.path.isfile(bam + ".bai")
    reads = list(BamReader(bam).fetch(until_eof=True))
    assert reads and all(r.get_tag("dk") == 1 for r in reads)
    assert len({(r.query_name, r.is_supplementary) for r in reads}) \
        == len(reads)


def test_discovery_main_needs_cuda(tmp_path):
    """``kmer-discovery-torch`` runs on CUDA; without it, it raises
    before any work instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.discovery_main(_argv(str(tmp_path / "d")))
    assert not os.listdir(tmp_path)


def test_ref_index_from_fasta_matches_the_jf(tmp_path):
    """Module 0 without ``--ref-jf``: the FASTA counted on the device
    (StreamCounter.feed_sequence) gives jellyfish's keys and counts, and
    the ``.kdx.npz`` cache written beside the FASTA reloads the same."""
    if not GIAB_DISCOVERY_DATA_EXISTS:
        pytest.skip("GIAB discovery data unavailable")
    fasta = str(tmp_path / "mini_ref.fa")
    shutil.copy(os.path.join(GIAB_DIR, "mini_ref.fa"), fasta)
    built = ensure_ref_index(fasta, 31, device="cpu")
    keys, counts, _k = load_jf(os.path.join(GIAB_DIR, "mini_ref.fa.k31.jf"),
                               expect_k=31)
    order = enc.lexsort_keys(keys)
    assert np.array_equal(built.keys_np, keys[order])
    assert np.array_equal(built.counts_np, counts[order])
    assert os.path.isfile(f"{fasta}.k31.kdx.npz")
    cached = ensure_ref_index(fasta, 31, device="cpu")
    assert np.array_equal(cached.keys_np, built.keys_np)
    assert np.array_equal(cached.counts_np, built.counts_np)
