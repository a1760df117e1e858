"""The port's command-line surface against the reference's: the module
invocations, the legacy combined ``cli.main`` and the ``pipeline``
re-export shim."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from kmer_denovo_filter_tpu_torch import cli
from kmer_denovo_filter_tpu_torch import pipeline as tpipeline
from kmer_denovo_filter_tpu_torch.discovery import pipeline as tdisc
from kmer_denovo_filter_tpu_torch.vcf import pipeline as tvcf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TRIO = ["--child", "c.bam", "--mother", "m.bam", "--father", "f.bam"]


def _reference_shim_names():
    """Every name ``kmer_denovo_filter_tpu/pipeline.py`` imports (and so
    re-exports), read from its source."""
    path = os.path.join(REPO, "kmer_denovo_filter_tpu", "pipeline.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    return sorted(alias.name for node in tree.body
                  if isinstance(node, ast.ImportFrom)
                  for alias in node.names)


@pytest.mark.parametrize("module", ["kmer_denovo_filter_tpu_torch.cli",
                                    "kmer_denovo_filter_tpu_torch"])
def test_module_invocation_shows_help(module):
    """``python -m <module> --help`` prints the usage and exits 0 (as
    tests/test_cli.py pins for the JAX package)."""
    out = subprocess.run([sys.executable, "-m", module, "--help"],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "usage" in out.stdout.lower()
    assert "--out-prefix" in out.stdout and "--vcf" in out.stdout


@pytest.fixture
def pipelines(monkeypatch):
    """Both pipeline entry points replaced by recorders."""
    calls = []
    monkeypatch.setattr(tvcf, "run_pipeline",
                        lambda args, device: calls.append(("vcf", args,
                                                           device)))
    monkeypatch.setattr(tdisc, "run_discovery_pipeline",
                        lambda args, device: calls.append(("discovery", args,
                                                           device)))
    return calls


def test_main_without_vcf_runs_discovery(pipelines):
    cli.main(_TRIO + ["--ref-fasta", "r.fa", "--out-prefix", "p"])
    assert len(pipelines) == 1
    mode, args, device = pipelines[0]
    assert mode == "discovery" and args.out_prefix == "p"
    assert args.vcf is None and device == torch.device("cuda")


def test_main_with_vcf_runs_vcf_mode(pipelines):
    cli.main(_TRIO + ["--vcf", "v.vcf", "--output", "o.vcf.gz"])
    assert [(mode, args.output, device) for mode, args, device in pipelines
            ] == [("vcf", "o.vcf.gz", torch.device("cuda"))]


@pytest.mark.parametrize("argv", [["--vcf", "v.vcf"], []],
                         ids=["vcf-without-output", "neither-mode"])
def test_main_refuses_an_incomplete_mode(pipelines, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(_TRIO + argv)
    assert exc.value.code == 2
    assert pipelines == []
    assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("name", _reference_shim_names())
def test_pipeline_shim_exports_every_reference_name(name):
    assert hasattr(tpipeline, name), name


def test_pipeline_shim_names_are_the_ports():
    """The shim re-exports the port's own objects, not copies."""
    assert tpipeline.run_pipeline is tvcf.run_pipeline
    assert tpipeline._write_bed is tdisc._write_bed
    assert len(_reference_shim_names()) == 31
