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
from kmer_denovo_filter_tpu_torch import tracing
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


def test_report_cli_writes_the_reference_html(tmp_path, capsys):
    """``kmer-report-torch`` on the in-repo goldens (as
    tests/test_report.py:124 runs ``kmer-report``) writes the same HTML
    as the JAX package's command."""
    from kmer_denovo_filter_tpu.cli import report_main as jax_report_main
    gold = os.path.join(REPO, "tests", "goldens")
    inputs = ["--vcf-metrics", os.path.join(gold, "metrics.json"),
              "--vcf-summary", os.path.join(gold, "summary.txt"),
              "--discovery-metrics",
              os.path.join(gold, "giab_discovery.metrics.json"),
              "--discovery-summary",
              os.path.join(gold, "giab_discovery.summary.txt")]
    out = str(tmp_path / "port.html")
    cli.report_main(["--output", out] + inputs)
    assert f"Report written to: {out}" in capsys.readouterr().out
    ref = str(tmp_path / "jax.html")
    jax_report_main(["--output", ref] + inputs)
    with open(out) as a, open(ref) as b:
        html = a.read()
        assert html == b.read()
    assert "<html" in html.lower()


def test_kdf_profile_writes_a_torch_trace(tmp_path, monkeypatch):
    """``KDF_PROFILE=<dir>`` wraps a CPU VCF run in ``torch.profiler``:
    a Chrome trace lands in the directory, the port's spans and counters
    beside it (``kdf_tracing.<host>_<pid>.json``, the parent scan's
    ``filter.feed`` among them, tracing off again after the run), and
    the outputs are the goldens."""
    import gzip
    import json

    from tests.conftest import GIAB_DATA_EXISTS, GIAB_DIR

    if not GIAB_DATA_EXISTS:
        pytest.skip("GIAB data unavailable")
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("KDF_PROFILE", str(trace_dir))
    argv = ["--child", os.path.join(GIAB_DIR, "HG002_child.bam"),
            "--mother", os.path.join(GIAB_DIR, "HG004_mother.bam"),
            "--father", os.path.join(GIAB_DIR, "HG003_father.bam"),
            "--vcf", os.path.join(GIAB_DIR, "candidates.vcf.gz"),
            "--output", str(tmp_path / "annotated.vcf.gz"),
            "--proband-id", "HG002"]
    cli.vcf_main(argv, device="cpu")
    traces = [f for f in os.listdir(trace_dir)
              if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(trace_dir / traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    spans = [f for f in os.listdir(trace_dir)
             if f.startswith("kdf_tracing.") and f.endswith(".json")]
    assert len(spans) == 1
    with open(trace_dir / spans[0]) as fh:
        got = json.load(fh)
    assert got["spans"]["filter.feed"]["count"] > 0
    assert any(r["name"] == "filter.feed" for r in got["records"])
    assert any(e.get("name") == "filter.feed" for e in events)
    assert not tracing.enabled()
    gold = os.path.join(REPO, "tests", "goldens", "annotated.vcf.gz")
    with gzip.open(tmp_path / "annotated.vcf.gz") as a, gzip.open(gold) as b:
        assert a.read() == b.read()
