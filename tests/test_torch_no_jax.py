"""The port never imports jax nor the JAX package.  Checked in a
subprocess, because tests/conftest.py imports jax into the pytest
process."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "kmer_denovo_filter_tpu_torch")

_PROBE = """
import importlib
import pkgutil
import sys
import kmer_denovo_filter_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")))
bad += sorted(m for m in sys.modules
              if m == "kmer_denovo_filter_tpu"
              or m.startswith("kmer_denovo_filter_tpu."))
print(len(names))
print(",".join(bad))
print(",".join(names))
"""


def test_port_modules_import_no_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n_modules, bad, names = res.stdout.split("\n")[:3]
    assert int(n_modules) >= 30  # discovery.pipeline and htsio included
    assert bad == ""
    for name in ("parallel", "parallel.sharded", "parallel.multihost",
                 "profiling", "experiments.multi_card", "entry",
                 "ops.route", "ops.convert", "ops.sortcount"):
        assert f"kmer_denovo_filter_tpu_torch.{name}" in names.split(","), name


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        sources += [os.path.join(root, f) for f in files
                    if f.endswith(".py")]
    assert len(sources) > 10
    for path in sources:
        with open(path) as fh:
            assert not pattern.search(fh.read()), path


def test_no_jax_package_import_in_port_sources():
    """No ``from``/``import kmer_denovo_filter_tpu`` that is not
    ``kmer_denovo_filter_tpu_torch``, in the package or chip_smoke.py."""
    pattern = re.compile(
        r"^\s*(from|import)\s+kmer_denovo_filter_tpu(?!_torch)\b", re.M)
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        sources += [os.path.join(root, f) for f in files
                    if f.endswith(".py")]
    for path in sources:
        with open(path) as fh:
            assert not pattern.search(fh.read()), path


def test_chip_smoke_imports_only_the_port():
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        text = fh.read()
    assert not re.search(
        r"^\s*(from|import)\s+kmer_denovo_filter_tpu(?!_torch)", text,
        re.M)
    assert re.search(r"^\s*from kmer_denovo_filter_tpu_torch", text, re.M)
