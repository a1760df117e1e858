"""The port keeps its own copies of the JAX package's host modules, and
they stay in step: each copy is its source with ``kmer_denovo_filter_tpu.``
rewritten to ``kmer_denovo_filter_tpu_torch.``, after a one-line
``Copied from`` header.  Two copies change behaviour on purpose; for them
every other top-level definition must still match."""

import ast
import inspect
import os

import pytest

from kmer_denovo_filter_tpu import cli as jcli
from kmer_denovo_filter_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "kmer_denovo_filter_tpu")
PORT = os.path.join(REPO, "kmer_denovo_filter_tpu_torch")

COPIES = [
    "ops/encode.py", "kmer.py", "kraken2.py", "kraken2_beds.py",
    "report.py", "htsio/__init__.py", "htsio/bam.py", "htsio/bgzf.py",
    "htsio/cram.py", "htsio/cram_codecs.py", "htsio/fasta.py",
    "htsio/jellyfish.py", "htsio/tabix.py", "htsio/vcf.py",
    "htsio/_native/kdf_native.cpp",
]
# copy → (top-level names that differ, why)
CHANGED = {
    "htsio/native.py": (
        {"_LIB", "_HASH", "_BUILD_DIR", "_build", "_load"},
        "builds kdf_native.so into the port's gitignored build/ directory, "
        "keyed by the source hash, never beside the source"),
    "memory_utils.py": (
        {"log_device_memory"},
        "reads torch.cuda.memory_stats instead of jax.local_devices()"),
    "utils.py": (
        {"prefetch_batches"},
        "opens the port's tracing spans prefetch.decode and prefetch.wait "
        "around the producer's next() and the consumer's wait"),
}
CLI_COPIED = ["_add_shared_args", "parse_vcf_args", "_add_discovery_args",
              "parse_discovery_args", "parse_args", "parse_report_args",
              "report_main"]


def _read(root, rel):
    with open(os.path.join(root, rel)) as fh:
        return fh.read()


def _rewritten(rel):
    return _read(REF, rel).replace("kmer_denovo_filter_tpu.",
                                   "kmer_denovo_filter_tpu_torch.")


def _split_header(rel):
    head, _, body = _read(PORT, rel).partition("\n")
    comment = "//" if rel.endswith(".cpp") else "#"
    assert head == f"{comment} Copied from kmer_denovo_filter_tpu/{rel}"
    return body


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_its_source(rel):
    assert _split_header(rel) == _rewritten(rel), rel


def _definitions(text):
    """{top-level name: source} of a module's defs, classes and
    assignments (the module docstring excluded)."""
    out = {}
    for node in ast.parse(text).body:
        names = ([node.name] if hasattr(node, "name") else
                 [t.id for t in getattr(node, "targets", [])
                  if isinstance(t, ast.Name)])
        for name in names:
            out[name] = ast.get_source_segment(text, node)
    return out


@pytest.mark.parametrize("rel", sorted(CHANGED))
def test_changed_copy_matches_outside_its_changes(rel):
    changed, why = CHANGED[rel]
    assert why
    got = _definitions(_split_header(rel))
    ref = _definitions(_rewritten(rel))
    same = set(got) - changed
    assert same == set(ref) - changed
    assert len(same) >= 5
    for name in sorted(same):
        assert got[name] == ref[name], (rel, name)
    assert changed & set(got)


@pytest.mark.parametrize("name", CLI_COPIED)
def test_cli_parsers_copied(name):
    """Each is its source with the package renamed, as the module copies
    are (``report_main`` imports the port's ``report``)."""
    assert (inspect.getsource(getattr(tcli, name))
            == inspect.getsource(getattr(jcli, name)).replace(
                "kmer_denovo_filter_tpu.", "kmer_denovo_filter_tpu_torch."))


def test_every_copy_is_listed():
    """Every port file with a ``Copied from`` header is checked here."""
    listed = set(COPIES) | set(CHANGED)
    found = set()
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith((".py", ".cpp")):
                rel = os.path.relpath(os.path.join(root, f), PORT)
                with open(os.path.join(root, f)) as fh:
                    if fh.readline().startswith(("# Copied from",
                                                 "// Copied from")):
                        found.add(rel)
    assert found == listed
