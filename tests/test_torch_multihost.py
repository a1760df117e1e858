"""The port's multi-host layer (:mod:`kmer_denovo_filter_tpu_torch.parallel.
multihost`) in gloo process groups of 2 and 4 CPU processes, mirroring
tests/test_multihost.py: the collectives against single-process results
and the JAX package's owner partition, and ``kmer-denovo-torch`` /
``kmer-discovery-torch`` as N-process runs whose process 0 writes the
goldens byte for byte.

Workers are subprocesses that import only the port; each gets its own
``communicate(timeout=...)``.  ``KDF_SKIP_MULTIHOST=1`` skips them.
"""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu.parallel import multihost as jmultihost
from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch.cli import parse_discovery_args
from kmer_denovo_filter_tpu_torch.discovery.pipeline import (
    run_discovery_pipeline,
)
from kmer_denovo_filter_tpu_torch.htsio.bam import BamReader
from kmer_denovo_filter_tpu_torch.parallel import multihost
from tests.conftest import GIAB_DATA_EXISTS, GIAB_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
DISCOVERY_OUTPUTS = ["bed", "kmer_coverage.bedgraph", "read_coverage.bed",
                     "metrics.json", "summary.txt", "sv.bedpe"]

skip_multihost = pytest.mark.skipif(
    os.environ.get("KDF_SKIP_MULTIHOST") == "1",
    reason="multihost harness disabled")

# The joining preamble of every worker: argv is pid, nproc, port, then
# the worker's own arguments.
_JOIN = r"""
import os, sys
import numpy as np
import torch

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["KDF_COORDINATOR"] = f"127.0.0.1:{port}"
os.environ["KDF_NUM_PROCESSES"] = str(nproc)
os.environ["KDF_PROCESS_ID"] = str(pid)
"""

PRIMITIVES_WORKER = _JOIN + r"""
outdir = sys.argv[4]
from kmer_denovo_filter_tpu_torch.parallel import multihost

assert multihost.initialize(device="cpu")
assert multihost.initialize(device="cpu")   # idempotent once joined
assert multihost.active() and multihost.stripe() == (pid, nproc)
assert multihost.is_primary() == (pid == 0)
assert multihost.device() == torch.device("cpu")

out = {}
# sharded_count_multihost: each process feeds its own rows
for k, width in ((31, 64), (63, 96)):
    rng = np.random.default_rng(7)              # same stream everywhere
    codes = rng.integers(0, 4, size=(16, width), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    lengths = rng.integers(k, width + 1, size=16).astype(np.int32)
    rows = slice(pid * 16 // nproc, (pid + 1) * 16 // nproc)
    out[f"count{k}_keys"], out[f"count{k}_counts"] = (
        multihost.sharded_count_multihost(codes[rows], lengths[rows], k))
    out[f"shard{k}_keys"], out[f"shard{k}_counts"] = (
        multihost.sharded_count_multihost(codes[rows], lengths[rows], k,
                                          per_process=True))

# merge_counts_sharded: per-process partials with heavy key overlap
rng = np.random.default_rng(100 + pid)
keys = rng.integers(0, 512, size=(4096, 2)).astype(np.uint32)
keys[:, 1] &= np.uint32(0xFFFFFFFC)
counts = rng.integers(1, 5, size=4096).astype(np.int64)
out["in_keys"], out["in_counts"] = keys, counts
out["merge_keys"], out["merge_counts"] = multihost.merge_counts_sharded(
    keys, counts)
stats = dict(multihost.LAST_MERGE_STATS)
out["peak_round_bytes"] = stats["peak_round_bytes"]
out["survivors"] = multihost.allgather_keys_sorted(
    out["merge_keys"][out["merge_counts"] >= 8])
out["global_keys"], out["global_counts"] = multihost.merge_counts(
    keys, counts)
out["sum_np"] = multihost.sum_aligned(np.arange(5, dtype=np.int64)
                                      * (pid + 1))
out["sum_t"] = multihost.sum_aligned(
    torch.arange(5, dtype=torch.int64) * (pid + 1)).numpy()
out["sum_scalar"] = multihost.sum_aligned(np.int64(pid))
out["pids"] = np.array([o["pid"] for o in multihost.allgather_object(
    {"pid": pid})])
np.savez(os.path.join(outdir, f"prim_{pid}.npz"), **out)
multihost.shutdown()
assert not multihost.joined()
print(f"[{pid}] primitives done")
"""

VCF_WORKER = _JOIN + r"""
outdir, giab = sys.argv[4], sys.argv[5]
from kmer_denovo_filter_tpu_torch.cli import vcf_main

vcf_main([
    "--vcf", os.path.join(giab, "candidates.vcf.gz"),
    "--child", os.path.join(giab, "HG002_child.bam"),
    "--mother", os.path.join(giab, "HG004_mother.bam"),
    "--father", os.path.join(giab, "HG003_father.bam"),
    "--output", os.path.join(outdir, "annotated.vcf.gz"),
    "--metrics", os.path.join(outdir, "metrics.json"),
    "--summary", os.path.join(outdir, "summary.txt"),
    "--proband-id", "HG002",
], device="cpu")
print(f"[{pid}] vcf pipeline done")
"""

DISCOVERY_WORKER = _JOIN + r"""
out_prefix, giab, candidate_summary = sys.argv[4:7]
from kmer_denovo_filter_tpu_torch.cli import discovery_main

discovery_main([
    "--child", os.path.join(giab, "HG002_child.bam"),
    "--mother", os.path.join(giab, "HG004_mother.bam"),
    "--father", os.path.join(giab, "HG003_father.bam"),
    "--ref-fasta", os.path.join(giab, "mini_ref.fa"),
    "--ref-jf", os.path.join(giab, "mini_ref.fa.k31.jf"),
    "--out-prefix", out_prefix,
    "--min-child-count", "3",
    "--kmer-size", "31",
    "--candidate-summary", candidate_summary,
], device="cpu")
print(f"[{pid}] discovery pipeline done")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, source, nproc, args, timeout):
    """Run *nproc* workers of *source* in one process group; each must
    exit 0 within *timeout* seconds."""
    worker = tmp_path / f"worker_{nproc}.py"
    worker.write_text(source)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # N workers share the test's cores
    for name in ("KDF_COORDINATOR", "KDF_NUM_PROCESSES", "KDF_PROCESS_ID",
                 "KDF_SHARDED", "KDF_PROFILE"):
        env.pop(name, None)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), str(nproc), str(port),
         *args], env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(nproc)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}\n{err}"


@pytest.fixture(scope="module", params=[2, 4])
def primitives(request, tmp_path_factory):
    """Each process's results of the primitives worker, by process."""
    if os.environ.get("KDF_SKIP_MULTIHOST") == "1":
        pytest.skip("multihost harness disabled")
    nproc = request.param
    tmp = tmp_path_factory.mktemp(f"prim{nproc}")
    _run_workers(tmp, PRIMITIVES_WORKER, nproc, [str(tmp)], timeout=240)
    return [dict(np.load(tmp / f"prim_{pid}.npz")) for pid in range(nproc)]


def _single_count(k, width):
    """The single-process count of the workers' 16 reads."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=(16, width), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    lengths = rng.integers(k, width + 1, size=16).astype(np.int32)
    sc = eng.StreamCounter(k, device=torch.device("cpu"))
    sc.feed(codes, lengths)
    return sc.result()


@pytest.mark.parametrize("k, width", [(31, 64), (63, 96)])
def test_sharded_count_multihost(primitives, k, width):
    """The gathered count is the same on every process and equals the
    single-process count; the per-process shards are disjoint and their
    union is that count."""
    want_k, want_c = _single_count(k, width)
    assert want_k.shape[0] > 100
    for r in primitives:
        assert np.array_equal(r[f"count{k}_keys"], want_k)
        assert np.array_equal(r[f"count{k}_counts"], want_c)
    got_k = np.concatenate([r[f"shard{k}_keys"] for r in primitives])
    got_c = np.concatenate([r[f"shard{k}_counts"] for r in primitives])
    assert got_k.shape[0] == want_k.shape[0]
    order = np.lexsort(got_k.T[::-1])
    assert np.array_equal(got_k[order], want_k)
    assert np.array_equal(got_c[order], want_c)
    if len(primitives) > 1:
        assert all(r[f"shard{k}_keys"].shape[0] for r in primitives)


def test_merge_counts_sharded_partition_and_memory(primitives):
    """Disjoint shards, each of keys the JAX package's owner function
    gives this process, whose union is the global merge; each round
    gathers about 1/N of the global table."""
    nproc = len(primitives)
    all_k = np.concatenate([r["in_keys"] for r in primitives])
    all_c = np.concatenate([r["in_counts"] for r in primitives])
    want_k, want_c = jmultihost._merge_sorted_parts([all_k], [all_c])
    for pid, r in enumerate(primitives):
        assert (jmultihost._owner_of_keys(r["merge_keys"], nproc)
                == pid).all()
    got_k = np.concatenate([r["merge_keys"] for r in primitives])
    got_c = np.concatenate([r["merge_counts"] for r in primitives])
    order = np.lexsort(got_k.T[::-1])
    assert np.array_equal(got_k[order], want_k)
    assert np.array_equal(got_c[order], want_c)
    global_bytes = want_k.nbytes + want_c.nbytes
    for r in primitives:
        assert 0 < int(r["peak_round_bytes"]) < global_bytes / nproc * 2.5
    for r in primitives:
        assert np.array_equal(r["survivors"], want_k[want_c >= 8])
        assert np.array_equal(r["global_keys"], want_k)
        assert np.array_equal(r["global_counts"], want_c)


def test_sums_and_gathers(primitives):
    nproc = len(primitives)
    scale = sum(range(1, nproc + 1))
    for r in primitives:
        assert r["sum_np"].tolist() == [i * scale for i in range(5)]
        assert r["sum_t"].tolist() == [i * scale for i in range(5)]
        assert int(r["sum_scalar"]) == sum(range(nproc))
        assert r["pids"].tolist() == list(range(nproc))


@pytest.mark.parametrize("nproc", [2, 3, 4, 8])
@pytest.mark.parametrize("w", [2, 4])
def test_owner_of_keys_equals_jax(nproc, w):
    rng = np.random.default_rng(nproc * 10 + w)
    keys = rng.integers(0, 1 << 32, size=(5000, w), dtype=np.uint64).astype(
        np.uint32)
    got = multihost._owner_of_keys(keys, nproc)
    assert np.array_equal(got, jmultihost._owner_of_keys(keys, nproc))
    assert set(got.tolist()) == set(range(nproc))


def test_single_process_falls_back_to_local_results():
    """Without a process group every helper is the one-process case."""
    assert not multihost.joined() and multihost.stripe() is None
    assert multihost.is_primary() and multihost.process_count() == 1
    assert multihost.allgather_bytes(b"abc") == [b"abc"]
    assert multihost.sum_aligned(np.arange(3)).tolist() == [0, 1, 2]
    keys = np.array([[3, 1], [1, 2], [3, 1]], dtype=np.uint32)
    got_k, got_c = multihost.merge_counts_sharded(keys, np.array([1, 2, 3]))
    assert got_k.tolist() == [[1, 2], [3, 1]] and got_c.tolist() == [2, 4]
    assert multihost.LAST_MERGE_STATS["n_processes"] == 1


@pytest.fixture(scope="module")
def single_discovery(tmp_path_factory):
    """One single-process port discovery run on the CPU (for the
    informative BAM, which has no golden)."""
    if not GIAB_DATA_EXISTS:
        pytest.skip("GIAB data unavailable")
    prefix = str(tmp_path_factory.mktemp("single") / "giab_discovery")
    run_discovery_pipeline(parse_discovery_args(_discovery_argv(prefix)),
                           torch.device("cpu"))
    return prefix


def _discovery_argv(prefix):
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


def _bam_records(path):
    return [(r.query_name, r.reference_id, r.reference_start, r.flag,
             r.query_sequence, r.get_tag("dk"))
            for r in BamReader(path).fetch(until_eof=True)]


@skip_multihost
def test_two_process_vcf_end_to_end(tmp_path):
    """``kmer-denovo-torch`` as a 2-process run: the parent scans stripe
    across processes; process 0 writes the three goldens."""
    if not GIAB_DATA_EXISTS:
        pytest.skip("GIAB data unavailable")
    _run_workers(tmp_path, VCF_WORKER, 2, [str(tmp_path), GIAB_DIR],
                 timeout=300)
    with gzip.open(tmp_path / "annotated.vcf.gz") as a, \
            gzip.open(os.path.join(GOLD, "annotated.vcf.gz")) as b:
        assert a.read() == b.read()
    for name in ("metrics.json", "summary.txt"):
        with open(tmp_path / name, "rb") as a, \
                open(os.path.join(GOLD, name), "rb") as b:
            assert a.read() == b.read(), name


@skip_multihost
@pytest.mark.parametrize("nproc", [2, 4])
def test_discovery_end_to_end_multiprocess(tmp_path, nproc,
                                           single_discovery):
    """``kmer-discovery-torch`` as an N-process run: process 0 writes the
    six goldens byte for byte and the informative BAM's records; the
    4-process case has uneven stripes in the owner-sharded merge."""
    prefix = str(tmp_path / "mh_discovery")
    _run_workers(tmp_path, DISCOVERY_WORKER, nproc,
                 [prefix, GIAB_DIR, os.path.join(GOLD, "summary.txt")],
                 timeout=300)
    for suffix in DISCOVERY_OUTPUTS:
        with open(f"{prefix}.{suffix}", "rb") as a, open(os.path.join(
                GOLD, f"giab_discovery.{suffix}"), "rb") as b:
            assert a.read() == b.read(), suffix
    assert (_bam_records(f"{prefix}.informative.bam")
            == _bam_records(f"{single_discovery}.informative.bam"))
