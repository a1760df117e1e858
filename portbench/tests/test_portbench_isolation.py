"""What a run may load and where it may run: no JAX, no run without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run, spec
from portbench.tests.conftest import CELLS, SEED, run_tiny

ROOT = spec.ROOT


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["kmer_denovo_filter_tpu_torch.engine",
                                  "jaxtyping", "flax_like", "numpy"]) == []
    assert run.forbidden_modules(
        ["jax.numpy", "jaxlib", "flax.linen", "kmer_denovo_filter_tpu.engine",
         "kmer_denovo_filter_tpu"]) == ["flax.linen", "jax.numpy", "jaxlib",
                                        "kmer_denovo_filter_tpu",
                                        "kmer_denovo_filter_tpu.engine"]


def test_a_run_loads_no_jax():
    """A tiny run of every cell, its control and every metric reader, in
    a fresh interpreter: no module of JAX or of the JAX package is
    loaded."""
    code = (
        "import json, sys\n"
        "import torch\n"
        "from portbench import spec\n"
        "from portbench.control import control_of\n"
        "from portbench.tests.conftest import CELLS, SEED, run_tiny, "
        "tiny_cell\n"
        "bench = spec.load_benchmark()\n"
        "for name in CELLS:\n"
        "    assert run_tiny(name, 0.05)['correct']\n"
        "    cfg, traffic = tiny_cell(name)[2:]\n"
        "    control_of(cfg, traffic, SEED, 3, torch.device('cpu'))\n"
        "for m in bench['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "kmer_denovo_filter_tpu_torch.engine" in modules
    assert run.forbidden_modules(modules) == []


def _bench_cmd(cwd, env=None):
    bench = spec.load_benchmark()
    cmd = bench["command"] + ["--workload", bench["workloads"][0]["name"],
                              "--seed", str(SEED), "--seconds", "1",
                              "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _bench_cmd(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_refuses_to_run_without_the_program(tmp_path):
    bench = spec.load_benchmark()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for path in bench["paths"]:
        shutil.copytree(os.path.join(ROOT, path), tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _bench_cmd(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_on_the_card(name):
    """A tiny traced run of each cell on the card: correct, with the
    per-layer metrics the cell lists, each share in 0..100 %."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run_tiny(name, 0.5, traced=True, device=torch.device("cuda", 0))
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
    bench = spec.load_benchmark()
    want = spec.cell_metrics(bench, name, "per_layer")
    assert set(out["metrics"]) == {m["name"] for m in want}
    for m in want:
        if m["unit"] == "%":
            assert 0 <= out["metrics"][m["name"]]["value"] <= 100
        if m["name"].split(".")[0].endswith("_roofline"):
            assert out["metrics"][m["name"]]["value"] > 0


def test_tiny_runs_keep_the_result_line_shape(cell_name):
    out = run_tiny(cell_name, 0.05)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert out["device"]["count"] == 1
