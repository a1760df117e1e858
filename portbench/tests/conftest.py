"""Shared set-up of the benchmark's tests: the cells of BENCHMARK.json,
each cut to its drive's tiny size (the drive's ``TINY`` overrides) and
run on the CPU device."""

import time

import pytest

from portbench import spec

SEED = (1 << 31) + 977  # past 32 signed bits, as the driver's are
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def drive_of(name):
    """The name of the drive that the cell *name* runs."""
    return spec.traffic(spec.cell(spec.load_benchmark(), name)["traffic"])[
        "drive"]


def tiny_cell(name):
    """(bench, cell, tiny config, tiny traffic) of the cell *name*."""
    bench = spec.load_benchmark()
    cell = spec.cell(bench, name)
    traffic = spec.traffic(cell["traffic"])
    tiny = spec.drive(traffic["drive"]).TINY
    return (bench, cell, dict(spec.config(bench, cell["config"]),
                              **tiny["config"]),
            dict(traffic, **tiny["traffic"]))


def run_tiny(name, seconds=0.2, seed=SEED, traced=False, device="cpu"):
    """One run of the cell *name* at its tiny size on *device*."""
    from portbench import run
    return run.run_cell(*tiny_cell(name), seed, seconds, traced, device,
                        time.perf_counter())


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param
