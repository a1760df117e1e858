"""BENCHMARK.json and every file it names: present, loadable, in shape."""

import json
import os
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_every_named_file_loads(bench):
    for entry in bench["configs"]:
        cfg = spec.config(bench, entry["name"])
        assert cfg["name"] == entry["name"]
        assert cfg["source"] == entry["source"]
        assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
        for key in entry["reduced"]:
            assert key in cfg
    for cell in bench["workloads"]:
        traffic = spec.traffic(cell["traffic"])
        assert traffic["name"] == cell["traffic"]
        drive = spec.drive(traffic["drive"])
        assert callable(drive.make)
        assert os.path.isfile(os.path.join(spec.HERE, "reference",
                                           f"{traffic['drive']}.py"))
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


def test_contract_shape(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= bench["run_seconds"] <= 51
    for path in bench["paths"]:
        assert os.path.isdir(os.path.join(spec.ROOT, path))
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in {w["config"] for w in bench["workloads"]}
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in cells:
        reported = {m["name"] for m in spec.cell_metrics(bench, w,
                                                         "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.cell_metrics(bench, w, "per_layer")
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_metric_readers_read_nothing_from_nothing(bench):
    empty = {"spans": {}, "trace": None, "work": {}, "peaks": None}
    for m in bench["per_layer"]:
        assert spec.metric_reader(m["name"]).read(empty) is None


def test_metric_readers(bench):
    """Each reader reads its own example state (``EXAMPLE`` beside it)."""
    for m in bench["per_layer"]:
        reader = spec.metric_reader(m["name"])
        state, want = reader.EXAMPLE
        assert reader.read(state) == pytest.approx(want)


def test_every_file_is_named(bench):
    """Every configuration and traffic file is one that a cell runs."""
    configs = {os.path.normpath(c["file"]) for c in bench["configs"]}
    mixes = {w["traffic"] for w in bench["workloads"]}
    for path in os.listdir(os.path.join(spec.HERE, "configs")):
        assert os.path.join(bench["paths"][0], "configs", path) in configs
    for path in os.listdir(os.path.join(spec.HERE, "traffic")):
        assert path[:-len(".json")] in mixes
