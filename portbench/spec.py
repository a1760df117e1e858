"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: ``configs/<name>.json``, the file its entry names;
* a traffic mix: ``traffic/<name>.json``, which names its drive
  (``drives/<drive>.py``) and so its plain reference
  (``reference/<drive>.py``);
* a per-layer metric: ``metrics/<name>.py``, a module with ``read(run)``.
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _by_name(entries, name, what):
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(bench, name):
    return _by_name(bench["workloads"], name, "workload")


def config(bench, name, root=ROOT):
    entry = _by_name(bench["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as fh:
        return json.load(fh)


def traffic(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def _module(path, name):
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def drive(name):
    return _module(os.path.join(HERE, "drives", f"{name}.py"),
                   f"portbench.drives.{name}")


def metric_reader(name):
    return _module(os.path.join(HERE, "metrics", f"{name}.py"),
                   "portbench.metrics." + name.replace(".", "_"))


def cell_metrics(bench, cell_name, kind):
    """The *kind* (``end_to_end`` or ``per_layer``) metrics the cell
    reports: those with no ``workloads`` key, and those that list it."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
