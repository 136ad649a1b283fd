"""Finds each part of a cell by its name in ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` takes:

- ``configs/<config>.json``: the configuration as it is run (sizes,
  source, ``reduced``, ``assumed``) and ``configs/<config>.py``, which
  builds its inputs and drives the program;
- ``traffic/<cell>.json``: the mix the general generator (``mix.py``)
  reads;
- ``reference/<config>.py`` and ``reference/<config>.limits.json``: the
  plain reference and the limit of each number compared;
- ``counts/<config>.py``: its operations and bytes from the shapes;
- ``metrics/<metric>.py``: one reader a metric.

Adding a configuration, a mix or a metric is adding files and entries;
nothing here names one.
"""

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def read_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=REPO):
    return read_json(Path(root) / "BENCHMARK.json")


def load_module(path, name):
    """The module in the file ``path``, under the import name ``name``
    (file names hold '-' and '.', so they are loaded by path)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def _module_name(kind, name):
    return "portbench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name):
    """(the configuration's dict, the module that runs its cells)."""
    return (read_json(HERE / "configs" / f"{name}.json"),
            load_module(HERE / "configs" / f"{name}.py",
                        _module_name("config", name)))


def traffic(cell):
    return read_json(HERE / "traffic" / f"{cell}.json")


def reference(name):
    """(the reference module, the limits of the numbers compared)."""
    return (load_module(HERE / "reference" / f"{name}.py",
                        _module_name("reference", name)),
            read_json(HERE / "reference" / f"{name}.limits.json"))


def counts(name):
    return load_module(HERE / "counts" / f"{name}.py",
                       _module_name("counts", name))


def peaks():
    return read_json(HERE / "counts" / "peaks.json")


def metric(name):
    return load_module(HERE / "metrics" / f"{name}.py",
                       _module_name("metric", name))


def metrics_for(bench, cell, kind):
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
    those that list it under ``workloads``, and those that list none."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
