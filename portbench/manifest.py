"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
the configurations and the metrics. Everything particular to one of them
sits in a file found by its name: ``portbench/configs/<config>.json``
(the configuration's ``file``), ``portbench/traffic/<traffic>.json`` (a
traffic mix: the parameters that the driver module named in it reads) and
``portbench/metrics/<metric>.py`` (a metric's reader). A later cell, mix or
metric is added by adding files and entries, never by editing these.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    """The workload ``name`` with its configuration and traffic files
    read, and the metrics it reports: ``end_to_end`` and ``per_layer``,
    each a list of the manifest's entries that name it (or name no
    cells)."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; the manifest has "
                       f"{sorted(by_name)}")
    work = dict(by_name[name])
    conf = {c["name"]: c for c in manifest["configs"]}[work["config"]]
    work["config_entry"] = conf
    work["config_data"] = read_json(ROOT / conf["file"])
    work["traffic_data"] = read_json(PACKAGE / "traffic"
                                     / f"{work['traffic']}.json")
    for kind in ("end_to_end", "per_layer"):
        work[kind] = [m for m in manifest[kind]
                      if name in m.get("workloads", [name])]
    return work


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def driver(traffic: dict):
    """The driver module that the traffic mix names."""
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def reader(metric: str):
    """The ``read(ctx)`` function of ``portbench/metrics/<metric>.py``."""
    path = PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
