"""BENCHMARK.json against the benchmark's contract, and discovery of each
cell's files by name."""
from __future__ import annotations

import json
import re
from types import SimpleNamespace

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

M = manifest.load()
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(M) == TOP
    assert len(json.dumps(M)) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(M["command"]) <= 32
    assert all(TEXT.match(w) for w in M["command"])


def test_check_fits_the_check_budget():
    runs = 2 + 14 * 24
    total = runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_are_unique_and_well_formed():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in M[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert c["file"].startswith(M["paths"][0] + "/")
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_entries(kind):
    cells = set(CELLS)
    for m in M[kind]:
        extra = {"bound"} if kind == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source"} | extra
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert TEXT.match(m["layer"])
            assert m["moves"] in {e["name"] for e in M["end_to_end"]}


def test_every_cell_reports_what_the_contract_asks():
    for name in CELLS:
        work = manifest.cell(M, name)
        e2e = {m["name"] for m in work["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert work["per_layer"]
        for m in work["per_layer"]:
            assert m["moves"] in e2e


def test_every_config_is_used():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    work = manifest.cell(M, name)
    assert work["config_data"]["name"] == work["config"]
    assert hasattr(manifest.driver(work["traffic_data"]), "Cell")
    assert work["config_data"]["limits"], "a cell without limits"


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end",
                                                         "per_layer")
                                    for m in M[k]])
def test_each_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    read = manifest.reader(metric)
    empty = SimpleNamespace(window={}, setup_s=None, trace=None, shapes={},
                            stages={})
    assert read(empty) is None
