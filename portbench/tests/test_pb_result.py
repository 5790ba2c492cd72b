"""A run's last line: its keys, their order and the check beside it."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench.manifest import ROOT
from portbench.run import run_cell
from portbench.tests.small import small_work

CELLS = ["pose-fp32-b128", "detect-fp32-15views"]


@pytest.mark.parametrize("name", CELLS)
def test_result_keys_and_check_last(name):
    work = small_work(name)
    result = run_cell(work, 2 ** 33 + 5, 1.0, False, "cpu")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "check"
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {m["name"] for m in work["end_to_end"]} == set(result["metrics"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["check"]) == set(work["config_data"]["limits"])
    for row in result["check"].values():
        assert set(row) == {"value", "limit"}
    json.dumps(result)


def test_no_card_no_result():
    """Without a card the command prints nothing on stdout and fails."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
