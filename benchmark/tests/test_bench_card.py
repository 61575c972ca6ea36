"""On the card: each cell's run is correct, and the control of its
comparison and a gain 3 dB off fail their limits at the cell's own size.
Run from the root of a checkout on a machine with an H100:

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct_and_its_control_is_not(card, cell):
    run = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2**31 + 77), "--seconds", "8", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert run.returncode == 0, run.stderr[-3000:]
    res = _last_json(run.stdout)
    assert res["correct"], res["checks"]
    ctl = subprocess.run([sys.executable, "benchmark/control.py", "--workload", cell, "--blocks",
                          str(res["blocks_run"]), "--seeds", str(2**31 + 77)],
                         capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert ctl.returncode == 0, ctl.stderr[-3000:]
    reading = _last_json(ctl.stdout)
    limit = res["checks"]["wave_lsb"]["limit"]
    assert reading["wave_lsb"]["control"] > limit > reading["wave_lsb"]["float32"]
    limit = res["checks"]["gain_db"]["limit"]
    assert reading["gain_db"]["gain_fault"] > limit > reading["gain_db"]["float32"]
