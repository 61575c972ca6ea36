"""BENCHMARK.json and the run's last line hold to the benchmark's contract;
the harness loads no module of JAX or of the JAX package (whole top-level
names: the port's name begins with the JAX package's); without a card, or
without the program beside it, a run prints no result and fails."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_names_and_files():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"] and BENCHMARK["command"][1] == "benchmark/run.py"
    cfgs = {c["name"]: c for c in BENCHMARK["configs"]}
    for c in cfgs.values():
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        cf = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/") and sorted(cf["reduced"]) == sorted(c["reduced"])
        assert cf["source"] == c["source"] and 0 < len(c["why"]) <= 200
    cells = {w["name"]: w for w in BENCHMARK["workloads"]}
    for w in cells.values():
        assert NAME.match(w["name"]) and w["config"] in cfgs and w["chips"] == 1
        assert 0 < len(w["why"]) <= 200 and "\n" not in w["why"]
        assert json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())["config"] == \
            w["config"]
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    names = [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCHMARK["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= set(cells)
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e and "workloads" in m
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    for cell in cells:
        mine = [m for m in BENCHMARK["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(cell in m["workloads"] for m in BENCHMARK["per_layer"])
    # a full check of 24 cells fits: 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 a cell
    rs = BENCHMARK["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def _small_result(tmp_path):
    code = f"""
import sys, json, time
sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, {str(ROOT)!r}]
from conftest import SMALL_BENCH, SMALL_CFG, SMALL_WL
import cell
if __name__ == "__main__":
    res = cell.run_cell(SMALL_BENCH, "small", 2**31 + 7, 0.5, False, time.monotonic(),
                        device="cpu", wl=SMALL_WL, cfg=SMALL_CFG)
    print(json.dumps(cell.forbidden_modules()))
    print(json.dumps(res))
"""
    script = tmp_path / "small_run.py"
    script.write_text(code)
    return subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT))


def test_the_last_line_parses_and_nothing_of_jax_is_loaded(tmp_path):
    out = _small_result(tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    res = json.loads(lines[-1])
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in res
    assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] >= 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for v in res["metrics"].values():
        assert isinstance(v["value"], float) and UNIT.match(v["unit"])
    assert list(res)[-1] == "checks" and all(
        set(c) == {"value", "limit"} for c in res["checks"].values())


def test_without_a_card_no_result_and_a_failing_exit():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "hf-farm.busy",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode != 0 and not out.stdout.strip()


def test_without_the_program_no_result_and_a_failing_exit(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "hf-farm.busy",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0 and not out.stdout.strip()
