"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = lambda s: isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(LINE(w) for w in MANIFEST["command"])
    assert MANIFEST["command"][1] == "benchmark/run.py"
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in MANIFEST["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and LINE(m["layer"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
    assert {m["name"]: m["bound"] for m in MANIFEST["end_to_end"]}["setup_s"] <= 0.25


def test_every_cell_reports_what_the_contract_asks():
    for cell in CELLS:
        applies = lambda m: cell in m.get("workloads", [cell])
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if applies(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(applies(m) for m in MANIFEST["per_layer"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = {w["name"]: w for w in MANIFEST["workloads"]}[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and LINE(w["why"])
    assert w["chips"] == 1
    assert (BENCH / "workloads" / f"{cell}.json").is_file()
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    cfg = {c["name"]: c for c in MANIFEST["configs"]}[w["config"]]
    assert cfg["file"] == f"benchmark/configs/{w['config']}.json"
    family = json.loads((ROOT / cfg["file"]).read_text())["family"]
    for part in ("stage", "reference", "costs"):
        assert (BENCH / part / f"{family}.py").is_file()


def test_configs_used_and_described():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and LINE(c["source"]) and LINE(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert "assumed" in body and len(c["reduced"]) <= 16


def test_every_metric_has_a_reader():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_no_harness_file_names_a_cell_or_a_configuration():
    names = CELLS + [c["name"] for c in MANIFEST["configs"]]
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert not [n for n in names if n in text], path


def test_per_layer_roofline_and_mfu_shares():
    for m in MANIFEST["per_layer"]:
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
