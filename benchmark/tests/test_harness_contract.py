"""The result line of a run, from a CPU wiring run of each cell (`--smoke`:
every width cut, the kernels' plain versions; its numbers mean nothing),
and the runs that must print no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def run(args, cwd=ROOT, timeout=600):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    out = run(["--workload", cell, "--seed", "3000000011", "--seconds", "1",
               "--trace", str(trace), "--smoke"])
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "compared"
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    kind = "end_to_end" if trace == 0 else "per_layer"
    allowed = {m["name"]: m["unit"] for m in MANIFEST[kind]
               if cell in m.get("workloads", [cell])}
    for name, metric in line["metrics"].items():
        assert allowed[name] == metric["unit"] and isinstance(metric["value"], float)
    if trace == 0:
        assert "setup_s" in line["metrics"] and "train_images_per_s" in line["metrics"]
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    limits = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())["limits"]
    assert set(line["compared"]) == set(limits)
    for name, c in line["compared"].items():
        assert c["limit"] == limits[name] and c["value"] >= 0.0
    # the numbers compared are the last lines on standard error
    tail = out.stderr.strip().splitlines()[-len(limits):]
    assert [t.split()[1] for t in tail] == list(line["compared"])


def test_no_card_no_result():
    out = run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_is_no_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0",
               "--smoke"], cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
