"""The precision control (the reference with every bf16 value of the
configuration, and every gradient through one, rounded to float8 e4m3),
the half-batch fault and the flat selector, put in the program's place,
fail the cell's limits. On the CPU at the wiring check's
size; `python -m benchmark.control` reads them on the card at the cell's
own size (PERF.md gives those readings)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_fault_fail_a_limit(cell):
    spec = harness.cell_spec(cell)
    limits = spec.workload["limits"]
    got = control.readings(spec, harness.smoke_config(spec.config), 3000000031,
                           torch.device("cpu"))
    for kind in ("control", "half_batch", "flat_selector"):
        assert any(got[kind][n] > limit for n, limit in limits.items()), (kind, got[kind])
