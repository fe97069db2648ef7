"""The GELU kernels' yardstick (`costs/gelu.py`): each cell's calls from
its configuration, the bound by hand at Table-1's shapes; the readers
`gelu_device_ms` and `gelu_roofline_pct` on a trace with and without the
kernels, and their pattern against the kernels' names in the source."""

from __future__ import annotations

import json
import math
import re
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.costs import gelu as costs
from benchmark.metrics import gelu_device_ms, gelu_roofline_pct
from benchmark.trace import Timeline

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def cell_config(cell: str) -> dict:
    return harness.cell_spec(cell).config


# (cell, forward calls, backward calls): a GELU teacher's blocks once, the
# remat student's twice forward and once backward, a SwiGLU teacher none
CALLS = [
    ("t1_imagenet_train", [(65792, 4096)] * 24 + [(50432, 1536)] * 24, [(50432, 1536)] * 12),
    ("t1_vitg14_imagenet_train", [(50432, 1536)] * 24, [(50432, 1536)] * 12),
    ("t3_cifar100_train", [(640, 3072)] * 12 + [(8320, 768)] * 24, [(8320, 768)] * 12),
]


@pytest.mark.parametrize("cell, fwd, bwd", CALLS)
def test_calls_from_the_configuration(cell, fwd, bwd):
    cfg = cell_config(cell)
    assert costs.gelu_calls(cfg, backward=False) == fwd
    assert costs.gelu_calls(cfg, backward=True) == bwd
    # without remat the student's forward runs once a block
    cfg["hardware"]["remat"] = False
    assert len(costs.gelu_calls(cfg, backward=False)) == len(fwd) - len(bwd)


def test_bound_by_hand_at_table1():
    """bf16 over 3.35 TB/s: 24 teacher forwards and 24 student forwards read
    x and write y, 12 student backwards read dy and x and write dx."""
    by_hand = (24 * 65792 * 4096 * 4 + 24 * 50432 * 1536 * 4
               + 12 * 50432 * 1536 * 6) / 3.35e12
    assert math.isclose(costs.gelu_bound_s(cell_config("t1_imagenet_train")), by_hand)
    assert math.isclose(by_hand * 1e3, 11.607, rel_tol=1e-4)
    vg = (24 * 50432 * 1536 * 4 + 12 * 50432 * 1536 * 6) / 3.35e12
    assert math.isclose(costs.gelu_bound_s(cell_config("t1_vitg14_imagenet_train")), vg)


def ev(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": {"correlation": corr}}


def result(kernel_names, cfg, steps=2):
    """A result whose profiled replays ran each named kernel for 100 us."""
    events = []
    for i, name in enumerate(kernel_names):
        events += [ev("cuda_runtime", "cudaGraphLaunch", 1000 * i, 5, i),
                   ev("kernel", name, 1000 * i + 10, 100, i)]
    return SimpleNamespace(trace=SimpleNamespace(replays=Timeline(events), replay_steps=steps,
                                                 cfg=cfg, costs=None))


def test_nothing_to_read_without_the_kernels():
    """The parent's program runs F.gelu's elementwise kernels: no reading."""
    r = result(["void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernelImpl>",
                "void (anonymous namespace)::swiglu_gate_vec_kernel<__nv_bfloat16>(...)"],
               cell_config("t1_imagenet_train"))
    assert gelu_device_ms.read(r) is None
    assert gelu_roofline_pct.read(r) is None


def test_readings_from_the_kernels():
    cfg = cell_config("t1_imagenet_train")
    names = ["void (anonymous namespace)::basd_gelu_fwd_vec_kernel<__nv_bfloat16>(uint4 "
             "const*, uint4*, long long, long long)",
             "void (anonymous namespace)::basd_gelu_bwd_vec_kernel<__nv_bfloat16>(...)",
             "void (anonymous namespace)::attn_fwd_mma<64, __nv_bfloat16>(...)"]
    r = result(names, cfg, steps=2)
    # two GELU kernels of 100 us over 2 replays: 0.1 ms a step
    assert math.isclose(gelu_device_ms.read(r), 0.1)
    assert math.isclose(gelu_roofline_pct.read(r), 100.0 * costs.gelu_bound_s(cfg) * 2 / 200e-6)


def test_pattern_finds_every_kernel_of_the_source_and_no_other():
    src = (harness.ROOT / "basd_tpu_torch" / "csrc" / "gelu.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\(kThreads\)\s+(\w+)\(", src)
    assert sorted(kernels) == ["basd_gelu_bwd_scalar_kernel", "basd_gelu_bwd_vec_kernel",
                               "basd_gelu_fwd_scalar_kernel", "basd_gelu_fwd_vec_kernel"]
    for reader in (gelu_device_ms, gelu_roofline_pct):
        assert all(re.search(reader.KERNELS, k) for k in kernels)
    others = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(",
                        "".join(p.read_text() for p in
                                (harness.ROOT / "basd_tpu_torch" / "csrc").glob("*.cu")
                                if p.name != "gelu.cu"))
    assert others and not [k for k in others if re.search(gelu_device_ms.KERNELS, k)]


def test_manifest_entries():
    by_name = {m["name"]: m for m in MANIFEST["per_layer"]}
    cells = [w["name"] for w in MANIFEST["workloads"]]
    assert by_name["gelu_device_ms"]["workloads"] == cells
    assert by_name["gelu_roofline_pct"]["workloads"] == ["t1_imagenet_train",
                                                         "t1_vitg14_imagenet_train"]
    for name in ("gelu_device_ms", "gelu_roofline_pct"):
        assert by_name[name]["moves"] == "train_images_per_s"
        assert by_name[name]["source"] == "device_trace"
