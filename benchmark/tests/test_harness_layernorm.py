"""The LayerNorm kernel's yardstick (`costs/layernorm.py`): each cell's
teacher LayerNorms from its configuration, the bound by hand at t1's and
dv's shapes; the readers `layernorm_device_ms` and `layernorm_roofline_pct`
on a trace with and without the kernels, their pattern against the kernels'
names in the source and torch's LayerNorm kernel, and their manifest
entries."""

from __future__ import annotations

import json
import math
import re
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.costs import layernorm as costs
from benchmark.metrics import layernorm_device_ms, layernorm_roofline_pct
from benchmark.trace import Timeline

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
TORCH_LN = ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, "
            "float>(int, float, float const*, float const*, float const*, float*, float*, "
            "float*)")


def cell_config(cell: str) -> dict:
    return harness.cell_spec(cell).config


# (cell, calls, rows, width): 2 depth + 1 over batch x (patches + CLS +
# registers) rows of the teacher's width
CALLS = [
    ("t3_cifar100_train", 25, 128 * 5, 768),
    ("t1_imagenet_train", 49, 256 * 257, 1024),
    ("t1_vitg14_imagenet_train", 81, 256 * 257, 1536),
    ("t1_dinov3_vit7b_imagenet_train", 81, 256 * 201, 4096),
]


@pytest.mark.parametrize("cell, calls, rows, width", CALLS)
def test_calls_from_the_configuration(cell, calls, rows, width):
    assert costs.layernorm_calls(cell_config(cell)) == [(rows, width)] * calls


def test_bound_by_hand():
    """bf16 over 3.35 TB/s, x read and y written once a call: t1 49 calls
    of 67,371,008 values, dv 81 of 210,763,776 (CLS, 4 registers and 196
    patches a row of 256)."""
    t1 = 49 * 4 * 67_371_008 / 3.35e12
    assert math.isclose(costs.layernorm_bound_s(cell_config("t1_imagenet_train")), t1)
    assert math.isclose(t1 * 1e3, 3.941, rel_tol=1e-3)
    dv = 81 * 4 * 210_763_776 / 3.35e12
    assert math.isclose(costs.layernorm_bound_s(cell_config("t1_dinov3_vit7b_imagenet_train")),
                        dv)
    assert math.isclose(dv * 1e3, 20.38, rel_tol=1e-3)
    # in fp32 each value moves twice the bytes
    cfg = cell_config("t1_imagenet_train")
    cfg["hardware"]["precision"] = "float32"
    assert math.isclose(costs.layernorm_bound_s(cfg), 2 * t1)


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
    """The parent's program runs torch's fp32 LayerNorm between two casts:
    no reading."""
    r = result([TORCH_LN, "void at::native::unrolled_elementwise_kernel<direct_copy_kernel>"],
               cell_config("t1_imagenet_train"))
    assert layernorm_device_ms.read(r) is None
    assert layernorm_roofline_pct.read(r) is None


def test_readings_from_the_kernels():
    cfg = cell_config("t1_dinov3_vit7b_imagenet_train")
    names = ["void (anonymous namespace)::basd_layernorm_cta_kernel<__nv_bfloat16, 4>(uint4 "
             "const*, float4 const*, float4 const*, uint4*, int, float, float)",
             "void (anonymous namespace)::basd_layernorm_warp_kernel<__nv_bfloat16, 4>(...)",
             TORCH_LN]
    r = result(names, cfg, steps=2)
    # two LayerNorm kernels of 100 us over 2 replays: 0.1 ms a step
    assert math.isclose(layernorm_device_ms.read(r), 0.1)
    assert math.isclose(layernorm_roofline_pct.read(r),
                        100.0 * costs.layernorm_bound_s(cfg) * 2 / 200e-6)


def test_pattern_finds_every_kernel_of_the_source_and_no_other():
    src = (harness.ROOT / "basd_tpu_torch" / "csrc" / "layernorm.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\(\w+(?: \* \w+)?\)\s+(\w+)\(", src)
    assert sorted(kernels) == ["basd_layernorm_cta_kernel", "basd_layernorm_scalar_kernel",
                               "basd_layernorm_warp_kernel"]
    for reader in (layernorm_device_ms, layernorm_roofline_pct):
        assert all(re.search(reader.KERNELS, k) for k in kernels)
        assert not re.search(reader.KERNELS, TORCH_LN)
    others = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(",
                        "".join(p.read_text() for p in
                                (harness.ROOT / "basd_tpu_torch" / "csrc").glob("*.cu")
                                if p.name != "layernorm.cu"))
    assert others and not [k for k in others if re.search(layernorm_device_ms.KERNELS, k)]


def test_manifest_entries():
    by_name = {m["name"]: m for m in MANIFEST["per_layer"]}
    assert [m["name"] for m in MANIFEST["per_layer"][-2:]] == ["layernorm_device_ms",
                                                              "layernorm_roofline_pct"]
    assert by_name["layernorm_device_ms"]["workloads"] == [w["name"] for w in
                                                           MANIFEST["workloads"]]
    # t3's 640 x 768 calls sit in L2 and are launch-bound
    assert by_name["layernorm_roofline_pct"]["workloads"] == [
        "t1_imagenet_train", "t1_vitg14_imagenet_train", "t1_dinov3_vit7b_imagenet_train"]
    for name, unit in (("layernorm_device_ms", "ms"), ("layernorm_roofline_pct", "%")):
        assert by_name[name]["unit"] == unit
        assert by_name[name]["layer"] == "teacher forward"
        assert by_name[name]["moves"] == "train_images_per_s"
        assert by_name[name]["source"] == "device_trace"
