"""The SwiGLU family (`basd_vit_swiglu`): the stage and the reference hold
the same teacher leaves, cut by one rule from one seeded draw, at the
configuration's full teacher width and at the wiring check's; its FLOP
count against `torch.utils.flop_counter` on the family's reference; the
gate's bound by hand at the cell's shape."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, judge, swiglu_weights
from benchmark.costs import basd_vit, basd_vit_swiglu as costs, h100
from benchmark.reference import basd_vit_swiglu as ref
from benchmark.stage import basd_vit_swiglu as stage
from benchmark.weights import make_weights

FAMILY = "basd_vit_swiglu"
SEED = 3000000041
CPU = torch.device("cpu")


def family_config() -> dict:
    """The family's one configuration, at its full size."""
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    configs = [harness.load_json("configs", c["name"] + ".json") for c in manifest["configs"]]
    return next(c for c in configs if c["family"] == FAMILY)


def full_width_config() -> dict:
    """The wiring check's student and data around the configuration's
    teacher at its published widths, one block deep, at 28 px."""
    full = family_config()
    cfg = harness.smoke_config(full)
    cfg["teacher"] = dict(full["teacher"], depth=1)
    cfg["student"].update(img_size=28)
    cfg["data"].update(raw_size=32, crop_ratio=0.875)
    return cfg


class _Stop(Exception):
    pass


def both_sides(cfg: dict, monkeypatch) -> tuple[dict, dict]:
    """(the staged teacher's leaves, the leaves the reference's teacher
    forward is given), from one run's seeds."""
    seeds = harness.derive_seeds(SEED)
    prog = stage.Program(cfg, seeds, CPU)
    staged = {n: p.detach() for n, p in prog.teacher.module.state_dict().items()}
    seen = {}

    def capture(p, images, **kw):
        seen.update(p)
        raise _Stop

    monkeypatch.setattr(ref, "swiglu_teacher_forward", capture)
    rng = np.random.default_rng(0)
    raw, b = cfg["data"]["raw_size"], cfg["data"]["batch_size"]
    batch = (rng.integers(0, 256, (b, raw, raw, 3), dtype=np.uint8),
             rng.integers(0, cfg["student"]["num_classes"], b, dtype=np.int64))
    with pytest.raises(_Stop):
        judge.reference_run(cfg, seeds, [batch], CPU)
    return staged, seen


@pytest.mark.parametrize("width", ["full", "smoke"])
def test_stage_and_reference_hold_the_same_teacher_leaves(width, monkeypatch):
    cfg = full_width_config() if width == "full" else harness.smoke_config(family_config())
    t = cfg["teacher"]
    staged, seen = both_sides(cfg, monkeypatch)
    assert set(staged) == set(seen)
    for name in staged:
        assert torch.equal(staged[name], seen[name]), name
    d = t["embed_dim"]
    h, g = swiglu_weights.packed_width(d, t["mlp_ratio"])
    assert (h, g) == ((8192, 4096) if width == "full" else (341, 170))
    assert tuple(staged["blocks.0.mlp.fc1.weight"].shape) == (2 * g, d)
    assert tuple(staged["blocks.0.mlp.fc2.weight"].shape) == (d, g)
    # the cut from the ViT draw: fc1's first 2g rows as drawn, fc2's first
    # g columns times sqrt(h / g)
    drawn = make_weights({**t, "img_size": cfg["student"]["img_size"], "num_classes": 0},
                         harness.derive_seeds(SEED)["teacher"], CPU)
    assert torch.equal(staged["blocks.0.mlp.fc1.weight"], drawn["blocks.0.mlp.fc1.weight"][:2 * g])
    assert torch.equal(staged["blocks.0.mlp.fc2.weight"],
                       drawn["blocks.0.mlp.fc2.weight"][:, :g] * math.sqrt(h / g))
    if width == "full":
        # N(0, 2 / g): the fan-in scale of every other kernel
        std = float(staged["blocks.0.mlp.fc2.weight"].std())
        assert abs(std / math.sqrt(2.0 / g) - 1.0) < 0.01


def counted(fn) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


@pytest.mark.parametrize("mlp_ratio", [5.3125, 5.33334])
def test_swiglu_teacher_forward_flops(mlp_ratio):
    """The SwiGLU teacher's products on the family's reference (packed
    widths 170 and 170, g 85, at D 32; the gate itself is elementwise)."""
    m = dict(img_size=16, patch_size=4, embed_dim=32, depth=2, num_heads=2,
             mlp_ratio=mlp_ratio, layer_scale_init=1e-5, num_classes=0)
    w = swiglu_weights.cut(make_weights(m, 0, CPU), 32, mlp_ratio)
    x = torch.rand(3, 16, 16, 3)
    got = counted(lambda: ref.swiglu_teacher_forward(w, x, patch_size=4, depth=2, heads=2))
    assert got == costs.swiglu_forward_flops(3, 16, 4, 32, 2, mlp_ratio)


def test_step_flops_differ_from_the_gelu_family_by_the_teacher_mlp_alone():
    """The student's and the selector's terms are `basd_vit`'s (held by
    tests/test_harness_costs.py); the teacher's MLP is the SwiGLU's:
    2 D 2g + 2 g D a token where the GELU's is 4 D h."""
    cfg = family_config()
    t, b = cfg["teacher"], cfg["data"]["batch_size"]
    tokens = b * ((cfg["student"]["img_size"] // t["patch_size"]) ** 2 + 1)
    d, h = t["embed_dim"], int(t["embed_dim"] * t["mlp_ratio"])
    g = h // 2
    gap = basd_vit.step_flops(cfg) - costs.step_flops(cfg)
    assert gap == t["depth"] * tokens * (4 * d * h - (2 * d * 2 * g + 2 * g * d))
    # the ViT-g teacher: about 2 x 1.13e9 parameters x 257 tokens x 256 images
    teacher = costs.swiglu_forward_flops(b, 224, 14, d, t["depth"], t["mlp_ratio"])
    assert 150e12 < teacher < 156e12


def test_gate_bound_by_hand_at_the_cells_shape():
    """40 calls over 256 x 257 rows, g = 4096, bf16: a and b read, the
    product written, 3 M g 2 bytes a call over 3.35 TB/s."""
    cfg = family_config()
    assert costs.swiglu_gate_calls(cfg) == [(65792, 4096)] * 40
    by_hand = 40 * 3 * 65792 * 4096 * 2 / 3.35e12
    assert math.isclose(costs.swiglu_gate_bound_s(cfg), by_hand)
    assert math.isclose(by_hand * 1e3, 19.306, rel_tol=1e-4)
    assert h100.HBM_BYTES_PER_S == 3.35e12
    assert costs.attention_calls(cfg, backward=False).count((256, 257, 24, 64, False)) == 40
