"""The RoPE family (`basd_vit_rope`, DINOv3's ViT-7B teacher): the stage and
the reference hold the same teacher leaves, cut by one rule from one seeded
draw, at the configuration's full teacher width and at the wiring check's,
and the stage keeps no view of the draw; the port's first steps against
the reference in float32 at the wiring check's size, close, and far off
with RoPE left out, the registers left in the tokens or eps 1e-6; the
reference's host-held mix against plain autograd; its FLOP count against
`torch.utils.flop_counter`; the RoPE bound by hand at the cell's shape."""

from __future__ import annotations

import importlib
import json
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, judge, rope_weights, swiglu_weights
from benchmark.costs import basd_vit_rope as costs, h100
from benchmark.reference import basd_vit_rope as ref
from benchmark.stage import basd_vit_rope as stage
from benchmark.weights import make_weights

FAMILY = "basd_vit_rope"
SEED = 3000000043
CPU = torch.device("cpu")


def family_config() -> dict:
    """The family's one configuration, at its full size."""
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    configs = [harness.load_json("configs", c["name"] + ".json") for c in manifest["configs"]]
    return next(c for c in configs if c["family"] == FAMILY)


def cell_name() -> str:
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    names = {c["name"] for c in manifest["configs"]
             if harness.load_json("configs", c["name"] + ".json")["family"] == FAMILY}
    return next(w["name"] for w in manifest["workloads"] if w["config"] in names)


def full_width_config() -> dict:
    """The wiring check's student and data around the configuration's
    teacher at its published widths, one block deep, at 32 px (4 patches
    and CLS: the drawn table has the 4 rows the registers take)."""
    full = family_config()
    cfg = harness.smoke_config(full)
    cfg["teacher"] = dict(full["teacher"], depth=1)
    cfg["student"].update(img_size=32)
    cfg["data"].update(raw_size=36, crop_ratio=0.875, batch_size=2)
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

    monkeypatch.setattr(ref, "rope_teacher_forward", capture)
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
    assert set(staged) == set(seen) and "pos_embed" not in staged
    for name in staged:
        assert torch.equal(staged[name], seen[name]), name
    d = t["embed_dim"]
    h, g = swiglu_weights.packed_width(d, t["mlp_ratio"])
    assert (h, g) == ((16384, 8192) if width == "full" else (256, 128))
    assert tuple(staged["blocks.0.mlp.fc1.weight"].shape) == (2 * g, d)
    assert tuple(staged["blocks.0.mlp.fc2.weight"].shape) == (d, g)
    # the registers: the drawn table's first 4 rows
    drawn = make_weights({**t, "img_size": cfg["student"]["img_size"], "num_classes": 0},
                         harness.derive_seeds(SEED)["teacher"], CPU)
    assert torch.equal(staged["register_tokens"], drawn["pos_embed"][:, :4])
    assert torch.equal(staged["blocks.0.mlp.fc1.weight"], drawn["blocks.0.mlp.fc1.weight"])
    assert torch.equal(staged["blocks.0.mlp.fc2.weight"],
                       drawn["blocks.0.mlp.fc2.weight"][:, :g] * math.sqrt(2.0))
    assert not bool(staged["blocks.0.attn.qkv.bias"].any())


def test_stage_keeps_no_view_of_the_draw():
    """Every staged teacher leaf owns its storage, so the draw's one buffer
    is let go before the first step."""
    cfg = harness.smoke_config(family_config())
    leaves = stage.teacher_weights(cfg["teacher"], cfg["student"]["img_size"], 7, CPU)
    for name, w in leaves.items():
        assert w._base is None, name
        assert w.untyped_storage().nbytes() == w.numel() * w.element_size(), name
    drawn = make_weights({**cfg["teacher"], "img_size": cfg["student"]["img_size"],
                          "num_classes": 0}, 7, CPU)
    cut = rope_weights.cut(drawn, cfg["teacher"])
    assert set(cut) == set(leaves)
    assert all(torch.equal(cut[n], leaves[n]) for n in cut)


def test_cut_refuses_a_table_shorter_than_the_registers():
    cfg = harness.smoke_config(family_config())
    t = dict(cfg["teacher"], num_register_tokens=18)
    drawn = make_weights({**t, "img_size": 16, "num_classes": 0}, 0, CPU)
    with pytest.raises(ValueError, match="18 register tokens"):
        rope_weights.cut(drawn, t)


FAULTS = ("none", "no_rope", "registers_kept", "eps_1e-6")


def first_steps_fp32(fault: str, monkeypatch) -> dict | None:
    """`judge.numbers` of the port's first steps against the reference's,
    both in float32, at the wiring check's size, with `fault` planted in
    the port (None where the fault stops the step)."""
    from basd_tpu_torch.models import vit

    if fault == "no_rope":
        orig = vit.VisionTransformer.rope_table

        def flat(self, device):
            t = orig(self, device)
            return None if t is None else torch.stack([torch.ones_like(t[0]),
                                                       torch.zeros_like(t[1])])
        monkeypatch.setattr(vit.VisionTransformer, "rope_table", flat)
    elif fault == "registers_kept":
        monkeypatch.setattr(vit.ViTConfig, "num_prefix",
                            property(lambda self: int(self.has_cls_token)))
    elif fault == "eps_1e-6":
        spec = stage.teacher_spec
        monkeypatch.setattr(stage, "teacher_spec", lambda t: spec({**t, "ln_eps": 1e-6}))
    cell = harness.cell_spec(cell_name())
    cfg = harness.smoke_config(cell.config)
    cfg["hardware"]["precision"] = "float32"
    seeds = harness.derive_seeds(SEED)
    program = importlib.import_module(f"benchmark.stage.{cfg['family']}")
    try:
        _, feed, first = harness.first_steps(program, cfg, {**cell.traffic, "warm_seconds": 0},
                                             seeds, CPU)
    except RuntimeError:
        if fault == "none":
            raise
        return None
    return judge.numbers(first, judge.reference_run(cfg, seeds, feed.kept, CPU))


@pytest.mark.parametrize("fault", FAULTS)
def test_port_first_steps_fp32_against_the_reference(fault, monkeypatch):
    """In float32 the port's three steps agree with the reference's: the
    loss within 1e-5 and the Procrustes loss within 1e-4 (read: 1.7e-7 and
    5.7e-6; the selector's iterations differ in order), the ranks equal.
    With RoPE left out, the registers left in the tokens or eps 1e-6 in the
    port's teacher the Procrustes loss is off by 9e-3 and more, or the step
    stops."""
    got = first_steps_fp32(fault, monkeypatch)
    if fault == "none":
        assert got["loss_rel"] <= 1e-5 and got["geo_rel"] <= 1e-4, got
        assert got["rank_gap"] == 0, got
    else:
        assert got is None or got["geo_rel"] > 1e-3, got


def test_host_mix_against_autograd():
    """`HostMix` (layers streamed from host memory) against weights @ stack
    with plain autograd: the output and the weights' gradient."""
    g = torch.Generator().manual_seed(0)
    stack = torch.randn((5, 3, 4, 6), generator=g)
    w = torch.softmax(torch.randn((2, 5), generator=g), -1).requires_grad_(True)
    w2 = w.detach().clone().requires_grad_(True)
    out = ref.HostMix.apply(w, stack)
    want = (w2 @ stack.reshape(5, -1)).reshape(2, 3, 4, 6)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    up = torch.randn(out.shape, generator=g)
    (out * up).sum().backward()
    (want * up).sum().backward()
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-5, atol=1e-6)


def counted(fn) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


def test_rope_teacher_forward_flops():
    """The RoPE teacher's products on the family's reference: the blocks
    over CLS, registers and patches, and the selector's projection of each
    layer's patch tokens (the selector's teacher term)."""
    t = dict(img_size=16, patch_size=4, embed_dim=32, depth=2, num_heads=2, mlp_ratio=4.0,
             layer_scale_init=1e-5, num_classes=0, num_register_tokens=4)
    w = rope_weights.cut(make_weights(t, 0, CPU), t)
    x = torch.rand(3, 16, 16, 3)
    proj = torch.randn(8, 32)
    got = counted(lambda: ref.rope_teacher_forward(w, x, patch_size=4, depth=2, heads=2,
                                                   eps=1e-5, proj_t=proj))
    assert got == costs.rope_forward_flops(3, 16, 4, 32, 2, 4.0, 4) + 2 * 2 * 3 * 16 * 32 * 8


def test_rope_bound_by_hand_at_the_cells_shape():
    """40 calls over 256 x 201 rows (196 patches, CLS, 4 registers), D 4096,
    bf16: q and k read and written, 8 B N D bytes a call over 3.35 TB/s."""
    cfg = family_config()
    assert costs.rope_calls(cfg) == [(256, 201, 4096)] * 40
    by_hand = 40 * 8 * 256 * 201 * 4096 / 3.35e12
    assert math.isclose(costs.rope_bound_s(cfg), by_hand)
    assert math.isclose(by_hand * 1e3, 20.13, rel_tol=1e-3)
    assert h100.HBM_BYTES_PER_S == 3.35e12
    assert costs.attention_calls(cfg, backward=False).count((256, 201, 32, 128, False)) == 40
    # the teacher's forward: about 2 x 6.7e9 parameters x 201 tokens x 256 images
    teacher = costs.rope_forward_flops(256, 224, 16, 4096, 40, 4.0, 4)
    assert 690e12 < teacher < 700e12


def test_gate_bound_by_hand_at_the_cells_shape():
    """40 gate calls over 256 x 201 rows at g = 8192 (half of fc1's 16,384),
    bf16: a and b read and the product written, 3 M g 2 B a call over
    3.35 TB/s."""
    cfg = family_config()
    assert costs.swiglu_gate_calls(cfg) == [(256 * 201, 8192)] * 40
    by_hand = 40 * 3 * 256 * 201 * 8192 * 2 / 3.35e12
    assert math.isclose(costs.swiglu_gate_bound_s(cfg), by_hand)
    assert math.isclose(by_hand * 1e3, 30.20, rel_tol=1e-3)


def test_manifest_entries():
    """The cell is on the accepted per-layer metrics whose readers find
    something in it, and on no metric of a kernel it does not run."""
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = "t1_dinov3_vit7b_imagenet_train"
    on = {m["name"] for m in manifest["per_layer"] if cell in m.get("workloads", [cell])}
    assert on == {"device_idle_pct", "step_mfu_pct", "kernels_per_step", "augment_device_ms",
                  "teacher_device_ms", "student_device_ms", "loss_device_ms",
                  "optimizer_device_ms", "attn_fwd_roofline_pct", "attn_bwd_roofline_pct",
                  "swiglu_gate_device_ms", "swiglu_gate_roofline_pct", "gelu_device_ms",
                  "rope_device_ms", "rope_roofline_pct"}
