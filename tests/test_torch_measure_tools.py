"""The port's measurement tools (`basd_tpu_torch.tools.profile_step` and
the six probes) on the CPU at the JAX probes' smoke sizes (their
`BASD_PROBE_SMOKE` shapes, passed as arguments): each prints every stage
line of its JAX counterpart, read from the JAX tool's own `print` calls,
in the JAX tool's order; no time is measured on the CPU ("not measured");
without CUDA the default device raises."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from basd_tpu_torch.losses import selector as selector_mod
from basd_tpu_torch.tools import (
    probe_dualview,
    probe_loss_tail,
    probe_ns_precision,
    probe_selector_internals,
    probe_step_gap,
    probe_student_bwd,
    probe_teacher_block,
    profile_step,
)

torch.set_num_threads(1)

JAX_TOOLS = Path(__file__).resolve().parents[1] / "tools"


def jax_stage_names(tool: str) -> list[str]:
    """The stage names that the JAX tool prints, in order: the text of each
    `print(f"<name>:` up to its colon (lines that start with a value, such
    as `[{label}]`, are named in the tests)."""
    src = (JAX_TOOLS / f"{tool}.py").read_text()
    return [m.strip() for m in re.findall(r'print\(\s*f"\s*([A-Za-z_][^"{:]*?)\s*:', src)]


def assert_stages_in_order(text: str, names: list[str]) -> None:
    pos = 0
    for name in names:
        found = text.find(name, pos)
        assert found >= 0, f"{name!r} missing after position {pos}:\n{text}"
        pos = found + len(name)


def _hold_selector_ranks(monkeypatch, k: int) -> None:
    """MP ranks fixed at k: the sequential Householder of the rank takes
    seconds a step on the CPU at D_s = 384 and is held against the JAX
    package in tests/test_torch_spectral.py."""
    monkeypatch.setattr(selector_mod, "marchenko_pastur_rank_gram",
                        lambda g, m: torch.full(g.shape[:1], k, device=g.device))


# the JAX test's arms of tools/profile_step.py (tests/test_probe_smoke.py)
PROFILE_ARMS = {
    "table3": ["--batch", "4", "--n", "1"],
    "imagenet": ["--imagenet", "--img", "112", "--batch", "2", "--n", "1",
                 "--only", "dual_view"],
    "cross_arch": ["--cross-arch", "--img", "128", "--batch", "2", "--n", "1",
                   "--only", "dual_view"],
}


@pytest.mark.parametrize("arm", sorted(PROFILE_ARMS))
def test_profile_step_prints_the_jax_stages(arm, capsys):
    """Table-3 at batch 4 runs every stage; the 224 px arms stage their
    models at a smaller image and run `dual_view` alone, as the JAX test."""
    out = profile_step.main(PROFILE_ARMS[arm], device="cpu")
    text = capsys.readouterr().out
    names = jax_stage_names("profile_step")
    assert names[:2] == ["teacher init", "student init"] and len(names) == 9
    if arm == "table3":
        assert_stages_in_order(text, names)
        assert list(out) == ["dual_view", "mixup_cutmix", "teacher forward", "student fwd",
                             "student fwd+bwd (CE)", "selector fwd", "full loss fwd+bwd"]
    else:
        assert_stages_in_order(text, names[:3])
        assert list(out) == ["dual_view"]
    assert all(ms is None for ms in out.values())
    assert "not measured (cpu)" in text


def test_probe_selector_internals_prints_the_jax_components(capsys):
    out = probe_selector_internals.main([], device="cpu", **probe_selector_internals.SMOKE)
    text = capsys.readouterr().out
    names = jax_stage_names("probe_selector_internals")
    assert names == ["proj_t", "ranks", "topk_t", "topk_s", "topk_s iter fwd",
                     "topk_s iter f+b", "topk_s eigh fwd", "topk_s eigh f+b",
                     "angles", "angles_g", "select"]
    assert_stages_in_order(text, names)
    assert text.count("eigh route ") == 3
    assert [r for _, r in out["routes"].values()] == ["torch.linalg.eigh"] * 3


def test_probe_selector_internals_takes_the_models_tokens(capsys):
    """`--model-tokens`: the ViT-B/14 teacher's 12 layers of 768 and the
    ViT-S/16 student's 4 points of 384 on bench's eval view set the shapes
    (28 px, batch 2: 4 teacher tokens and 1 student token a sample)."""
    out = probe_selector_internals.main(["--model-tokens"], device="cpu", img_size=28,
                                        b=2, k=8)
    text = capsys.readouterr().out
    assert "shapes: L=12 B=2 N_t=4 D_t=768 P=4 N_s=1 D_s=384 K=8; the models tokens" in text
    assert_stages_in_order(text, jax_stage_names("probe_selector_internals"))
    assert out["routes"]["principal angles"][0] == (4, 12, 2, 2)  # K capped at B N_s


def test_probe_selector_internals_names_the_eigh_route_of_each_arm():
    """The selector's eighs at the arms' K: Table-3's K = 48 on K3's
    pingpong route, the ViT-L/14 teacher's K = 192 on cuSOLVER; K3's
    packed_log route is never the selector's (its gate ends at 96)."""
    route = probe_selector_internals.eigh_route_name
    assert route((12, 48, 48)) == route((4, 12, 48, 48)) == "K3 pingpong"
    assert route((4, 47, 47)) == "K3 pingpong"  # odd n is padded
    assert route((24, 192, 192)) == route((4, 24, 192, 192)) == "torch.linalg.eigh"
    assert route((1, 48, 48)) == "torch.linalg.eigh"  # a batch under 4
    args = probe_selector_internals.parse_args(["--teacher", "dinov2_vitl14"])
    assert args.teacher == "dinov2_vitl14"
    with pytest.raises(SystemExit):
        probe_selector_internals.parse_args(["--teacher", "convnextv2_tiny"])


def test_probe_loss_tail_prints_the_jax_stages(capsys):
    """The JAX probe's `adamw update` is the train step's ScheduleFree
    AdamW here."""
    out = probe_loss_tail.main([], device="cpu", **probe_loss_tail.SMOKE)
    text = capsys.readouterr().out
    names = jax_stage_names("probe_loss_tail")
    assert names == ["selector fwd", "basd_loss fwd", "basd_loss fwd+bwd", "adamw update"]
    assert_stages_in_order(text, names)
    assert "teacher tokens (12, 4, 16, 768)" in text  # the teacher's depth
    assert list(out) == ["selector fwd", "basd_loss fwd", "basd_loss fwd+bwd",
                         "schedule-free adamw update"]


def test_probe_step_gap_prints_each_variant_and_the_deltas(monkeypatch, capsys):
    """Smoke shapes, one warm-up step, K = 16 and MP ranks held at it (the
    CPU's Householder at D_s = 384); the four variants' lines, in the JAX
    probe's order, and its four in-context lines, which the port prints on
    every run."""
    monkeypatch.setattr(probe_step_gap, "calibrate_subspace_k", lambda *a, **k: 16)
    _hold_selector_ranks(monkeypatch, 16)
    out = probe_step_gap.main([], device="cpu", warmup=1, **probe_step_gap.SMOKE)
    text = capsys.readouterr().out
    assert list(out) == ["ce_only", "ce_teacher", "ce_sel", "full"]
    assert_stages_in_order(text, [f"[{v}]" for v in out])
    names = jax_stage_names("probe_step_gap")
    assert names == ["in-context teacher fwd", "in-context selector f+b",
                     "in-context procrustes", "ce_only residual"]
    assert_stages_in_order(text, names)
    assert all(np.isfinite(ms) and ms > 0 for ms in out.values())


def test_ablated_steps_differ_from_the_step_only_in_the_loss(monkeypatch):
    """From one seed, state and batch, ce_only and ce_sel read the same CE
    (the same draws, views, mixup and student forward), and ce_sel's
    backward through the selector, with zero cotangents, leaves the
    student the CE gradients of ce_only (within 1e-6) and the
    log-temperatures a zero gradient."""
    from basd_tpu_torch.losses import extraction_points, init_selector
    from basd_tpu_torch.models import create_student, load_teacher
    from basd_tpu_torch.training.train_step import make_train_step

    cpu = torch.device("cpu")
    teacher = load_teacher("vit_mini_patch4", img_size=16, dtype=torch.float32, device=cpu)
    points = extraction_points(4, 2)
    rng = np.random.default_rng(0)
    images = torch.from_numpy((rng.random((4, 20, 20, 3)) * 255).astype(np.uint8))
    labels = torch.from_numpy(rng.integers(0, 5, 4))
    views = dict(img_size=16, crop_ratio=0.8, teacher_stats=probe_step_gap.TEACHER_STATS,
                 dataset_stats=probe_step_gap.DATASET_STATS)
    grads = {}
    for variant, kw in (("ce_only", dict(with_teacher=False)),
                        ("ce_sel", dict(with_teacher=True, with_selector=True))):
        student, cfg = create_student(
            "vit_micro_patch4", num_classes=5, drop_path_rate=0.0, img_size=16,
            arch_overrides={"depth": 4}, capture_layers=points, dtype=torch.float32,
            device=cpu)
        sel = init_selector(1, len(points), cfg.embed_dim, teacher.spec.embed_dim, device=cpu)
        init_fn, _ = make_train_step(student, teacher, **probe_step_gap.HPARAMS,
                                     label_smoothing=0.0, num_classes=5, subspace_k=8, **views)
        state = init_fn(0, sel)
        step = probe_step_gap.ablated_step(teacher, 5, views, 8, **kw)
        monkeypatch.setattr(state.optimizer, "step", lambda: None)  # keep the gradients
        _, metrics = step(state, images, labels)
        grads[variant] = ([p.grad.clone() for p in student.parameters()],
                          sel.log_temperatures.grad.clone(), float(metrics["loss"]))
    (g0, t0, l0), (g1, t1, l1) = grads["ce_only"], grads["ce_sel"]
    assert l0 == l1 and torch.equal(t0, torch.zeros_like(t0)) and torch.equal(t0, t1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_probe_teacher_block_prints_the_jax_pieces(capsys):
    """The block's pieces, and with `--gelu` the activation variants (the
    JAX probe's `gelu_variants`)."""
    out = probe_teacher_block.main([], device="cpu", **probe_teacher_block.SMOKE)
    gelu = probe_teacher_block.main(["--gelu"], device="cpu", **probe_teacher_block.SMOKE)
    text = capsys.readouterr().out
    names = jax_stage_names("probe_teacher_block")
    assert names[0] == "full block" and names[-1] == "fc1+bf16-erf+fc2" and len(names) == 12
    assert_stages_in_order(text, names)
    assert len(out) == 7 and len(gelu) == 5


def test_probe_student_bwd_prints_the_jax_pieces(capsys):
    """The pieces, and the patchify contraction within bf16 rounding of the
    convolution (1.6e-2 in the JAX probe; here 2^-7 of values near 1)."""
    out = probe_student_bwd.main([], device="cpu", **probe_student_bwd.SMOKE)
    text = capsys.readouterr().out
    names = jax_stage_names("probe_student_bwd")
    assert names == ["patch_embed fwd", "patch_embed f+b", "patch_embed wgrad",
                     "patchify parity", "patchify fwd", "patchify wgrad", "block fwd",
                     "block f+b"]
    assert_stages_in_order(text, [*names, "attn_half f+b", "mlp_half f+b",
                                  "student f+b base"])
    assert 0 <= out["patchify parity"] <= 2e-2


def test_probe_dualview_prints_the_jax_stages(capsys):
    out = probe_dualview.main([], device="cpu", **probe_dualview.SMOKE)
    text = capsys.readouterr().out
    names = jax_stage_names("probe_dualview")
    assert names == ["dual_view (all)", "clean view only", "rrc", "hflip", "trivial_augment",
                     "equalize", "eq masked", "geo warp", "normalize"]
    assert_stages_in_order(text, names)
    assert list(out) == names


def test_probe_ns_precision_against_float64(capsys):
    """The JAX probe's inputs draw for draw; at the smoke size both
    precisions (the same on the CPU, which has no TF32) are within 1e-3 of
    the float64 SVD (the JAX probe's HIGHEST reads about 1e-4 at full size)
    with finite gradients, and TF32 is off again after the probe."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("probe_ns_precision_jax",
                                                  JAX_TOOLS / "probe_ns_precision.py")
    jax_probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_probe)
    for want, got in zip(jax_probe.make_inputs(3, 5, 4, 6, 1e6, 0),
                         probe_ns_precision.make_inputs(3, 5, 4, 6, 1e6, 0)):
        np.testing.assert_array_equal(got, want)
    before = torch.backends.cuda.matmul.allow_tf32
    out = probe_ns_precision.main([], device="cpu", **probe_ns_precision.SMOKE)
    assert torch.backends.cuda.matmul.allow_tf32 == before
    text = capsys.readouterr().out
    assert text.count("value relerr max") == 2 and "not measured (cpu)" in text
    for name in ("fp32", "tf32"):
        assert out[name]["relerr_max"] < 1e-3 and out[name]["grads_finite"]


TOOLS = (profile_step, probe_selector_internals, probe_loss_tail, probe_step_gap,
         probe_teacher_block, probe_student_bwd, probe_dualview, probe_ns_precision)


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tools_run_on_the_card_by_default(tool, monkeypatch):
    """Without CUDA the default device raises before any staging."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
