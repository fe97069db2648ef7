"""The Table-2 semantics as a whole: three steps of the port's
`make_train_step` with a CNN teacher against the JAX package's, from the
same student and teacher weights, selector and batch, for
`augment=False` and `augment=True` (the augmentation draws of each port
step replayed from the JAX state's key).

A micro ConvNeXt-V2 teacher (`convnextv2_micro`, stride 32, GRN weights
moved off zero) gives ONE token layer of 2 x 2 = 4 tokens at 64 px with
uniform importance, against a `vit_micro_patch4` student's 256 tokens:
L = 1, so the mixing weights are (2, 1) and identically 1, and the token
aligner upsamples 4 -> 256 (N_s > D_s, the explicit alignment and the
feature-side Procrustes route, as Table-2's 196 student tokens at
D_s = 192 take). Batch 8, drop_path 0, fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.losses import extraction_points as jax_extraction_points
from basd_tpu.losses import init_selector as jax_init_selector
from basd_tpu.models import create_student as jax_create_student
from basd_tpu.models import load_teacher as jax_load_teacher
from basd_tpu.training.schedule_free import eval_params as jax_eval_params
from basd_tpu.training.train_step import make_train_step as jax_make_train_step
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.models.convert import (
    convnext_state_dict_from_jax,
    selector_state_from_numpy,
)
from basd_tpu_torch.ops.preprocess import dual_view_eval
from basd_tpu_torch.training import train_step as ttrain
from test_torch_helpers import CPU, assert_close, carry_vit, flax_params_np, jax_step_draws

torch.set_num_threads(1)

STEPS = 3
B, IMG, RAW, C = 8, 64, 80, 10
TEACHER_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
DATASET_STATS = ((0.507, 0.487, 0.441), (0.267, 0.256, 0.276))
STEP_KW = dict(
    learning_rate=1e-3, weight_decay=0.05, warmup_steps=5, label_smoothing=0.1,
    img_size=IMG, crop_ratio=IMG / RAW, teacher_stats=TEACHER_STATS,
    dataset_stats=DATASET_STATS, num_classes=C,
)


def _teacher_variables(jt):
    """The JAX teacher's variables with every GRN gamma/beta drawn nonzero
    (zero-initialized, GRN is the identity)."""
    rng = np.random.default_rng(5)

    def walk(tree, name=""):
        if hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        if name in ("gamma", "beta"):
            return (0.3 * rng.standard_normal(np.shape(tree))).astype(np.float32)
        return np.asarray(tree, np.float32)

    return walk(flax_params_np(jt.variables))


def _eval_views(images):
    return dual_view_eval(
        torch.from_numpy(images), img_size=IMG, crop_ratio=IMG / RAW,
        teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS)


@pytest.fixture(scope="module", params=[False, True], ids=["augment=False", "augment=True"])
def trajectories(request):
    augment = request.param
    rng = np.random.default_rng(99)
    images = (rng.random((B, RAW, RAW, 3)) * 255).astype(np.uint8)
    labels = rng.integers(0, C, B, dtype=np.int32)
    points = jax_extraction_points(4, 2)

    # ---- JAX package ----
    jt = jax_load_teacher("convnextv2_micro", img_size=IMG, dtype=jnp.float32)
    tvars = _teacher_variables(jt)
    js, jcfg = jax_create_student(
        "vit_micro_patch4", num_classes=C, drop_path_rate=0.0, img_size=IMG,
        capture_layers=points, dtype=jnp.float32, remat=False,
    )
    jsel = jax_init_selector(jax.random.PRNGKey(1), len(points),
                             jcfg.embed_dim, jt.spec.embed_dim)
    _, init_fn, step_fn = jax_make_train_step(js, jt, augment=augment, **STEP_KW)
    state = init_fn(jax.random.PRNGKey(0), jsel)
    student_params = state.params
    step = jax.jit(step_fn)
    draws, jout = [], {"loss": [], "temps": [], "ranks": [], "weights": []}
    for _ in range(STEPS):
        draws.append(jax_step_draws(state.rng, B))
        state, m = step(state, tvars, jnp.asarray(images), jnp.asarray(labels))
        jout["loss"].append(float(m["loss"]))
        jout["temps"].append(np.asarray(m["temperatures"]))
        jout["ranks"].append(np.asarray(m["mp_ranks"]))
        jout["weights"].append(np.asarray(m["mixing_weights"]))
    x = jax_eval_params(state.opt_state, {
        "student": state.params, "log_temperatures": state.selector.log_temperatures})
    _, s_imgs = _eval_views(images)
    jout["eval_logits"] = np.asarray(js.apply(
        {"params": x["student"]}, jnp.asarray(s_imgs.numpy()), train=False).logits)

    # ---- the port, same weights, selector, batch and draws ----
    tt = load_teacher("convnextv2_micro", img_size=IMG, dtype=torch.float32, device=CPU)
    tt.module.load_state_dict(convnext_state_dict_from_jax(tvars), strict=True)
    ts, _ = create_student(
        "vit_micro_patch4", num_classes=C, drop_path_rate=0.0, img_size=IMG,
        capture_layers=points, dtype=torch.float32, remat=False, device=CPU,
    )
    carry_vit(student_params, ts)
    tsel = selector_state_from_numpy(
        np.asarray(jsel.log_temperatures), np.asarray(jsel.proj_s),
        np.asarray(jsel.proj_t), device=CPU)
    tinit, tstep = ttrain.make_train_step(ts, tt, augment=augment, **STEP_KW)
    tstate = tinit(0, tsel)
    replay = iter(draws)
    mp = pytest.MonkeyPatch()
    mp.setattr(ttrain, "sample_step_draws", lambda generator, batch: next(replay))
    try:
        tout = {"loss": [], "temps": [], "ranks": [], "weights": []}
        for _ in range(STEPS):
            tstate, m = tstep(tstate, torch.from_numpy(images),
                              torch.from_numpy(labels.astype(np.int64)))
            tout["loss"].append(float(m["loss"]))
            tout["temps"].append(m["temperatures"].numpy())
            tout["ranks"].append(m["mp_ranks"].numpy())
            tout["weights"].append(m["mixing_weights"].numpy())
    finally:
        mp.undo()
    assert tstate.step == STEPS
    with torch.no_grad():
        for p, xp in zip(tstate.optimizer.param_groups[0]["params"],
                         tstate.optimizer.eval_params()):
            p.copy_(xp)
        tout["eval_logits"] = ts(s_imgs, train=False).logits.numpy()
    return jout, tout


def test_losses_match(trajectories):
    """Per-step loss within rtol 5e-4 (the JAX package's own tolerance for
    swapping its eigh backend, tests/test_parallel.py), and the step
    trains."""
    jout, tout = trajectories
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=5e-4)
    assert np.isfinite(tout["loss"]).all()


def test_mp_ranks_exactly_equal(trajectories):
    jout, tout = trajectories
    np.testing.assert_array_equal(np.stack(tout["ranks"]), np.stack(jout["ranks"]))
    assert np.stack(tout["ranks"]).shape == (STEPS, 1)


def test_temperatures_match(trajectories):
    """Temperatures as each step reports them: within 1e-5 absolute. With
    one teacher layer the mixing weights are identically 1, so the
    log-temperatures get no gradient and stay where they started, in both
    packages."""
    jout, tout = trajectories
    np.testing.assert_allclose(np.stack(tout["temps"]), np.stack(jout["temps"]),
                               atol=1e-5)
    np.testing.assert_allclose(np.stack(tout["temps"]), 1.0, atol=1e-6)
    assert np.stack(tout["weights"]).shape == (STEPS, 2, 1)
    np.testing.assert_array_equal(np.stack(tout["weights"]), 1.0)


def test_eval_point_logits_match(trajectories):
    """Logits at the ScheduleFree evaluation point x after three steps:
    within 1e-3 of scale, and the same predicted classes."""
    jout, tout = trajectories
    assert_close(tout["eval_logits"], jout["eval_logits"], 1e-3, "eval logits")
    np.testing.assert_array_equal(tout["eval_logits"].argmax(-1),
                                  jout["eval_logits"].argmax(-1))
