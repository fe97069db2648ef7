"""The slice as a whole: three steps of the port's
`make_train_step(augment=False)` against the JAX package's, from the same
student and teacher weights, selector and batch (the setting of
tests/test_full_step_parity.py: vit_micro student, vit_mini teacher,
16 px, batch 8, drop_path 0, fp32 on the CPU).

The port runs its plain versions here: the teacher (6, 63, 63)
Rayleigh-Ritz and the (12, 63, 63) principal-angle eighs take the plain
Jacobi, the student's (2, 63, 63) one `torch.linalg.eigh`; the JAX package
runs LAPACK for all three on the CPU."""

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
from basd_tpu_torch.losses import extraction_points
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.models.convert import selector_state_from_numpy
from basd_tpu_torch.ops.preprocess import dual_view_eval
from basd_tpu_torch.training.train_step import make_train_step
from test_torch_helpers import CPU, assert_close, carry_vit

torch.set_num_threads(1)

STEPS = 3
LR, WD, WARMUP, SMOOTH = 1e-3, 0.05, 5, 0.1
B, IMG, RAW, C = 8, 16, 20, 10
TEACHER_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
DATASET_STATS = ((0.507, 0.487, 0.441), (0.267, 0.256, 0.276))
STEP_KW = dict(
    learning_rate=LR, weight_decay=WD, warmup_steps=WARMUP,
    label_smoothing=SMOOTH, img_size=IMG, crop_ratio=IMG / RAW,
    teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS, num_classes=C,
    augment=False,
)


@pytest.fixture(scope="module")
def trajectories():
    rng = np.random.default_rng(42)
    images = (rng.random((B, RAW, RAW, 3)) * 255).astype(np.uint8)
    labels = rng.integers(0, C, B, dtype=np.int32)
    points = jax_extraction_points(4, 2)
    assert extraction_points(4, 2) == points

    # ---- JAX package ----
    jt = jax_load_teacher("vit_mini_patch4", img_size=IMG, dtype=jnp.float32)
    js, jcfg = jax_create_student(
        "vit_micro_patch4", num_classes=C, drop_path_rate=0.0, img_size=IMG,
        capture_layers=points, dtype=jnp.float32, remat=False,
    )
    jsel = jax_init_selector(jax.random.PRNGKey(1), len(points),
                             jcfg.embed_dim, jt.spec.embed_dim)
    _, init_fn, step_fn = jax_make_train_step(js, jt, **STEP_KW)
    state = init_fn(jax.random.PRNGKey(0), jsel)
    student_params = state.params
    step = jax.jit(step_fn)
    jout = {"loss": [], "temps": [], "ranks": []}
    for _ in range(STEPS):
        state, m = step(state, jt.variables, jnp.asarray(images), jnp.asarray(labels))
        jout["loss"].append(float(m["loss"]))
        jout["temps"].append(np.asarray(m["temperatures"]))
        jout["ranks"].append(np.asarray(m["mp_ranks"]))
    x = jax_eval_params(state.opt_state, {
        "student": state.params, "log_temperatures": state.selector.log_temperatures})
    _, s_imgs = dual_view_eval_np(images)
    jout["eval_logits"] = np.asarray(
        js.apply({"params": x["student"]}, jnp.asarray(s_imgs), train=False).logits)

    # ---- the port, same weights, selector and batch ----
    tt = load_teacher("vit_mini_patch4", img_size=IMG, dtype=torch.float32, device=CPU)
    carry_vit(jt.variables["params"], tt.module)
    ts, _ = create_student(
        "vit_micro_patch4", num_classes=C, drop_path_rate=0.0, img_size=IMG,
        capture_layers=points, dtype=torch.float32, device=CPU,
    )
    carry_vit(student_params, ts)
    tsel = selector_state_from_numpy(
        np.asarray(jsel.log_temperatures), np.asarray(jsel.proj_s),
        np.asarray(jsel.proj_t), device=CPU)
    tinit, tstep = make_train_step(ts, tt, **STEP_KW)
    tstate = tinit(0, tsel)
    tout = {"loss": [], "temps": [], "ranks": []}
    for _ in range(STEPS):
        tstate, m = tstep(tstate, torch.from_numpy(images),
                          torch.from_numpy(labels.astype(np.int64)))
        tout["loss"].append(float(m["loss"]))
        tout["temps"].append(m["temperatures"].numpy())
        tout["ranks"].append(m["mp_ranks"].numpy())
    assert tstate.step == STEPS
    with torch.no_grad():
        for p, xp in zip(tstate.optimizer.param_groups[0]["params"],
                         tstate.optimizer.eval_params()):
            p.copy_(xp)
        _, t_imgs = dual_view_eval(
            torch.from_numpy(images), img_size=IMG, crop_ratio=IMG / RAW,
            teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS)
        tout["eval_logits"] = ts(t_imgs, train=False).logits.numpy()
    np.testing.assert_allclose(t_imgs.numpy(), s_imgs, atol=1e-6)
    return jout, tout


def dual_view_eval_np(images):
    from basd_tpu.ops.preprocess import dual_view_eval as jax_dual_view_eval

    out = jax_dual_view_eval(
        jnp.asarray(images), img_size=IMG, crop_ratio=IMG / RAW,
        teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS)
    return tuple(np.asarray(v) for v in out)


def test_losses_match(trajectories):
    """Per-step loss within rtol 5e-4 (the JAX package's own tolerance for
    swapping its eigh backend, tests/test_parallel.py)."""
    jout, tout = trajectories
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=5e-4)
    assert jout["loss"][-1] < jout["loss"][0]  # the step actually trains


def test_mp_ranks_exactly_equal(trajectories):
    jout, tout = trajectories
    np.testing.assert_array_equal(np.stack(tout["ranks"]), np.stack(jout["ranks"]))


def test_temperatures_match(trajectories):
    """Temperatures as each step reports them: within 1e-5 absolute."""
    jout, tout = trajectories
    np.testing.assert_allclose(np.stack(tout["temps"]), np.stack(jout["temps"]),
                               atol=1e-5)


def test_eval_point_logits_match(trajectories):
    """Logits at the ScheduleFree evaluation point x after three steps:
    within 1e-3 of scale, and the same predicted classes."""
    jout, tout = trajectories
    assert_close(tout["eval_logits"], jout["eval_logits"], 1e-3, "eval logits")
    np.testing.assert_array_equal(tout["eval_logits"].argmax(-1),
                                  jout["eval_logits"].argmax(-1))


@pytest.mark.parametrize("raw", [20, 24, 13])
def test_eval_views_match_jax(raw):
    """Both train views (resize, center crop, two normalizations) within
    1e-5: the separable bilinear resampler runs when raw differs from the
    resize size (24 and 13 here; 20 skips it)."""
    from basd_tpu.ops.preprocess import dual_view_eval as jax_dual_view_eval

    images = (np.random.default_rng(raw).random((3, raw, raw, 3)) * 255).astype(np.uint8)
    kw = dict(img_size=IMG, crop_ratio=IMG / 20, teacher_stats=TEACHER_STATS,
              dataset_stats=DATASET_STATS)
    want = jax_dual_view_eval(jnp.asarray(images), **kw)
    got = dual_view_eval(torch.from_numpy(images), **kw)
    for g, w in zip(got, want):
        assert g.shape == (3, IMG, IMG, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_schedule_free_matches_jax_optimizer():
    """Six ScheduleFree AdamW steps (warm-up 3, weight decay) from the same
    parameters and gradients: y and the evaluation point x within 1e-6."""
    from basd_tpu.training.schedule_free import schedule_free_adamw
    from basd_tpu_torch.training.schedule_free import ScheduleFreeAdamW

    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0]
             for _ in range(6)]
    opt = schedule_free_adamw(1e-2, weight_decay=0.05, warmup_steps=3)
    jp = [jnp.asarray(p) for p in p0]
    st = opt.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    topt = ScheduleFreeAdamW(tp, 1e-2, weight_decay=0.05, warmup_steps=3)
    for g in grads:
        upd, st = opt.update([jnp.asarray(x) for x in g], st, jp)
        jp = [a + u for a, u in zip(jp, upd)]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        topt.step()
    for p, j in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), atol=1e-6)
    jx = jax_eval_params(st, jp)
    for x, j in zip(topt.eval_params(), jx):
        np.testing.assert_allclose(x.numpy(), np.asarray(j), atol=1e-6)
