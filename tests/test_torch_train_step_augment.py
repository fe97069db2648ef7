"""The slice as a whole: three steps of the port's
`make_train_step(augment=True)` (bench.py's step: RandomResizedCrop,
hflip, TrivialAugmentWide, MixUp/CutMix) against the JAX package's, from
the same weights, selector and batch, with the augmentation draws of each
port step replayed from the JAX state's key (the setting of
tests/test_torch_train_step.py: vit_micro student, vit_mini teacher,
16 px, batch 8, drop_path 0, fp32 on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.losses import extraction_points as jax_extraction_points
from basd_tpu.losses import init_selector as jax_init_selector
from basd_tpu.models import create_student as jax_create_student
from basd_tpu.models import load_teacher as jax_load_teacher
from basd_tpu.training.train_step import make_train_step as jax_make_train_step
from basd_tpu_torch.losses import extraction_points
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.models.convert import selector_state_from_numpy
from basd_tpu_torch.ops.augment import OP_ROTATE
from basd_tpu_torch.training import train_step as ttrain
from test_torch_helpers import CPU, carry_vit, jax_step_draws

torch.set_num_threads(1)

STEPS = 3
B, IMG, RAW, C = 8, 16, 20, 10
TEACHER_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
DATASET_STATS = ((0.507, 0.487, 0.441), (0.267, 0.256, 0.276))
STEP_KW = dict(
    learning_rate=1e-3, weight_decay=0.05, warmup_steps=5, label_smoothing=0.1,
    img_size=IMG, crop_ratio=IMG / RAW, teacher_stats=TEACHER_STATS,
    dataset_stats=DATASET_STATS, num_classes=C,
)


@pytest.fixture(scope="module")
def trajectories():
    rng = np.random.default_rng(42)
    images = (rng.random((B, RAW, RAW, 3)) * 255).astype(np.uint8)
    labels = rng.integers(0, C, B, dtype=np.int32)
    points = jax_extraction_points(4, 2)

    # ---- JAX package: the default (augment=True) step, jitted ----
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
    draws, jout = [], {"loss": [], "temps": [], "ranks": []}
    for _ in range(STEPS):
        draws.append(jax_step_draws(state.rng, B))
        state, m = step(state, jt.variables, jnp.asarray(images), jnp.asarray(labels))
        jout["loss"].append(float(m["loss"]))
        jout["temps"].append(np.asarray(m["temperatures"]))
        jout["ranks"].append(np.asarray(m["mp_ranks"]))

    # ---- the port, same weights, selector, batch and draws ----
    tt = load_teacher("vit_mini_patch4", img_size=IMG, dtype=torch.float32, device=CPU)
    carry_vit(jt.variables["params"], tt.module)
    ts, _ = create_student(
        "vit_micro_patch4", num_classes=C, drop_path_rate=0.0, img_size=IMG,
        capture_layers=extraction_points(4, 2), dtype=torch.float32, device=CPU,
    )
    carry_vit(student_params, ts)
    tsel = selector_state_from_numpy(
        np.asarray(jsel.log_temperatures), np.asarray(jsel.proj_s),
        np.asarray(jsel.proj_t), device=CPU)
    tinit, tstep = ttrain.make_train_step(ts, tt, **STEP_KW)
    tstate = tinit(0, tsel)
    replay = iter(draws)
    mp = pytest.MonkeyPatch()
    mp.setattr(ttrain, "sample_step_draws", lambda generator, batch: next(replay))
    try:
        tout = {"loss": [], "temps": [], "ranks": []}
        for _ in range(STEPS):
            tstate, m = tstep(tstate, torch.from_numpy(images),
                              torch.from_numpy(labels.astype(np.int64)))
            tout["loss"].append(float(m["loss"]))
            tout["temps"].append(m["temperatures"].numpy())
            tout["ranks"].append(m["mp_ranks"].numpy())
    finally:
        mp.undo()
    assert tstate.step == STEPS
    return draws, jout, tout


def test_draws_exercise_the_augmented_path(trajectories):
    """The replayed draws reach the warp and the mixing: geometric ops, both
    flips and more than one op. None is a +-135 degree rotation, where the
    compiled JAX step picks the other quarter-turn
    (tests/test_torch_augment.py)."""
    draws, _, _ = trajectories
    ops = torch.cat([d.view.augment.op for d in draws])
    mags = torch.cat([d.view.augment.mag for d in draws])
    flips = torch.cat([d.view.flip for d in draws])
    assert ((ops >= 1) & (ops <= 5)).any() and len(set(ops.tolist())) > 3
    assert flips.any() and not flips.all()
    assert not ((ops == OP_ROTATE) & (mags == 1.0)).any()


def test_losses_match(trajectories):
    """Per-step loss within rtol 5e-4, as the augment=False slice test."""
    _, jout, tout = trajectories
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=5e-4)


def test_mp_ranks_exactly_equal(trajectories):
    _, jout, tout = trajectories
    np.testing.assert_array_equal(np.stack(tout["ranks"]), np.stack(jout["ranks"]))


def test_temperatures_match(trajectories):
    """Temperatures as each step reports them: within 1e-5 absolute."""
    _, jout, tout = trajectories
    np.testing.assert_allclose(np.stack(tout["temps"]), np.stack(jout["temps"]),
                               atol=1e-5)
