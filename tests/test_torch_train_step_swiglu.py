"""A SwiGLU teacher through the port's whole step: three steps of
`make_train_step` with the micro SwiGLU teacher (`dinov2_swiglu_micro_patch4`:
D 64, 4 blocks, 2 heads, patch 4, LayerScale, packed width 340) against
the reference, for `augment=False` and `augment=True`.

The reference is the JAX package's step with its teacher's forward done
by the plain float32 SwiGLU reference (`basd_tpu_torch/reference/
vit_swiglu.py`, called on the host through `jax.pure_callback`): the JAX
package builds no SwiGLU block, and everything after the teacher (the
views, the selector, Procrustes, CE, UW-SO and ScheduleFree) is its own.
Same student and teacher weights, selector, batch and augmentation
draws; vit_micro_patch4 student at 16 px, batch 8, drop_path 0, fp32 on
the CPU."""

from types import SimpleNamespace

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
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.models.convert import selector_state_from_numpy
from basd_tpu_torch.reference import vit_swiglu
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


class ReferenceTeacher:
    """Stands in for the JAX teacher's flax module: `apply` hands the
    clean view to the plain SwiGLU reference on the host."""

    def __init__(self, weights: dict, spec):
        self.weights, self.spec = weights, spec

    def _host(self, images):
        with torch.no_grad():
            tokens, importance = vit_swiglu.forward(
                self.weights, torch.from_numpy(np.array(images)),
                patch_size=self.spec.patch_size, depth=self.spec.depth,
                heads=self.spec.num_heads)
        return tokens.numpy(), importance.numpy()

    def apply(self, variables, images, train=False):
        n = self.spec.num_tokens(IMG)
        shapes = (jax.ShapeDtypeStruct((self.spec.depth, images.shape[0], n,
                                        self.spec.embed_dim), jnp.float32),
                  jax.ShapeDtypeStruct((self.spec.depth, images.shape[0], n), jnp.float32))
        tokens, importance = jax.pure_callback(self._host, shapes, images)
        return SimpleNamespace(tokens=tokens, importance=importance)


@pytest.fixture(scope="module", params=[False, True], ids=["augment=False", "augment=True"])
def trajectories(request):
    augment = request.param
    rng = np.random.default_rng(21)
    images = (rng.random((B, RAW, RAW, 3)) * 255).astype(np.uint8)
    labels = rng.integers(0, C, B, dtype=np.int32)
    points = jax_extraction_points(4, 2)

    # the port's teacher, LayerScale gammas moved off their 1e-5 init so
    # that the four layers differ and the selector has layers to weigh
    tt = load_teacher("dinov2_swiglu_micro_patch4", img_size=IMG, seed=5,
                      dtype=torch.float32, device=CPU)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for blk in tt.module.blocks:
            blk.ls1.gamma.copy_(0.5 + torch.rand(64, generator=g))
            blk.ls2.gamma.copy_(0.5 + torch.rand(64, generator=g))
    weights = {n: p.detach().clone() for n, p in tt.module.state_dict().items()}

    # ---- the reference: the JAX package's step, its teacher the plain one ----
    jt = jax_load_teacher("dinov2_micro_patch4", img_size=IMG, dtype=jnp.float32)
    jt = jt._replace(module=ReferenceTeacher(weights, tt.spec))
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
        state, m = step(state, {}, jnp.asarray(images), jnp.asarray(labels))
        jout["loss"].append(float(m["loss"]))
        jout["temps"].append(np.asarray(m["temperatures"]))
        jout["ranks"].append(np.asarray(m["mp_ranks"]))
        jout["weights"].append(np.asarray(m["mixing_weights"]))

    # ---- the port, same weights, selector, batch and draws ----
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
    return jout, tout


def test_losses_match(trajectories):
    """Per-step loss within rtol 5e-4 (the JAX package's own tolerance for
    swapping its eigh backend, tests/test_parallel.py), and the step
    trains."""
    jout, tout = trajectories
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=5e-4)
    assert np.isfinite(tout["loss"]).all() and jout["loss"][-1] < jout["loss"][0]


def test_mp_ranks_exactly_equal(trajectories):
    """The four teacher layers' MP ranks at every step, as integers."""
    jout, tout = trajectories
    np.testing.assert_array_equal(np.stack(tout["ranks"]), np.stack(jout["ranks"]))
    assert np.stack(tout["ranks"]).shape == (STEPS, 4)


def test_temperatures_match(trajectories):
    """Temperatures as each step reports them: within 1e-5 absolute; the
    mixing weights over the four layers within 1e-4 (they are not uniform:
    the layers differ)."""
    jout, tout = trajectories
    np.testing.assert_allclose(np.stack(tout["temps"]), np.stack(jout["temps"]), atol=1e-5)
    w = np.stack(tout["weights"])
    np.testing.assert_allclose(w, np.stack(jout["weights"]), atol=1e-4)
    assert w.shape == (STEPS, 2, 4) and np.abs(w - 0.25).max() > 1e-3
