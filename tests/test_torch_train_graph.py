"""The step as one program per update: `training.train_step.step_route`,
the ScheduleFree optimizer's per-step coefficients as device tensors, the
step's device constants, and the step body fed from static input buffers
(what a CUDA graph replays) against the eager step and the JAX package's
step. All on the CPU: the capture itself needs the card (chip_smoke.py
phase 5e)."""

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
from basd_tpu_torch.device import CONSTANTS
from basd_tpu_torch.losses import extraction_points, init_selector
from basd_tpu_torch.losses.interpolate import interp_matrix, linear_interp_matrix
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.models.convert import selector_state_from_numpy
from basd_tpu_torch.ops import augment
from basd_tpu_torch.spectral import ops as spectral_ops
from basd_tpu_torch.spectral import tridiag
from basd_tpu_torch.training import train_step as ttrain
from basd_tpu_torch.training.schedule_free import ScheduleFreeAdamW
from test_torch_helpers import CPU, carry_vit, jax_step_draws

torch.set_num_threads(1)

# ---- step_route: the configurations of the three tables ----
# Table-3: DeiT-Tiny/4 at 32 px (64 patch tokens, D 192), DINOv2 ViT-B/14
# (12 layers, 2 x 2 patch tokens), batch 128, the calibrated K 48; Table-1:
# ViT-S/16 at 224 px (196 tokens, D 384), ViT-L/14 (24 layers, 256 tokens),
# batch 256, K 192; Table-2: DeiT-Tiny/16 (196 tokens, D 192), ConvNeXt-V2-
# Tiny (one token layer of 7 x 7), batch 256, K 72
TABLE3 = dict(num_points=4, teacher_layers=12, student_dim=192, student_tokens=64,
              teacher_tokens=4, batch=128, subspace_k=48)
TABLE1 = dict(num_points=4, teacher_layers=24, student_dim=384, student_tokens=196,
              teacher_tokens=256, batch=256, subspace_k=192)
TABLE2 = dict(num_points=4, teacher_layers=1, student_dim=192, student_tokens=196,
              teacher_tokens=49, batch=256, subspace_k=72)
ROUTES = {
    "table3_cuda": ("cuda", TABLE3, {}, "graph",
                    "the eighs ((12, 48, 48), (4, 48, 48), (4, 12, 48, 48)) on K3"),
    "table3_cpu": ("cpu", TABLE3, {}, "eager", "cpu: the plain versions"),
    "table1_k192": ("cuda", TABLE1, {}, "eager",
                    "eigh (24, 192, 192) is outside the Jacobi gate"),
    "table2_teacher_batch_1": ("cuda", TABLE2, {}, "eager",
                               "eigh (1, 72, 72) is outside the Jacobi gate"),
    "mesh": ("cuda", TABLE3, {"mesh": object()}, "eager", "a mesh"),
    "remat": ("cuda", TABLE3, {"remat": True}, "graph",
              "remat's recomputation of each student block inside the backward"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_step_route(case):
    """The route and its reason from the configuration and the device type
    alone (no card: a device is only named)."""
    device, config, extra, route, reason = ROUTES[case]
    got_route, got_reason = ttrain.step_route(device, **config, **extra)
    assert got_route == route
    assert reason in got_reason, got_reason
    if route == "eager" and "eigh" in reason:
        assert "cuSOLVER" in got_reason


def test_route_reads_the_models_configuration(monkeypatch):
    """The step's first call asks `step_route` with the numbers of its
    models and batch: P extraction points, the teacher's token layers, D_s,
    the patch tokens of each side (CLS excluded), remat and the mesh."""
    asked = {}

    def record(device, **kw):
        asked.update(kw, device=device)
        return "eager", "recorded"

    teacher = load_teacher("vit_mini_patch4", img_size=16, dtype=torch.float32, device=CPU)
    student, cfg = create_student(
        "vit_micro_patch4", num_classes=10, drop_path_rate=0.0, img_size=16,
        arch_overrides={"patch_size": 2}, capture_layers=extraction_points(4, 2),
        dtype=torch.float32, remat=True, device=CPU)
    _, step = ttrain.make_train_step(student, teacher, **small_step_kw(), subspace_k=40)
    monkeypatch.setattr(ttrain, "step_route", record)
    assert step._route_for(6) == ("eager", "recorded")
    assert asked == dict(device=CPU, num_points=2, teacher_layers=6, student_dim=64,
                         student_tokens=64, teacher_tokens=16, batch=6, subspace_k=40,
                         mesh=None, remat=True)


# ---- ScheduleFree: device coefficients against the former host scalars ----


def former_schedule_free_step(params, state, group) -> None:
    """The update as it was written with Python-float coefficients (before
    `advance` / `update`), kept here verbatim as the reference."""
    group["step"] += 1
    t = group["step"]
    warm = group["warmup_steps"]
    sched = min(1.0, t / max(warm, 1)) if warm else 1.0
    beta1, beta2 = group["beta1"], group["beta2"]
    gamma = group["lr"] * sched * (1.0 - beta2**t) ** 0.5
    weight = gamma ** group["weight_lr_power"]
    group["weight_sum"] += weight
    ws = group["weight_sum"]
    ckp1 = weight / ws if ws > 0 else 0.0
    wd = group["weight_decay"]
    with torch.no_grad():
        for p in params:
            st = state[p]
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            g = g.float()
            y = p.float()
            v, z = st["exp_avg_sq"], st["z"]
            v.mul_(beta2).add_((1.0 - beta2) * g * g)
            u = g / (v.sqrt() + group["eps"])
            if wd:
                u = u + wd * y
            y_new = y + ckp1 * (z - y) + gamma * (beta1 * (1.0 - ckp1) - 1.0) * u
            z.sub_(gamma * u)
            p.copy_(y_new.to(p.dtype))


def test_schedule_free_device_coefficients_bit_for_bit():
    """20 steps (warm-up 7, weight decay) of `ScheduleFreeAdamW.step`
    (advance, then update from 0-d fp32 device tensors) against the former
    host-scalar update on copies of the same parameters and gradients, one
    of them bf16 and one without a gradient: y, z, exp_avg_sq, the
    evaluation point and the bookkeeping equal bit for bit (tolerance 0),
    and the state dict holds the same keys as before."""
    rng = np.random.default_rng(3)
    shapes = ((4, 3), (5,), (2, 3, 4), (6,))
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def make():
        ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
        ps[2] = torch.nn.Parameter(ps[2].detach().to(torch.bfloat16))
        return ps

    new_p, old_p = make(), make()
    kw = dict(weight_decay=0.05, warmup_steps=7)
    new = ScheduleFreeAdamW(new_p, 3e-2, **kw)
    old = ScheduleFreeAdamW(old_p, 3e-2, **kw)
    for _ in range(20):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        for ps in (new_p, old_p):
            for i, (p, g) in enumerate(zip(ps, grads)):
                p.grad = None if i == 3 else torch.from_numpy(g).to(p.dtype)
        new.step()
        former_schedule_free_step(old_p, old.state, old.param_groups[0])
        for a, b in zip(new_p, old_p):
            assert torch.equal(a.detach(), b.detach())
            for key in ("z", "exp_avg_sq"):
                assert torch.equal(new.state[a][key], old.state[b][key])
    for a, b in zip(new.eval_params(), old.eval_params()):
        assert torch.equal(a, b)
    g_new, g_old = new.param_groups[0], old.param_groups[0]
    assert (g_new["step"], g_new["weight_sum"]) == (g_old["step"], g_old["weight_sum"]) == (
        20, g_old["weight_sum"])
    sd = new.state_dict()
    assert set(sd["param_groups"][0]) == {
        "lr", "beta1", "beta2", "eps", "weight_decay", "warmup_steps",
        "weight_lr_power", "step", "weight_sum", "params"}
    assert all(set(s) == {"z", "exp_avg_sq"} for s in sd["state"].values())


# ---- a small augmented step on the CPU ----

B, IMG, RAW, C = 8, 16, 20, 10
TEACHER_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
DATASET_STATS = ((0.507, 0.487, 0.441), (0.267, 0.256, 0.276))


def small_step_kw() -> dict:
    return dict(learning_rate=1e-3, weight_decay=0.05, warmup_steps=5, label_smoothing=0.1,
                img_size=IMG, crop_ratio=IMG / RAW, teacher_stats=TEACHER_STATS,
                dataset_stats=DATASET_STATS, num_classes=C)


def small_batch(b: int = B):
    rng = np.random.default_rng(42)
    images = (rng.random((b, RAW, RAW, 3)) * 255).astype(np.uint8)
    return images, rng.integers(0, C, b, dtype=np.int32)


FORMER_CONSTANTS = {
    # each constant as the step made it on every call before it was cached
    "interp_matrix": lambda n_out, n_in, dev: torch.from_numpy(
        linear_interp_matrix(n_out, n_in)).to(dev),
    "_order_constant": lambda ks, dev: torch.tensor(ks, dtype=torch.int32, device=dev),
    "_start_block": lambda d, k, dev: torch.from_numpy(np.asarray(
        np.random.default_rng(20_240_601).standard_normal((d, k)), np.float32)).to(dev),
    "_channel_constant": lambda values, dev: torch.as_tensor(
        values, dtype=torch.float32, device=dev),
}


def test_step_constants_equal_the_former_per_call_values():
    """One augmented step (student at patch 2: 64 tokens against the
    teacher's 16, so the token alignment runs) makes each of the four
    constants; each equals the value the step used to build per call, bit
    for bit (tolerance 0, same dtype), a second call of its builder returns
    the same tensor object, and a second step makes no new one."""
    teacher = load_teacher("vit_mini_patch4", img_size=IMG, dtype=torch.float32, device=CPU)
    student, _ = create_student(
        "vit_micro_patch4", num_classes=C, drop_path_rate=0.0, img_size=IMG,
        arch_overrides={"patch_size": 2}, capture_layers=extraction_points(4, 2),
        dtype=torch.float32, device=CPU)
    sel = init_selector(1, 2, 64, 96, device=CPU)
    init_fn, step = ttrain.make_train_step(student, teacher, **small_step_kw())
    state = init_fn(0, sel)
    images, labels = (torch.from_numpy(x) for x in small_batch(4))
    CONSTANTS.clear()
    step(state, images, labels.long())
    made = dict(CONSTANTS)
    assert {key[0] for key in made} == set(FORMER_CONSTANTS)
    assert ("interp_matrix", 64, 16, CPU) in made
    builders = dict(interp_matrix=interp_matrix, _order_constant=tridiag._order_constant,
                    _start_block=spectral_ops._start_block,
                    _channel_constant=augment._channel_constant)
    for (name, *args), tensor in made.items():
        former = FORMER_CONSTANTS[name](*args)
        assert tensor.dtype == former.dtype and torch.equal(tensor, former), name
        assert builders[name](*args) is tensor
    step(state, images, labels.long())
    assert CONSTANTS.keys() == made.keys()
    assert all(CONSTANTS[key] is tensor for key, tensor in made.items())


STEPS = 3


@pytest.fixture(scope="module")
def static_trajectories():
    """Three augmented steps three ways, from the same weights, selector,
    batch and draws (the setting of tests/test_torch_train_step_augment.py:
    vit_micro student, vit_mini teacher, 16 px, batch 8, fp32): the JAX
    package's jitted step; the port's step (the eager route on the CPU);
    and the port's step body fed from static input buffers, with the
    optimizer's host half before it, as a graph replay runs it."""
    images, labels = small_batch()
    points = jax_extraction_points(4, 2)
    jt = jax_load_teacher("vit_mini_patch4", img_size=IMG, dtype=jnp.float32)
    js, jcfg = jax_create_student(
        "vit_micro_patch4", num_classes=C, drop_path_rate=0.0, img_size=IMG,
        capture_layers=points, dtype=jnp.float32, remat=False,
    )
    jsel = jax_init_selector(jax.random.PRNGKey(1), len(points),
                             jcfg.embed_dim, jt.spec.embed_dim)
    _, init_fn, step_fn = jax_make_train_step(js, jt, **small_step_kw())
    jstate = init_fn(jax.random.PRNGKey(0), jsel)
    params0 = jstate.params
    step = jax.jit(step_fn)
    draws, jout = [], []
    for _ in range(STEPS):
        draws.append(jax_step_draws(jstate.rng, B))
        jstate, m = step(jstate, jt.variables, jnp.asarray(images), jnp.asarray(labels))
        jout.append({k: np.asarray(v) for k, v in m.items()})

    tt = load_teacher("vit_mini_patch4", img_size=IMG, dtype=torch.float32, device=CPU)
    carry_vit(jt.variables["params"], tt.module)
    timages = torch.from_numpy(images)
    tlabels = torch.from_numpy(labels.astype(np.int64))

    def port(run_static: bool):
        ts, _ = create_student(
            "vit_micro_patch4", num_classes=C, drop_path_rate=0.0, img_size=IMG,
            capture_layers=extraction_points(4, 2), dtype=torch.float32, device=CPU,
        )
        carry_vit(params0, ts)
        tsel = selector_state_from_numpy(
            np.asarray(jsel.log_temperatures), np.asarray(jsel.proj_s),
            np.asarray(jsel.proj_t), device=CPU)
        tinit, tstep = ttrain.make_train_step(ts, tt, **small_step_kw())
        state = tinit(0, tsel)
        static = (torch.empty_like(timages), torch.empty_like(tlabels))
        replay = iter(draws)
        mp = pytest.MonkeyPatch()
        mp.setattr(ttrain, "sample_step_draws", lambda generator, batch: next(replay))
        out = []
        try:
            for _ in range(STEPS):
                if run_static:
                    static[0].copy_(timages)
                    static[1].copy_(tlabels)
                    state.optimizer.advance()
                    met = {k: v.clone() for k, v in tstep.body(state, *static).items()}
                    state.step += 1
                else:
                    state, met = tstep(state, timages, tlabels)
                out.append(met)
        finally:
            mp.undo()
        return tstep, state, out

    return jout, port(False), port(True)


def test_step_runs_eagerly_on_the_cpu(static_trajectories):
    _, (tstep, state, _), _ = static_trajectories
    assert tstep.route == "eager" and tstep.reason.startswith("cpu")
    assert tstep.graph is None and state.step == STEPS


def test_static_body_equals_the_eager_step_bit_for_bit(static_trajectories):
    """Every metric of every step, the parameters, the temperatures, the
    optimizer's z and exp_avg_sq, the bookkeeping and the generator equal
    (tolerance 0)."""
    _, (_, eager_state, eager_out), (_, static_state, static_out) = static_trajectories
    for em, sm in zip(eager_out, static_out):
        assert em.keys() == sm.keys()
        for key in em:
            assert torch.equal(em[key], sm[key]), key
    for a, b in zip(eager_state.student.parameters(), static_state.student.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(eager_state.selector.log_temperatures,
                       static_state.selector.log_temperatures)
    eo, so = eager_state.optimizer, static_state.optimizer
    for a, b in zip(eo.param_groups[0]["params"], so.param_groups[0]["params"]):
        for key in ("z", "exp_avg_sq"):
            assert torch.equal(eo.state[a][key], so.state[b][key])
    assert (eo.param_groups[0]["step"], eo.param_groups[0]["weight_sum"]) == (
        so.param_groups[0]["step"], so.param_groups[0]["weight_sum"])
    assert torch.equal(eager_state.generator.get_state(), static_state.generator.get_state())
    assert static_state.step == eager_state.step == STEPS


def test_static_body_matches_jax(static_trajectories):
    """Against the JAX package's trajectory at the augmented slice test's
    tolerances: loss rtol 5e-4, MP ranks equal, temperatures 1e-5."""
    jout, _, (_, _, static_out) = static_trajectories
    np.testing.assert_allclose([float(m["loss"]) for m in static_out],
                               [float(m["loss"]) for m in jout], rtol=5e-4)
    np.testing.assert_array_equal(np.stack([m["mp_ranks"].numpy() for m in static_out]),
                                  np.stack([m["mp_ranks"] for m in jout]))
    np.testing.assert_allclose(np.stack([m["temperatures"].numpy() for m in static_out]),
                               np.stack([m["temperatures"] for m in jout]), atol=1e-5)


def test_captured_step_refuses_another_batch_or_state():
    """After a capture the step takes only the captured batch's shape,
    dtype and device, and the captured state: anything else raises before
    a copy or a replay (the inputs are checked on the host)."""
    step = ttrain.TrainStep(body=None, route_for=None)
    state = object()
    step.route, step._state = "graph", state
    step._inputs = (torch.zeros((2, 4, 4, 3), dtype=torch.uint8),
                    torch.zeros(2, dtype=torch.int64))
    images, labels = step._inputs
    with pytest.raises(ValueError, match="another TrainState"):
        step(object(), images, labels)
    with pytest.raises(ValueError, match=r"\(2, 4, 4, 3\)"):
        step(state, torch.zeros((3, 4, 4, 3), dtype=torch.uint8), labels)
    with pytest.raises(ValueError, match="torch.int64"):
        step(state, images, labels.to(torch.int32))
