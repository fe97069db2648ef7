"""The train and evaluate entry points as one program per update, on the
CPU: `step_route` with remat, the remat step run through `TrainStep`'s
graph route (its body fed from static buffers) against the eager remat
step and the JAX package's `nn.remat` step, the Trainer's restore forgetting
a capture, and the evaluation's graph route (its cache, its static
parameter buffers, its sums against the eager ones) against the eager
route, whose sums stay what they were.

No card here: the graph routes run with `StandInGraph` in place of
`device.CapturedCall`, which lives the same life (call 1 the warm-up, call
2 the capture and its replay, later calls replays) and replays by running
the captured function again on the static buffers it closes over. The
capture itself is held on the card (chip_smoke.py phase 8)."""

import copy
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from basd_tpu.losses import extraction_points as jax_extraction_points
from basd_tpu.losses import init_selector as jax_init_selector
from basd_tpu.models import create_student as jax_create_student
from basd_tpu.models import load_teacher as jax_load_teacher
from basd_tpu.training.train_step import make_train_step as jax_make_train_step
from basd_tpu_torch.config import compose_config
from basd_tpu_torch.data import load_split_arrays
from basd_tpu_torch.data.pipeline import to_device
from basd_tpu_torch.evaluation import metrics as tmetrics
from basd_tpu_torch.losses import extraction_points, init_selector
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.models.convert import selector_state_from_numpy
from basd_tpu_torch.ops.preprocess import eval_view
from basd_tpu_torch.training import train_step as ttrain
from basd_tpu_torch.training.trainer import Trainer
from test_torch_helpers import CPU, carry_vit, jax_step_draws
from test_torch_train_graph import TABLE1, TABLE2, TABLE3, B, C, IMG, small_batch, small_step_kw

torch.set_num_threads(1)


class StandInGraph:
    """`device.CapturedCall` without a card: call 1 runs `fn` (the warm-up),
    call 2 "captures" (runs nothing) and replays, later calls replay; a
    replay runs `fn` again, reading the buffers it closes over, as a graph
    re-reads the addresses it captured."""

    def __init__(self, made, fn, device, generator=None):
        self.fn, self.device, self.generator = fn, device, generator
        self.warmed = False
        self.graph = self.launches = self.capture_s = self.pool_bytes = None
        self.replays = 0
        made.append(self)

    def __call__(self):
        if not self.warmed:
            self.warmed = True
            return self.fn()
        if self.graph is None:
            self.graph, self.launches = "captured", {}
        self.replays += 1
        return self.fn()


@pytest.fixture
def stand_in(monkeypatch):
    """Every graph route on the CPU, with `StandInGraph`s; returns the list
    of those made."""
    made = []
    make = lambda fn, device, generator=None: StandInGraph(made, fn, device, generator)
    monkeypatch.setattr(ttrain, "CapturedCall", make)
    monkeypatch.setattr(tmetrics, "CapturedCall", make)
    monkeypatch.setattr(ttrain, "step_route", lambda device, **kw: ("graph", "stand-in"))
    monkeypatch.setattr(tmetrics, "eval_route", lambda device, mesh=None: (
        ("graph", "stand-in") if mesh is None else ("eager", "a mesh")))
    tmetrics._EVAL_GRAPH_CACHE.clear()
    yield made
    tmetrics._EVAL_GRAPH_CACHE.clear()


# ---- step_route: remat no longer keeps a step eager ----

ROUTES = {
    "table3_cuda": ("cuda", TABLE3, {}, "graph",
                    "remat's recomputation of each student block inside the backward"),
    "table3_cpu": ("cpu", TABLE3, {}, "eager", "cpu: the plain versions"),
    "table1": ("cuda", TABLE1, {}, "eager", "eigh (24, 192, 192) is outside the Jacobi gate"),
    "table2": ("cuda", TABLE2, {}, "eager", "eigh (1, 72, 72) is outside the Jacobi gate"),
    "mesh": ("cuda", TABLE3, {"mesh": object()}, "eager", "a mesh"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_remat_step_route(case):
    """With remat on: Table-3 on a CUDA-typed device takes the graph (its
    reason naming the recomputation); Table-1, Table-2, a mesh and the CPU
    stay eager with their reasons."""
    device, config, extra, route, reason = ROUTES[case]
    got_route, got_reason = ttrain.step_route(device, **config, **extra, remat=True)
    assert (got_route, reason in got_reason) == (route, True), got_reason
    assert ttrain.step_route(device, **config, **extra, remat=False)[0] == route


def test_eval_route():
    assert tmetrics.eval_route("cuda")[0] == "graph"
    assert tmetrics.eval_route("cpu") == ("eager", "cpu: the plain versions, op by op")
    assert tmetrics.eval_route("cuda", mesh=object())[0] == "eager"


# ---- the remat step on the graph route against eager and the JAX step ----

STEPS = 3


def _remat_student(drop_path: float):
    ts, _ = create_student(
        "vit_micro_patch4", num_classes=C, drop_path_rate=drop_path, img_size=IMG,
        capture_layers=extraction_points(4, 2), dtype=torch.float32, remat=True,
        device=CPU)
    return ts


@pytest.fixture(scope="module")
def remat_trajectories():
    """Three augmented remat steps three ways, from the same weights,
    selector, batch and draws (vit_micro student with remat, vit_mini
    teacher, 16 px, batch 8, fp32, drop path 0): the JAX package's jitted
    step (`nn.remat`); the port's step on its eager route; and the port's
    `TrainStep` on the graph route (`StandInGraph`: its body reads the
    static input buffers each call refills)."""
    images, labels = small_batch()
    points = jax_extraction_points(4, 2)
    jt = jax_load_teacher("vit_mini_patch4", img_size=IMG, dtype=jnp.float32)
    js, jcfg = jax_create_student(
        "vit_micro_patch4", num_classes=C, drop_path_rate=0.0, img_size=IMG,
        capture_layers=points, dtype=jnp.float32, remat=True)
    jsel = jax_init_selector(jax.random.PRNGKey(1), len(points), jcfg.embed_dim,
                             jt.spec.embed_dim)
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

    def port(graph: bool):
        ts = _remat_student(0.0)
        carry_vit(params0, ts)
        tsel = selector_state_from_numpy(
            np.asarray(jsel.log_temperatures), np.asarray(jsel.proj_s),
            np.asarray(jsel.proj_t), device=CPU)
        mp = pytest.MonkeyPatch()
        made = []
        if graph:
            mp.setattr(ttrain, "CapturedCall",
                       lambda fn, device, generator=None: StandInGraph(made, fn, device,
                                                                       generator))
            mp.setattr(ttrain, "step_route", lambda device, **kw: ("graph", "stand-in"))
        replay = iter(draws)
        mp.setattr(ttrain, "sample_step_draws", lambda generator, batch: next(replay))
        try:
            tinit, tstep = ttrain.make_train_step(ts, tt, **small_step_kw())
            state = tinit(0, tsel)
            out = []
            for _ in range(STEPS):
                # fresh tensors each call: the graph route must copy them
                state, met = tstep(state, torch.from_numpy(images.copy()),
                                   torch.from_numpy(labels.astype(np.int64)))
                out.append(met)
        finally:
            mp.undo()
        return tstep, state, out, made

    return jout, port(False), port(True)


def test_remat_graph_route_equals_the_eager_remat_step_bit_for_bit(remat_trajectories):
    """Every metric of every step, the parameters, the temperatures, z,
    exp_avg_sq, the bookkeeping and the generator equal (tolerance 0); the
    graph route warmed up once, captured once with the state's generator
    registered, and replayed the rest."""
    _, (etstep, est, eout, _), (gtstep, gst, gout, made) = remat_trajectories
    assert etstep.route == "eager" and gtstep.route == "graph"
    assert len(made) == 1 and made[0].replays == STEPS - 1
    assert made[0].generator is gst.generator and gtstep.graph == "captured"
    for em, gm in zip(eout, gout):
        assert em.keys() == gm.keys()
        for key in em:
            assert torch.equal(em[key], gm[key]), key
    for a, b in zip(est.student.parameters(), gst.student.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(est.selector.log_temperatures, gst.selector.log_temperatures)
    eo, go = est.optimizer, gst.optimizer
    for a, b in zip(eo.param_groups[0]["params"], go.param_groups[0]["params"]):
        for key in ("z", "exp_avg_sq"):
            assert torch.equal(eo.state[a][key], go.state[b][key])
    assert (eo.param_groups[0]["step"], eo.param_groups[0]["weight_sum"]) == (
        go.param_groups[0]["step"], go.param_groups[0]["weight_sum"])
    assert torch.equal(est.generator.get_state(), gst.generator.get_state())
    assert gst.step == est.step == STEPS


def test_remat_graph_route_matches_jax(remat_trajectories):
    """Against the JAX package's `nn.remat` trajectory at
    tests/test_torch_train_graph.py's tolerances: loss rtol 5e-4, MP ranks
    equal, temperatures 1e-5."""
    jout, _, (_, _, gout, _) = remat_trajectories
    np.testing.assert_allclose([float(m["loss"]) for m in gout],
                               [float(m["loss"]) for m in jout], rtol=5e-4)
    np.testing.assert_array_equal(np.stack([m["mp_ranks"].numpy() for m in gout]),
                                  np.stack([m["mp_ranks"] for m in jout]))
    np.testing.assert_allclose(np.stack([m["temperatures"].numpy() for m in gout]),
                               np.stack([m["temperatures"] for m in jout]), atol=1e-5)


def test_remat_graph_route_with_drop_path_equals_eager(stand_in):
    """Drop path 0.1 (the blocks' draws from the state's generator, made
    outside the checkpointed body): four steps on the graph route equal four
    eager steps bit for bit (tolerance 0), the generator's state included."""
    teacher = load_teacher("vit_mini_patch4", img_size=IMG, dtype=torch.float32, device=CPU)
    images, labels = (torch.from_numpy(x) for x in small_batch())
    runs = []
    for graph in (False, True):
        student = _remat_student(0.1)
        init_fn, step = ttrain.make_train_step(student, teacher, **small_step_kw())
        state = init_fn(0, init_selector(1, 2, 64, 96, device=CPU))
        met = [(step if graph else step.eager)(state, images, labels.long())[1]
               for _ in range(4)]
        runs.append((met, [p.detach().clone() for p in student.parameters()],
                     state.generator.get_state()))
    (em, ep, eg), (gm, gp, gg) = runs
    assert len(stand_in) == 1 and stand_in[0].replays == 3
    assert all(torch.equal(a[k], b[k]) for a, b in zip(em, gm) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(ep, gp)) and torch.equal(eg, gg)


def test_captured_step_refuses_replaced_optimizer_slots(stand_in):
    """After the warm-up, optimizer slots replaced behind the step's back
    (what `load_state_dict` does) raise before any copy or replay; after
    `forget()` the next call routes, warms up and captures again."""
    teacher = load_teacher("vit_mini_patch4", img_size=IMG, dtype=torch.float32, device=CPU)
    student = _remat_student(0.0)
    init_fn, step = ttrain.make_train_step(student, teacher, **small_step_kw())
    state = init_fn(0, init_selector(1, 2, 64, 96, device=CPU))
    images, labels = (torch.from_numpy(x) for x in small_batch())
    step(state, images, labels.long())
    step(state, images, labels.long())
    assert step.graph == "captured" and state.step == 2
    state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    with pytest.raises(ValueError, match="replaced"):
        step(state, images, labels.long())
    assert state.step == 2 and state.optimizer.param_groups[0]["step"] == 2
    step.forget()
    assert (step.route, step.graph, step.launches, step.capture_s) == (None,) * 4
    step(state, images, labels.long())
    assert step.route == "graph" and len(stand_in) == 2 and not stand_in[1].replays
    assert state.step == 3


# ---- the Trainer on the graph route: restore after a capture ----

BATCH = 16


def _trainer(tmp_path, seed_offset=0, save_every=None):
    """basd_smoke (vit_micro with remat, vit_mini teacher, 16 px, batch 16,
    8 steps, fp32 on the CPU)."""
    ov = ["experiment=basd_smoke", f"run.output_dir={tmp_path}",
          f"data.batch_size={BATCH}", "training.num_epochs=1"]
    if save_every:
        ov.append(f"checkpoint.save_every_steps={save_every}")
    config = compose_config(ov)
    teacher = load_teacher("vit_mini_patch4", img_size=16, dtype=torch.float32, device=CPU)
    points = extraction_points(4, config.basd.num_extraction_points)
    student, cfg = create_student(
        "vit_micro_patch4", num_classes=10, drop_path_rate=0.1, img_size=16,
        capture_layers=points, dtype=torch.float32, remat=True, device=CPU,
        seed=config.run.seed + seed_offset)
    return Trainer(config, student=student, student_cfg=cfg, teacher=teacher,
                   teacher_stats=((0.5,) * 3, (0.5,) * 3),
                   dataset_stats=((0.5,) * 3, (0.25,) * 3))


def _data():
    images, labels = load_split_arrays("synthetic/cifar10-like", "train")
    return (images[:128], labels[:128]), (images[128:160], labels[128:160])


def _state_tensors(trainer) -> dict:
    st = trainer.state
    out = {f"student.{k}": v for k, v in st.student.state_dict().items()}
    for i, p in enumerate(st.optimizer.param_groups[0]["params"]):
        out[f"z.{i}"] = st.optimizer.state[p]["z"]
        out[f"v.{i}"] = st.optimizer.state[p]["exp_avg_sq"]
    out["log_t"] = st.selector.log_temperatures
    out["generator"] = st.generator.get_state()
    return out


def _assert_same_state(a, b) -> None:
    want, got = _state_tensors(a), _state_tensors(b)
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(want[key], got[key]), key
    assert a.state.step == b.state.step


def _two_steps(trainer, batches) -> list:
    out = []
    for imgs, labs in batches:
        trainer.state, met = trainer._step(trainer.state, imgs, labs)
        out.append(met)
    return out


def test_trainer_graph_route_equals_eager_and_restore_recaptures(stand_in, tmp_path):
    """One epoch of the Trainer on the graph route (a `StandInGraph` per
    capture) equals a twin Trainer whose step runs `TrainStep.eager`, bit
    for bit: the epoch's metrics, every parameter, z, v, the
    log-temperatures, the generator and the step count. Then `latest` is
    restored into the live Trainer after its capture: the step forgets it
    and its next call warms up and captures again, and two more steps
    equal a fresh Trainer's restored from the same checkpoint."""
    train, val = _data()
    live = _trainer(tmp_path / "live", save_every=4)
    live.train(train, val)
    assert live._step.route == "graph" and live._step.graph == "captured"
    twin = _trainer(tmp_path / "twin", save_every=4)
    twin._step = twin._step.eager
    twin.train(train, val)
    assert dict(live.metrics_history) == dict(twin.metrics_history)
    _assert_same_state(live, twin)
    assert live.state.step == 8

    batches = [to_device((train[0][i * BATCH:(i + 1) * BATCH],
                          train[1][i * BATCH:(i + 1) * BATCH]), CPU) for i in range(2)]
    captures = len(stand_in)
    _two_steps(live, batches)  # the state moves away from `latest`
    assert len(stand_in) == captures
    live.load_checkpoint("latest")
    assert (live._step.route, live._step.graph) == (None, None)
    after = _two_steps(live, batches)
    assert len(stand_in) == captures + 1 and stand_in[-1].replays == 1
    fresh = _trainer(tmp_path / "fresh", seed_offset=7)
    fresh.checkpoints = live.checkpoints
    fresh.load_checkpoint("latest")
    want = _two_steps(fresh, batches)
    for a, b in zip(want, after):
        assert all(torch.equal(a[k], b[k]) for k in a)
    _assert_same_state(live, fresh)
    assert live.state.step == 10


# ---- the evaluation's graph route ----

RAW = 24
KW = dict(img_size=16, crop_ratio=16 / RAW, mean=(0.5, 0.45, 0.4), std=(0.25, 0.2, 0.3),
          batch_size=8)


@pytest.fixture(scope="module")
def eval_student():
    ts, _ = create_student("vit_micro_patch4", num_classes=10, drop_path_rate=0.0,
                           img_size=16, dtype=torch.float32, remat=True, device=CPU)
    return ts


def _split(n=29, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    images = (rng.random((n, RAW, RAW, 3)) * 255).astype(np.uint8)
    return images, rng.integers(0, classes, n).astype(np.int32)


def former_evaluate_sums(model, params, images_u8, labels, *, img_size, crop_ratio, mean,
                         std, batch_size, valid_indices=None, label_smoothing=0.0):
    """`evaluate_model`'s loop as it was written before the graph route
    (one process), kept here verbatim as the reference for its sums."""
    mean = tuple(float(m) for m in mean)
    std = tuple(float(s) for s in std)
    valid = (torch.as_tensor(valid_indices, dtype=torch.long, device=CPU)
             if valid_indices is not None else None)
    loss_sum = torch.zeros((), dtype=torch.float32, device=CPU)
    top1 = torch.zeros((), dtype=torch.long, device=CPU)
    top5 = torch.zeros((), dtype=torch.long, device=CPU)
    n = len(labels)
    with torch.no_grad():
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            imgs, labs = to_device((images_u8[lo:hi], labels[lo:hi]), CPU)
            x = eval_view(imgs, img_size, crop_ratio, mean, std)
            logits = tmetrics._forward(model, params, x)
            if valid is not None:
                logits = logits[:, valid]
            logp = F.log_softmax(logits.float(), dim=-1)
            c = logits.shape[-1]
            smoothed = (1.0 - label_smoothing) * F.one_hot(labs, c) + label_smoothing / c
            loss_sum -= (smoothed * logp).sum()
            top1 += (logits.argmax(dim=-1) == labs).sum()
            top5 += tmetrics.topk_hits(logits, labs, min(5, c)).sum()
    return torch.stack([loss_sum.double(), top1.double(), top5.double()])


EVAL_CASES = {
    "tail_5": (29, None, 0.0),
    "tail_1_subset_smoothing": (25, (7, 2, 9, 4, 1, 0), 0.1),
    "no_tail": (24, None, 0.1),
    "shorter_than_a_batch": (5, None, 0.0),
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_cpu_eval_sums_are_the_former_sums_bit_for_bit(eval_student, case):
    """The CPU route (eager) gives the former loop's (loss, top-1, top-5)
    sums bit for bit (tolerance 0), short tails and subsets included, at
    the model's own weights and at other params."""
    n, subset, smoothing = EVAL_CASES[case]
    images, labels = _split(n, classes=len(subset) if subset else 10)
    other = {k: v * 0.5 for k, v in eval_student.named_parameters()}
    for params in (None, other):
        kw = dict(KW, valid_indices=subset, label_smoothing=smoothing)
        want = former_evaluate_sums(eval_student, params, images, labels, **kw)
        got = tmetrics.eager_eval_sums(eval_student, params, images, labels, **kw)
        assert torch.equal(got, want)
        res = tmetrics.evaluate_model(eval_student, params, images, labels, **kw)
        assert res == {"val_acc": 100.0 * float(want[1]) / n,
                       "val_acc_top5": 100.0 * float(want[2]) / n,
                       "loss": float(want[0]) / n}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_graph_eval_equals_eager_bit_for_bit(stand_in, eval_student, case):
    """The graph route's sums equal the eager route's bit for bit
    (tolerance 0) on its first call (warm-up, capture, replays) and on a
    second (replays only), the short tail eager at its own size; a split
    shorter than a batch makes no graph."""
    n, subset, smoothing = EVAL_CASES[case]
    images, labels = _split(n, classes=len(subset) if subset else 10)
    kw = dict(KW, valid_indices=subset, label_smoothing=smoothing)
    want = tmetrics.eager_eval_sums(eval_student, None, images, labels, **kw)
    for _ in range(2):
        got = tmetrics.graph_eval_sums(eval_student, None, images, labels, **kw)
        assert torch.equal(got, want)
    full = n // KW["batch_size"]
    assert len(stand_in) == (1 if full else 0)
    if full:
        assert stand_in[0].replays == 2 * full - 1
    assert tmetrics.evaluate_model(eval_student, None, images, labels, **kw) == {
        "val_acc": 100.0 * float(want[1]) / n, "val_acc_top5": 100.0 * float(want[2]) / n,
        "loss": float(want[0]) / n}


def test_eval_graph_cache_keys_and_bound(stand_in, eval_student):
    """The cache is keyed on (a weak reference to the model, the batch's
    shape and dtype, valid_indices, the view's settings, the smoothing):
    another key makes another graph, a known key replays its own; beyond 8
    the least recently used goes."""
    images, labels = _split(16)
    cache = tmetrics._EVAL_GRAPH_CACHE
    tmetrics.evaluate_model(eval_student, None, images, labels, **KW)
    ((ref, key),) = cache
    view = (16, 16 / RAW, (0.5, 0.45, 0.4), (0.25, 0.2, 0.3))
    assert isinstance(ref, weakref.ref) and ref() is eval_student
    assert key == ("eval", (8, RAW, RAW, 3), torch.uint8, None, view, 0.0)
    subsets = [tuple(range(i, i + 5)) for i in range(5)]
    for subset in subsets:  # a subset of 10 classes: labels in 0..4
        tmetrics.evaluate_model(eval_student, None, images, labels % 5,
                                valid_indices=subset, **KW)
    tmetrics.evaluate_model(eval_student, None, images, labels, **{**KW, "batch_size": 4})
    tmetrics.evaluate_model(eval_student, None, images, labels, label_smoothing=0.1, **KW)
    assert len(cache) == 8 and len(stand_in) == 8
    tmetrics.evaluate_model(eval_student, None, images, labels, **KW)  # a hit
    assert len(stand_in) == 8 and list(cache)[-1][1] == key
    tmetrics.evaluate_model(eval_student, None, images, labels, **{**KW, "batch_size": 2})
    assert len(cache) == 8 and len(stand_in) == 9
    assert [k[1][3] for k in cache][0] == subsets[1]  # subsets[0]'s went


def test_eval_graph_refills_its_static_params(stand_in, eval_student):
    """Each call copies its params into the graph's static buffers (the
    same tensors every call: what the graph reads), so a replay at new
    params (as `Trainer.eval_model_params` makes each call) gives the eager
    sums at those params."""
    images, labels = _split(24)
    graph = None
    for scale in (1.0, 0.5, 0.25):
        params = {k: v * scale for k, v in eval_student.named_parameters()}
        got = tmetrics.graph_eval_sums(eval_student, params, images, labels, **KW)
        want = tmetrics.eager_eval_sums(eval_student, params, images, labels, **KW)
        assert torch.equal(got, want)
        ((graph_now),) = tmetrics._EVAL_GRAPH_CACHE.values()
        if graph is None:
            graph, ptrs = graph_now, {k: v.data_ptr() for k, v in graph_now.params.items()}
        assert graph_now is graph
        assert {k: v.data_ptr() for k, v in graph.params.items()} == ptrs
        assert all(torch.equal(graph.params[k], params[k]) for k in params)
    assert len(stand_in) == 1


def test_eval_graphs_do_not_keep_a_model_alive(stand_in):
    """An entry holds only a weak reference to its model: a dropped model
    is collected, and its graphs leave the cache at the next lookup."""
    images, labels = _split(16)
    model, _ = create_student("vit_micro_patch4", num_classes=10, drop_path_rate=0.0,
                              img_size=16, dtype=torch.float32, device=CPU)
    tmetrics.evaluate_model(model, None, images, labels, **KW)
    ref = weakref.ref(model)
    del model
    gc.collect()
    assert ref() is None
    other, _ = create_student("vit_micro_patch4", num_classes=10, drop_path_rate=0.0,
                              img_size=16, dtype=torch.float32, device=CPU)
    tmetrics.evaluate_model(other, None, images, labels, **KW)
    assert [k[0]() for k in tmetrics._EVAL_GRAPH_CACHE] == [other]


def test_measure_efficiency_replays_a_cached_forward(stand_in, eval_student):
    """The graph route times replays of one cached forward of a zero batch
    at the model's own weights: warm-up, capture, then replays only; a
    second measurement replays the same graph."""
    for warmup in (1, 3):
        got = tmetrics.measure_efficiency(eval_student, None, image_size=16, batch_size=4,
                                          num_warmup=warmup, num_batches=5)
        assert got["throughput_img_per_sec"] > 0
    (graph,) = stand_in
    assert graph.replays == (2 - 1 + 5) + (3 + 5)
    ((ref, key),) = tmetrics._EVAL_GRAPH_CACHE
    assert ref() is eval_student and key == ("forward", (4, 16, 16, 3))
    ((static),) = tmetrics._EVAL_GRAPH_CACHE.values()
    assert not static.inputs[0].any()
    assert all(torch.equal(static.params[k], v) for k, v in eval_student.named_parameters())
