"""Data and tensor parallelism (M8) on the CPU: four gloo ranks spawned with
`torch.multiprocessing` (tests/torch_parallel_ranks.py, a `file://`
rendezvous under tmp_path) against the JAX package's mesh step on
conftest's CPU devices and against the port's one-process step, trainer,
evaluation and checkpoints.

The setting is fp32: a depth-2 ViT student (width 64, 4 heads; 3 heads at
width 48 where tp = 2 does not divide them), the vit_mini teacher, 16 px,
global batch 8. Tolerances, each stated where it is used, are those of
the JAX package's own mesh tests (tests/test_parallel.py): losses rtol
2e-4, mixing weights atol 2e-3, temperatures 1e-5, MP ranks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from basd_tpu.losses import init_selector as jax_init_selector
from basd_tpu.models import create_student as jax_create_student
from basd_tpu.models import load_teacher as jax_load_teacher
from basd_tpu.parallel.mesh import batch_sharding, replicated
from basd_tpu.parallel.mesh import create_mesh as jax_create_mesh
from basd_tpu.parallel.sharding_rules import state_sharding, student_param_sharding
from basd_tpu.training.train_step import make_train_step as jax_make_train_step
from basd_tpu_torch.data.pipeline import epoch_batches
from basd_tpu_torch.losses import extraction_points
from basd_tpu_torch.models.convert import vit_state_dict_from_jax
from basd_tpu_torch.ops.mixup import MixDraws, mixup_cutmix
from basd_tpu_torch.parallel.mesh import create_mesh, shard_rows
from basd_tpu_torch.parallel.sharding_rules import (
    attention_split,
    merge_shards,
    shard_tensor,
    split_axis,
)
from basd_tpu_torch.training.train_step import sample_step_draws, shard_step_draws
from test_torch_helpers import flax_params_np

torch.set_num_threads(1)

WORLD = 4
B, IMG, RAW, C = 8, 16, 20, 10
ARCH = {"depth": 2, "num_heads": 4}
ODD_ARCH = {"depth": 2, "embed_dim": 48, "num_heads": 3}
TEACHER_STATS = ((0.5,) * 3, (0.5,) * 3)
DATASET_STATS = ((0.5,) * 3, (0.25,) * 3)
STEP_KW = dict(
    learning_rate=1e-3, weight_decay=0.01, warmup_steps=5, label_smoothing=0.1,
    img_size=IMG, crop_ratio=IMG / RAW, teacher_stats=TEACHER_STATS,
    dataset_stats=DATASET_STATS, num_classes=C,
)
RTOL_LOSS = 2e-4  # tests/test_parallel.py's DP8 / DP4xTP2 against one device
ATOL_WEIGHTS = 2e-3  # its mixing weights
ATOL_TEMPS = 1e-5  # its temperatures
# ||dtheta_a - dtheta_b|| / ||dtheta_b|| for the step's update. ScheduleFree's
# first update is gamma g / (sqrt(v) + eps), about gamma sign(g): it reads
# the gradients' signs, so the near-zero entries whose sign an fp32 sum in
# another order flips move it. Its floor is the same one-process step on
# the batch in reversed order (test_reordering_floor_lies_inside_the_tolerances
# reads it and holds it below half of this).
RTOL_UPDATE = 2e-2
# the selector's gradients, of scale; the same test reads their floor
RTOL_SELECTOR_GRAD = 1e-3


def _delta(after: dict, before: dict) -> np.ndarray:
    return np.concatenate([(after[k].float() - before[k].float()).reshape(-1).numpy()
                           for k in sorted(before)])


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_mesh_step(jt, state, step_fn, images, labels, data, model):
    mesh = jax_create_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    state = jax.device_put(state, state_sharding(mesh, state))
    tvars = jax.device_put(jt.variables, replicated(mesh))
    imgs = jax.device_put(jnp.asarray(images), batch_sharding(mesh))
    labs = jax.device_put(jnp.asarray(labels), batch_sharding(mesh))
    new, m = jax.jit(step_fn)(state, tvars, imgs, labs)
    return {
        "loss": float(m["loss"]), "weights": np.asarray(m["mixing_weights"]),
        "ranks": np.asarray(m["mp_ranks"]),
        "temps_after": np.asarray(jax.nn.softplus(new.selector.log_temperatures)),
        "params": vit_state_dict_from_jax(flax_params_np(new.params)),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(42)
    images = (rng.random((B, RAW, RAW, 3)) * 255).astype(np.uint8)
    labels = rng.integers(0, C, B, dtype=np.int64)
    points = extraction_points(ARCH["depth"], 2)

    # ---- the JAX package: models, selector, initial state ----
    jt = jax_load_teacher("vit_mini_patch4", img_size=IMG, dtype=jnp.float32)
    js, _ = jax_create_student(
        "vit_micro_patch4", num_classes=C, drop_path_rate=0.0, img_size=IMG,
        arch_overrides=ARCH, capture_layers=points, dtype=jnp.float32, remat=False)
    jsel = jax_init_selector(jax.random.PRNGKey(1), len(points), 64, 96)
    _, init_fn, step_fn = jax_make_train_step(js, jt, **STEP_KW, augment=False)
    jstate = init_fn(jax.random.PRNGKey(0), jsel)

    g = np.random.default_rng(7)
    n_s, n_t = 16, 17
    payload = {
        "teacher_preset": "vit_mini_patch4", "student_preset": "vit_micro_patch4",
        "img": IMG, "classes": C, "arch": ARCH, "odd_arch": ODD_ARCH,
        "points": points, "step_kw": STEP_KW, "images": images, "labels": labels,
        "teacher_sd": vit_state_dict_from_jax(flax_params_np(jt.variables["params"])),
        "student_sd": vit_state_dict_from_jax(flax_params_np(jstate.params)),
        "selector": tuple(np.asarray(x) for x in jsel),
        "grad_k": 24,
        "grad_inputs": {
            "student": g.standard_normal((2, B, n_s, 64)).astype(np.float32),
            "teacher": g.standard_normal((6, B, n_t, 96)).astype(np.float32),
            "importance": g.random((6, B, n_t)).astype(np.float32),
            "r_tokens": g.standard_normal((2, B, n_t, 96)).astype(np.float32),
            "r_importance": g.standard_normal((2, B, n_t)).astype(np.float32),
        },
        "eval": {
            # 27 = 3 x 8 + 3: the tail's slices over 4 ranks are 1, 1, 1, 0
            "images": (g.random((27, RAW, RAW, 3)) * 255).astype(np.uint8),
            "labels": g.integers(0, C, 27).astype(np.int64), "batch_size": 8,
            "view": dict(img_size=IMG, crop_ratio=IMG / RAW, mean=DATASET_STATS[0],
                         std=DATASET_STATS[1]),
        },
        "trainer_overrides": ["data.batch_size=16", "training.num_epochs=1",
                              "basd.num_extraction_points=2",
                              "model.arch_overrides={depth: 2, num_heads: 4}"],
    }
    from basd_tpu_torch.data import load_split_arrays

    tr_images, tr_labels = load_split_arrays("synthetic/cifar10-like", "train")
    # 4 steps; an evaluation split of 27 (a tail of 11: slices of 6 and 5)
    payload["trainer_data"] = ((tr_images[:64], tr_labels[:64]),
                               (tr_images[64:91], tr_labels[64:91]))

    # ---- the port in one process ----
    one = {}
    trainer = ranks.make_trainer(payload, work / "one")
    one["history"] = trainer.train(*payload["trainer_data"])
    one["trainer"] = ranks.full_state_tensors(trainer)
    payload["one_process_latest"] = trainer.checkpoints.dir / "latest"
    torch.save(payload, work / "payload.pt")
    ctx = ranks.start(WORLD, work)

    # while the ranks run: the references
    student = ranks.build_student(payload, drop_path=0.1, state_dict=payload["student_sd"])
    one["augment"] = ranks.step_result(*ranks.one_step(payload, student, augment=True))
    one["odd"] = ranks.step_result(*ranks.one_step(
        payload, ranks.build_student(payload, arch=ODD_ARCH), augment=False))
    one["odd_before"] = ranks.build_student(payload, arch=ODD_ARCH).state_dict()
    one["selector_grad"] = ranks.selector_grads(payload)
    # the reordering floor: one process, the batch in reversed order
    rev = np.arange(B)[::-1].copy()
    reversed_payload = {**payload, "images": images[rev], "labels": labels[rev],
                        "grad_inputs": {k: v[:, rev] for k, v in
                                        payload["grad_inputs"].items()}}
    for key, pl in (("plain", payload), ("reversed", reversed_payload)):
        student = ranks.build_student(pl, state_dict=payload["student_sd"])
        one[key] = ranks.step_result(*ranks.one_step(pl, student, augment=False))
    one["selector_grad_reversed"] = ranks.selector_grads(reversed_payload)
    one["reversed_rows"] = rev
    from basd_tpu_torch.evaluation.metrics import evaluate_model

    ev = payload["eval"]
    one["eval"] = evaluate_model(
        ranks.build_student(payload, state_dict=payload["student_sd"]), None,
        ev["images"], ev["labels"], batch_size=ev["batch_size"], **ev["view"])
    jax_out = {
        "jax_dp4": _jax_mesh_step(jt, jstate, step_fn, images, labels, 4, 1),
        "jax_tp22": _jax_mesh_step(jt, jstate, step_fn, images, labels, 2, 2),
    }
    ranks.join(ctx, timeout=150)

    def results(scenario):
        return [torch.load(work / f"result-{scenario}-{r}.pt", weights_only=False)
                for r in range(WORLD)]

    return {"work": work, "payload": payload, "one": one, "jax": jax_out,
            "ranks": results, "jstate": jstate, "js": js}


# ---- the mesh ----


def test_create_mesh_shapes_and_coordinates(world):
    for r, res in enumerate(world["ranks"]("mesh")):
        assert res["dp4"] == ({"data": 4, "model": 1}, r, 0, "gloo")
        assert res["tp22"] == ({"data": 2, "model": 2}, r // 2, r % 2)


def test_invalid_mesh_is_refused_in_the_world(world):
    assert all(res["refused"] for res in world["ranks"]("mesh"))


@pytest.mark.parametrize("data,model", [(4, 1), (3, 2), (2, 2), (-1, 2)])
def test_invalid_mesh_is_refused_in_one_process(data, model):
    with pytest.raises(ValueError, match="processes"):
        create_mesh(data, model)


@pytest.mark.parametrize("n,parts", [(8, 4), (27, 4), (3, 4), (11, 2), (0, 3)])
def test_shard_rows_cover_the_batch_in_order(n, parts):
    bounds = [shard_rows(n, parts, i) for i in range(parts)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


# ---- the sharding rules ----


def test_split_axes_follow_the_jax_specs(world):
    """Each parameter's split axis in the port is the JAX spec's axis through
    the converter's transpose: a flax leaf that varies only along its
    sharded axis becomes a port tensor that varies only along `split_axis`."""
    mesh = jax_create_mesh(data=4, model=2)
    params = world["jstate"].params
    specs = student_param_sharding(mesh, params)

    def marked(leaf, sharding):
        arr = np.zeros(leaf.shape, np.float32)
        axes = [i for i, s in enumerate(sharding.spec) if s == "model"]
        if axes:
            shape = [1] * arr.ndim
            shape[axes[0]] = arr.shape[axes[0]]
            arr = arr + np.arange(arr.shape[axes[0]], dtype=np.float32).reshape(shape)
        return arr

    tree = jax.tree_util.tree_map(marked, params, specs)
    port = vit_state_dict_from_jax(flax_params_np(tree))
    checked = 0
    for name, t in port.items():
        varying = [a for a in range(t.ndim) if t.shape[a] > 1
                   and not torch.equal(t, t.narrow(a, 0, 1).expand_as(t))]
        want = split_axis(name)
        assert varying == ([] if want is None else [want]), (name, varying, want)
        checked += want is not None
    assert checked == 6 * ARCH["depth"]


def test_qkv_splits_by_whole_heads(world):
    """Model rank m holds [q_m | k_m | v_m], the rows of its heads."""
    d, h, tp = 64, 4, 2
    rows = torch.arange(3 * d, dtype=torch.float32)[:, None].expand(3 * d, 5)
    for m in range(tp):
        got = shard_tensor("blocks.0.attn.qkv.weight", rows, tp, m, h)[:, 0]
        want = torch.cat([torch.arange(b * d + m * d // tp, b * d + (m + 1) * d // tp)
                          for b in range(3)]).float()
        assert torch.equal(got, want)
    res = world["ranks"]("mesh")
    full = world["payload"]["student_sd"]["blocks.0.attn.qkv.weight"]
    for r in range(WORLD):
        want = shard_tensor("blocks.0.attn.qkv.weight", full, 2, r % 2, h)
        assert torch.equal(res[r]["local_qkv"], want)


@pytest.mark.parametrize("heads", [4, 3])
def test_merge_inverts_shard(heads):
    g = torch.Generator().manual_seed(heads)
    d = 16 * heads
    shapes = {"blocks.0.attn.qkv.weight": (3 * d, d), "blocks.0.attn.qkv.bias": (3 * d,),
              "blocks.0.attn.proj.weight": (d, d), "blocks.0.mlp.fc1.weight": (4 * d, d),
              "blocks.0.mlp.fc1.bias": (4 * d,), "blocks.0.mlp.fc2.weight": (d, 4 * d),
              "blocks.0.mlp.fc2.bias": (d,), "pos_embed": (1, 5, d)}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=g)
        shards = [shard_tensor(name, t, 2, m, heads) for m in range(2)]
        assert torch.equal(merge_shards(name, shards, heads), t), name
        axis = split_axis(name, attention_split(heads, 2))
        if axis is not None:
            assert shards[0].shape[axis] * 2 == t.shape[axis], name


@pytest.mark.parametrize("what", ["roundtrip_exact", "odd_roundtrip_exact",
                                  "opt_roundtrip_exact"])
def test_gather_of_shard_is_exact(world, what):
    assert all(res[what] for res in world["ranks"]("mesh"))


# ---- the step over the mesh against the JAX package's mesh step ----


@pytest.mark.parametrize("mesh", ["jax_dp4", "jax_tp22"])
def test_step_matches_the_jax_mesh_step(world, mesh):
    """data=4 and data=2 x model=2 steps (augment=False) on the JAX
    package's weights, selector and batch against its own mesh step."""
    want = world["jax"][mesh]
    before = world["payload"]["student_sd"]
    for res in world["ranks"](mesh):
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=RTOL_LOSS)
        np.testing.assert_allclose(res["weights"], want["weights"], atol=ATOL_WEIGHTS)
        np.testing.assert_array_equal(res["ranks"], want["ranks"])
        np.testing.assert_allclose(res["temps_after"], want["temps_after"],
                                   atol=ATOL_TEMPS)
        rel = _rel(_delta(res["params"], before), _delta(want["params"], before))
        assert rel <= RTOL_UPDATE, rel


@pytest.mark.parametrize("scenario", ["jax_dp4", "jax_tp22", "augment_dp4", "odd_tp22"])
def test_data_replicas_are_bit_identical(world, scenario):
    """After a step every data replica's parameters (its shards under TP)
    are the same bits, and every rank's generator holds the same state."""
    res = world["ranks"](scenario)
    model = 2 if scenario.endswith("tp22") else 1
    for r in range(model, WORLD):
        ref = res[r % model]["local_params"]
        assert all(torch.equal(res[r]["local_params"][k], ref[k]) for k in ref)
        assert torch.equal(res[r]["generator"], res[0]["generator"])
        assert torch.equal(res[r]["params"]["head.weight"], res[0]["params"]["head.weight"])


# ---- the step over the mesh against the port's one-process step ----


@pytest.mark.parametrize("scenario,ref", [("augment_dp4", "augment"), ("odd_tp22", "odd")])
def test_step_matches_the_one_process_step(world, scenario, ref):
    """augment_dp4: augment=True with drop path 0.1 from one generator seed
    (the global draws, mixup's neighbour across the shard boundaries);
    odd_tp22: 3 heads at tp = 2, the attention whole and the MLP split."""
    want = world["one"][ref]
    before = (world["one"]["odd_before"] if ref == "odd"
              else world["payload"]["student_sd"])
    for res in world["ranks"](scenario):
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=RTOL_LOSS)
        np.testing.assert_allclose(res["acc"], want["acc"], rtol=0, atol=0)
        np.testing.assert_allclose(res["weights"], want["weights"], atol=ATOL_WEIGHTS)
        np.testing.assert_array_equal(res["ranks"], want["ranks"])
        np.testing.assert_allclose(res["temps_after"], want["temps_after"],
                                   atol=ATOL_TEMPS)
        rel = _rel(_delta(res["params"], before), _delta(want["params"], before))
        assert rel <= RTOL_UPDATE, rel
        assert torch.equal(res["generator"], want["generator"])


def test_selector_gradient_through_the_data_sum(world):
    """The data-group sum's backward: each rank's gradient of its share of a
    function of `select_and_mix` equals the one-process gradient's rows,
    the mixing weights agree within 1e-5, and the log-temperature
    gradients sum to the one-process one
    (RTOL_SELECTOR_GRAD of scale: the Grams are summed in another order)."""
    want = world["one"]["selector_grad"]
    res = world["ranks"]("selector_grad")
    got = torch.cat([r["student"] for r in res], dim=1)
    scale = want["student"].abs().max()
    assert (got - want["student"]).abs().max() <= RTOL_SELECTOR_GRAD * scale
    log_t = sum(r["log_t"] for r in res)
    assert (log_t - want["log_t"]).abs().max() <= \
        RTOL_SELECTOR_GRAD * want["log_t"].abs().max()
    for r in res:
        np.testing.assert_allclose(r["weights"], want["weights"], atol=1e-5)


def test_reordering_floor_lies_inside_the_tolerances(world):
    """Summing in another order moves the results by a floor the mesh
    cannot beat: the one-process step and selector on the batch in reversed
    order. Each tolerance above holds that floor with a margin of 2 or more
    (the floor is printed)."""
    one, rev = world["one"], world["one"]["reversed_rows"]
    before = world["payload"]["student_sd"]
    update = _rel(_delta(one["reversed"]["params"], before),
                  _delta(one["plain"]["params"], before))
    want, got = one["selector_grad"], one["selector_grad_reversed"]
    tokens = float((got["student"][:, rev] - want["student"]).abs().max()
                   / want["student"].abs().max())
    log_t = float((got["log_t"] - want["log_t"]).abs().max() / want["log_t"].abs().max())
    print(f"reordering floor: update {update:.3g}, selector gradients {tokens:.3g} "
          f"(tokens) {log_t:.3g} (log-temperatures)")
    assert 0 < update <= RTOL_UPDATE / 2
    assert max(tokens, log_t) <= RTOL_SELECTOR_GRAD / 2
    np.testing.assert_allclose(one["reversed"]["loss"], one["plain"]["loss"],
                               rtol=RTOL_LOSS)


def test_batch_draws_shard_by_rows():
    g = torch.Generator().manual_seed(3)
    draws = sample_step_draws(g, 8)
    part = shard_step_draws(draws, 2, 2)
    assert torch.equal(part.view.crop.area_frac, draws.view.crop.area_frac[2:4])
    assert torch.equal(part.view.flip, draws.view.flip[2:4])
    assert torch.equal(part.view.augment.op, draws.view.augment.op[2:4])
    assert part.mix is draws.mix


@pytest.mark.parametrize("cutmix", [False, True])
def test_mixup_neighbour_continues_the_roll(cutmix):
    """A slice mixed with its neighbour (the sample before it, the last one
    for the first slice) is the slice of the whole batch mixed."""
    g = torch.Generator().manual_seed(1)
    images = torch.rand((8, 6, 6, 3), generator=g)
    labels = torch.randint(0, C, (8,), generator=g)
    draws = MixDraws(torch.tensor(cutmix), torch.tensor(0.37), torch.tensor(0.4),
                     torch.tensor(0.6))
    full_imgs, full_t = mixup_cutmix(images, labels, draws, num_classes=C)
    for lo in (0, 2, 4, 6):
        prev = (lo - 1) % 8
        nb = (images[prev], torch.nn.functional.one_hot(labels[prev], C).float())
        imgs, t = mixup_cutmix(images[lo:lo + 2], labels[lo:lo + 2], draws,
                               num_classes=C, neighbour=nb)
        assert torch.equal(imgs, full_imgs[lo:lo + 2])
        assert torch.equal(t, full_t[lo:lo + 2])


def test_epoch_batches_shard_the_same_order():
    images = np.arange(40).reshape(20, 2)
    labels = np.arange(20)
    whole = list(epoch_batches(images, labels, 6, np.random.default_rng(5)))
    parts = [list(epoch_batches(images, labels, 6, np.random.default_rng(5),
                                shard=(i, 4))) for i in range(4)]
    for b, (imgs, labs) in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[b][1] for p in parts]), labs)
        np.testing.assert_array_equal(np.concatenate([p[b][0] for p in parts]), imgs)


# ---- evaluation, the trainer and checkpoints ----


def test_sharded_eval_with_an_uneven_tail(world):
    """27 images at batch 8 over data=4 (the tail's slices 1, 1, 1, 0):
    top-1 and top-5 equal to one process, the loss within 1e-6 relative
    (fp32 sums in another order)."""
    want = world["one"]["eval"]
    for res in world["ranks"]("eval_dp4"):
        assert res["val_acc"] == want["val_acc"]
        assert res["val_acc_top5"] == want["val_acc_top5"]
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-6)


def test_trainer_epoch_at_data2_model2_matches_one_process(world):
    """One epoch of 4 steps over data=2 x model=2, with evaluation (an
    uneven tail) and the saves: the epoch's train loss within the trainer
    test's 5e-4, the same accuracies, the state's update close."""
    want = world["one"]
    for res in world["ranks"]("trainer_tp22"):
        np.testing.assert_allclose(res["history"]["train_loss"],
                                   want["history"]["train_loss"], rtol=5e-4)
        assert res["history"]["val_acc"] == want["history"]["val_acc"]
        assert res["history"]["train_acc"] == want["history"]["train_acc"]
        np.testing.assert_allclose(res["history"]["loss"], want["history"]["loss"],
                                   rtol=5e-4)
        st, ref = res["state"], want["trainer"]
        assert set(st) == set(ref)
        assert torch.equal(st["generator"], ref["generator"])
        assert int(st["step"]) == int(ref["step"]) == 4
        before = world["payload"]["student_sd"]
        got = _delta({k[6:]: v for k, v in st.items() if k.startswith("param ")}, before)
        exp = _delta({k[6:]: v for k, v in ref.items() if k.startswith("param ")}, before)
        assert _rel(got, exp) <= RTOL_UPDATE


def test_tp_checkpoint_restores_into_one_process(world):
    """`latest` written by the 2 x 2 run restores into a one-process
    trainer bit for bit: every parameter, z, v, the log-temperatures, the
    generator and the step equal the 2 x 2 state gathered."""
    want = world["ranks"]("trainer_tp22")[0]["state"]
    fresh = ranks.make_trainer(world["payload"], world["work"] / "fresh")
    fresh.load_checkpoint(str(world["work"] / "tp22" / "basd_smoke" / "checkpoints"
                              / "latest"))
    got = ranks.full_state_tensors(fresh)
    assert set(got) == set(want)
    assert [k for k in want if not torch.equal(got[k], want[k])] == []


def test_one_process_checkpoint_restores_into_tp(world):
    """... and the one-process trainer's `latest` restores into a 2 x 2
    trainer bit for bit (its shards gathered)."""
    want = world["one"]["trainer"]
    for res in world["ranks"]("restore_tp22"):
        got = res["state"]
        assert set(got) == set(want)
        assert [k for k in want if not torch.equal(got[k], want[k])] == []
