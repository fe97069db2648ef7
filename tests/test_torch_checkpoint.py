"""The port's checkpoints (M7): the full training state saved asynchronously
and restored bit for bit, the atomic replace of a checkpoint, the strict
weights-only `.npz` exports; and the weight-file loaders of
`models/convert.py` against the JAX package's on state dicts the tests
build (`.npz`, `.pth`, a `.stats.json` sidecar). Exact equality
throughout."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.models import load_teacher as jax_load_teacher
from basd_tpu.models.convert import interpolate_vit_pos_embed as jax_interpolate
from basd_tpu.models.convert import load_checkpoint_stats as jax_checkpoint_stats
from basd_tpu_torch.checkpoint import CheckpointManager
from basd_tpu_torch.checkpoint import manager as tmanager
from basd_tpu_torch.losses import extraction_points, init_selector
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.models.convert import (
    convnext_state_dict_from_jax,
    export_teacher_npz,
    interpolate_vit_pos_embed,
    load_checkpoint_stats,
    load_converted_weights,
    resnet_state_dict_from_jax,
    vit_state_dict_from_jax,
)
from basd_tpu_torch.training.train_step import make_train_step
from test_torch_helpers import CPU, flax_params_np

torch.set_num_threads(1)

IMG, RAW, C, B = 16, 20, 10, 4
STATS = ((0.5,) * 3, (0.25,) * 3)


def _state(seed=0):
    """A small TrainState after one augmented step (z, v and the
    generator off their initial values)."""
    teacher = load_teacher("vit_mini_patch4", img_size=IMG, dtype=torch.float32,
                           device=CPU)
    points = extraction_points(4, 2)
    student, cfg = create_student(
        "vit_micro_patch4", num_classes=C, drop_path_rate=0.1, img_size=IMG,
        capture_layers=points, dtype=torch.float32, device=CPU, seed=seed,
    )
    selector = init_selector(seed + 1, len(points), cfg.embed_dim,
                             teacher.spec.embed_dim, device=CPU)
    init_fn, step_fn = make_train_step(
        student, teacher, learning_rate=1e-3, weight_decay=0.05, warmup_steps=5,
        label_smoothing=0.1, img_size=IMG, crop_ratio=IMG / RAW,
        teacher_stats=STATS, dataset_stats=STATS, num_classes=C,
    )
    state = init_fn(seed, selector)
    rng = np.random.default_rng(seed)
    images = torch.from_numpy((rng.random((B, RAW, RAW, 3)) * 255).astype(np.uint8))
    labels = torch.from_numpy(rng.integers(0, C, B))
    state, _ = step_fn(state, images, labels)
    return state, step_fn, images, labels


def _tensors(state):
    out = {f"student.{k}": v.clone() for k, v in state.student.state_dict().items()}
    for i, p in enumerate(state.optimizer.param_groups[0]["params"]):
        out[f"z.{i}"] = state.optimizer.state[p]["z"].clone()
        out[f"v.{i}"] = state.optimizer.state[p]["exp_avg_sq"].clone()
    for name in ("log_temperatures", "proj_s", "proj_t"):
        out[name] = getattr(state.selector, name).detach().clone()
    out["generator"] = state.generator.get_state()
    return out


def test_state_round_trips_bit_for_bit(tmp_path):
    state, step_fn, images, labels = _state()
    saved = _tensors(state)
    group = dict(state.optimizer.param_groups[0])
    m = CheckpointManager(tmp_path)
    m.save_state("latest", state, epoch=2, best_val_acc=12.5,
                 metrics_history={"val_acc": [1.0, 12.5]}, step_in_epoch=3,
                 epoch_sums={"losses": [0.5, 0.25], "accs": [0.0, 1.0]})
    m.wait()
    # move every part of the live state on, then restore it
    step_fn(state, images, labels)
    assert state.step == 2
    restored, custom = m.restore_state("latest", state)
    assert restored is state and state.step == 1
    got = _tensors(state)
    assert saved.keys() == got.keys()
    for key in saved:
        assert torch.equal(saved[key], got[key]), key
    for key in ("step", "weight_sum", "lr"):
        assert state.optimizer.param_groups[0][key] == group[key]
    assert custom == {"epoch": 2, "best_val_acc": 12.5,
                      "metrics_history": {"val_acc": [1.0, 12.5]}, "step_in_epoch": 3,
                      "epoch_sums": {"losses": [0.5, 0.25], "accs": [0.0, 1.0]}}
    assert len(m.blocked_ms) == 1 and m.blocked_ms[0] > 0


def test_a_restored_state_steps_as_the_live_one(tmp_path):
    """Restored into a FRESH state (other seeds), the next step gives the
    live state's next step bit for bit (generator included)."""
    live, step_fn, images, labels = _state(seed=0)
    m = CheckpointManager(tmp_path)
    m.save_state("s", live, epoch=0, best_val_acc=0.0, metrics_history={},
                 block=True)
    fresh, fresh_step, _, _ = _state(seed=5)
    m.restore_state("s", fresh)
    _, want = step_fn(live, images, labels)
    _, got = fresh_step(fresh, images, labels)
    assert torch.equal(want["loss"], got["loss"])
    for key, value in _tensors(live).items():
        assert torch.equal(value, _tensors(fresh)[key]), key


def test_saving_over_a_checkpoint_replaces_it_whole(tmp_path):
    state, *_ = _state()
    m = CheckpointManager(tmp_path)
    for epoch in range(3):
        m.save_state("latest", state, epoch=epoch, best_val_acc=0.0,
                     metrics_history={})
    m.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["latest"]
    assert json.loads((tmp_path / "latest" / "custom.json").read_text())["epoch"] == 2


def test_restore_finds_a_checkpoint_renamed_aside(tmp_path):
    """A save stopped between its two renames leaves `.name.old`."""
    state, *_ = _state()
    m = CheckpointManager(tmp_path)
    m.save_state("latest", state, epoch=4, best_val_acc=0.0, metrics_history={},
                 block=True)
    (tmp_path / "latest").rename(tmp_path / ".latest.old")
    _, custom = m.restore_state("latest", state)
    assert custom["epoch"] == 4
    with pytest.raises(FileNotFoundError):
        m.restore_state("missing", state)


def test_a_failed_write_raises_at_the_next_wait(tmp_path, monkeypatch):
    state, *_ = _state()
    m = CheckpointManager(tmp_path)

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tmanager.torch, "save", broken)
    m.save_state("latest", state, epoch=0, best_val_acc=0.0, metrics_history={})
    with pytest.raises(OSError, match="disk full"):
        m.wait()


def _weights(tmp_path, sd, epoch=3):
    m = CheckpointManager(tmp_path)
    return m, m.save_weights("w.npz", sd, epoch)


def test_weights_round_trip_with_the_ports_keys(tmp_path):
    student, _ = create_student("vit_micro_patch4", num_classes=C, drop_path_rate=0.0,
                                img_size=IMG, dtype=torch.float32, device=CPU)
    sd = student.state_dict()
    m, path = _weights(tmp_path, sd)
    with np.load(path) as z:
        assert sorted(z.files) == sorted([*sd, "__epoch__"])
    loaded, epoch = m.load_weights(path, sd)
    assert epoch == 3 and all(torch.equal(loaded[k], sd[k]) for k in sd)


@pytest.mark.parametrize("case", ["extra", "missing", "shape"])
def test_weights_load_is_strict(tmp_path, case):
    small = {f"block{i}.w": torch.ones(2, 2) for i in range(4)}
    big = {f"block{i}.w": torch.ones(2, 2) for i in range(6)}
    saved, template, match = {
        "extra": (big, small, "architecture mismatch"),
        "missing": (small, big, "missing parameter"),
        "shape": (small, {**small, "block0.w": torch.ones(3, 2)}, "shape"),
    }[case]
    m, path = _weights(tmp_path, saved)
    with pytest.raises(ValueError, match=match):
        m.load_weights(path, template)


# ---- weight files: the port's loaders against the JAX package's ----


def _vit_file_state(seed=0, teacher="dinov2_micro_patch4", img=IMG):
    """A timm/DINOv2-keyed state dict of random values (a ViT teacher's
    module state dict, every value moved off its initial one)."""
    t = load_teacher(teacher, img_size=img, dtype=torch.float32, device=CPU)
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g) for k, v in t.module.state_dict().items()}


def _jax_sd(jax_teacher):
    return vit_state_dict_from_jax(flax_params_np(jax_teacher.variables["params"]))


def _port_sd(teacher):
    return teacher.module.state_dict()


def _assert_sd_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].float(), want[k].float()), k


@pytest.mark.parametrize("form", ["npz", "pth", "pth_bundle", "sidecar"])
def test_vit_weight_files_load_as_in_the_jax_package(tmp_path, form):
    sd = _vit_file_state()
    sd["mask_token"] = torch.zeros(1, sd["cls_token"].shape[-1])  # never read
    mean, std = (0.1, 0.2, 0.3), (0.4, 0.5, 0.6)
    if form == "npz":
        path = tmp_path / "w.npz"
        export_teacher_npz(path, sd, mean=mean, std=std)
    else:
        path = tmp_path / "w.pth"
        obj = ({"model_state_dict": sd, "pretrained_cfg": {"mean": mean, "std": std}}
               if form == "pth_bundle" else sd)
        torch.save(obj, path)
        if form == "sidecar":
            (tmp_path / "w.pth.stats.json").write_text(json.dumps({"mean": mean, "std": std}))
    want_stats = None if form == "pth" else (mean, std)
    assert load_checkpoint_stats(path) == jax_checkpoint_stats(path) == want_stats

    jt = jax_load_teacher("dinov2_micro_patch4", img_size=IMG, dtype=jnp.float32,
                          weights_path=str(path))
    tt = load_teacher("dinov2_micro_patch4", img_size=IMG, dtype=torch.float32,
                      device=CPU, weights_path=str(path))
    _assert_sd_equal(_port_sd(tt), _jax_sd(jt))
    _assert_sd_equal(_port_sd(tt), {k: v for k, v in sd.items() if k != "mask_token"})
    assert (tt.mean, tt.std) == (jt.mean, jt.std)


def test_pos_embed_of_another_grid_is_resampled_as_in_the_jax_package(tmp_path):
    """A 7 x 7 grid (+ CLS) loaded into a 4 x 4 teacher (16 px, patch 4)."""
    sd = _vit_file_state()
    d = sd["pos_embed"].shape[-1]
    sd["pos_embed"] = torch.randn(1, 50, d, generator=torch.Generator().manual_seed(3))
    path = tmp_path / "w.npz"
    export_teacher_npz(path, sd)
    got = interpolate_vit_pos_embed(sd["pos_embed"].numpy(), 17)
    assert np.array_equal(got, jax_interpolate(sd["pos_embed"].numpy(), 17))
    jt = jax_load_teacher("dinov2_micro_patch4", img_size=IMG, dtype=jnp.float32,
                          weights_path=str(path))
    tt = load_teacher("dinov2_micro_patch4", img_size=IMG, dtype=torch.float32,
                      device=CPU, weights_path=str(path))
    _assert_sd_equal(_port_sd(tt), _jax_sd(jt))
    assert np.array_equal(tt.module.pos_embed.detach().numpy(), got)


@pytest.mark.parametrize("case", ["unread", "unfilled"])
def test_strict_load_raises_where_the_jax_package_raises(tmp_path, case):
    sd = _vit_file_state()
    if case == "unread":
        sd["register_tokens"] = torch.zeros(1, 4, sd["cls_token"].shape[-1])
    else:
        del sd["blocks.0.ls1.gamma"]
    path = tmp_path / "w.npz"
    export_teacher_npz(path, sd)
    with pytest.raises(ValueError, match="strict"):
        jax_load_teacher("dinov2_micro_patch4", img_size=IMG, dtype=jnp.float32,
                         weights_path=str(path))
    with pytest.raises(ValueError, match="strict"):
        load_teacher("dinov2_micro_patch4", img_size=IMG, dtype=torch.float32,
                     device=CPU, weights_path=str(path))


def test_older_layer_scale_names_load(tmp_path):
    sd = _vit_file_state()
    for i in range(4):
        sd[f"blocks.{i}.gamma_1"] = sd.pop(f"blocks.{i}.ls1.gamma")
        sd[f"blocks.{i}.gamma_2"] = sd.pop(f"blocks.{i}.ls2.gamma")
    path = tmp_path / "w.pth"
    torch.save(sd, path)
    jt = jax_load_teacher("dinov2_micro_patch4", img_size=IMG, dtype=jnp.float32,
                          weights_path=str(path))
    tt = load_teacher("dinov2_micro_patch4", img_size=IMG, dtype=torch.float32,
                      device=CPU, weights_path=str(path))
    _assert_sd_equal(_port_sd(tt), _jax_sd(jt))


@pytest.mark.parametrize("name,convert", [
    ("resnet_micro", resnet_state_dict_from_jax),
    ("convnextv2_micro", convnext_state_dict_from_jax),
])
def test_cnn_weight_files_load_as_in_the_jax_package(tmp_path, name, convert):
    """torchvision/timm-keyed CNN files, a classifier head in the file (not
    loaded into a feature extractor) and a (1, 1, 1, C) GRN weight."""
    t = load_teacher(name, img_size=32, dtype=torch.float32, device=CPU)
    g = torch.Generator().manual_seed(1)
    sd = {k: torch.rand(v.shape, generator=g) + 0.5 for k, v in t.module.state_dict().items()}
    head_dim = [v for k, v in sd.items() if k.endswith("bias")][-1].shape[0]
    head = "fc" if name.startswith("resnet") else "head.fc"
    sd[f"{head}.weight"] = torch.zeros(7, head_dim)
    sd[f"{head}.bias"] = torch.zeros(7)
    grn = [k for k in sd if k.endswith("mlp.grn.weight")]
    for k in grn:
        sd[k] = sd[k].reshape(1, 1, 1, -1)
    path = tmp_path / "w.npz"
    export_teacher_npz(path, sd)
    jt = jax_load_teacher(name, img_size=32, dtype=jnp.float32, weights_path=str(path))
    tt = load_teacher(name, img_size=32, dtype=torch.float32, device=CPU,
                      weights_path=str(path))
    want = convert(jax.tree_util.tree_map(np.asarray, jt.variables))
    _assert_sd_equal(_port_sd(tt), want)


def test_load_converted_weights_into_a_student(tmp_path):
    student, _ = create_student("vit_micro_patch4", num_classes=C, drop_path_rate=0.0,
                                img_size=IMG, dtype=torch.float32, device=CPU, seed=1)
    other, _ = create_student("vit_micro_patch4", num_classes=C, drop_path_rate=0.0,
                              img_size=IMG, dtype=torch.float32, device=CPU, seed=2)
    path = tmp_path / "s.pth"
    torch.save(other.state_dict(), path)
    load_converted_weights(path, student)
    _assert_sd_equal(student.state_dict(), other.state_dict())
