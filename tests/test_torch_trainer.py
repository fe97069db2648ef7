"""The trainer and the entry points (M7): one epoch of the port's `Trainer`
against the JAX package's on `basd_smoke` (vit_micro student, vit_mini
teacher, 16 px, batch 16, fp32 on the CPU, 8 steps), with weights and
selector carried across and each step's augmentation draws replayed from
the JAX state's key; the port's kill-and-resume, bit for bit; and
`train.main` / `evaluate.main` on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.config import compose_config as jax_compose_config
from basd_tpu.config import load_config as jax_load_config
from basd_tpu.data import load_split_arrays as jax_load_split_arrays
from basd_tpu.losses import extraction_points as jax_extraction_points
from basd_tpu.models import create_student as jax_create_student
from basd_tpu.models import load_teacher as jax_load_teacher
from basd_tpu.training.trainer import Trainer as JaxTrainer
from basd_tpu_torch import evaluate as tevaluate
from basd_tpu_torch import train as ttrain_entry
from basd_tpu_torch.config import compose_config
from basd_tpu_torch.data import load_split_arrays
from basd_tpu_torch.losses import extraction_points
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.training import train_step as ttrain
from basd_tpu_torch.training.trainer import Trainer
from test_torch_helpers import CPU, carry_vit, jax_step_draws

torch.set_num_threads(1)

B = 16
TEACHER_STATS = ((0.5,) * 3, (0.5,) * 3)
DATASET_STATS = ((0.5,) * 3, (0.25,) * 3)
RTOL_LOSS = 5e-4  # per-epoch train_loss (the augment=True slice test's)


def _overrides(tmp_path, save_every=None):
    out = [f"run.output_dir={tmp_path}", f"data.batch_size={B}",
           "training.num_epochs=1"]
    if save_every:
        out.append(f"checkpoint.save_every_steps={save_every}")
    return ["experiment=basd_smoke", *out]


def _data():
    images, labels = load_split_arrays("synthetic/cifar10-like", "train")
    return (images[:128], labels[:128]), (images[128:160], labels[128:160])


def _port_trainer(tmp_path, save_every=None, *, teacher=None, student_params=None):
    """The port's Trainer as tests/test_integration.py builds the JAX one."""
    config = compose_config(_overrides(tmp_path, save_every))
    if teacher is None:
        teacher = load_teacher("vit_mini_patch4", img_size=16,
                               dtype=torch.float32, device=CPU)
    points = extraction_points(4, config.basd.num_extraction_points)
    student, cfg = create_student(
        "vit_micro_patch4", num_classes=10, drop_path_rate=0.0, img_size=16,
        capture_layers=points, dtype=torch.float32, remat=False, device=CPU,
    )
    if student_params is not None:
        carry_vit(student_params, student)
    return Trainer(config, student=student, student_cfg=cfg, teacher=teacher,
                   teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    train, val = _data()

    # ---- JAX package: its Trainer, every step's draws recorded ----
    config = jax_compose_config(_overrides(tmp / "jax"))
    jt = jax_load_teacher("vit_mini_patch4", img_size=16, dtype=jnp.float32)
    points = jax_extraction_points(4, config.basd.num_extraction_points)
    js, jcfg = jax_create_student(
        "vit_micro_patch4", num_classes=10, drop_path_rate=0.0, img_size=16,
        capture_layers=points, dtype=jnp.float32, remat=False,
    )
    jtrainer = JaxTrainer(config, student_module=js, student_cfg=jcfg, teacher=jt,
                          teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS,
                          mesh=None)
    params0 = jax.tree_util.tree_map(np.asarray, jtrainer.state.params)
    selector = jtrainer.state.selector
    proj_s, proj_t = np.asarray(selector.proj_s), np.asarray(selector.proj_t)
    draws, jranks = [], []
    real_step = jtrainer._step

    def recording_step(state, teacher_vars, imgs, labs):
        draws.append(jax_step_draws(state.rng, imgs.shape[0]))
        state, metrics = real_step(state, teacher_vars, imgs, labs)
        jranks.append(np.asarray(metrics["mp_ranks"]))
        return state, metrics

    jtrainer._step = recording_step
    jhistory = jtrainer.train(train, val)

    # ---- the port: same weights, selector, batches and draws ----
    tt = load_teacher("vit_mini_patch4", img_size=16, dtype=torch.float32, device=CPU)
    carry_vit(jt.variables["params"], tt.module)
    trainer = _port_trainer(tmp / "port", teacher=tt, student_params=params0)
    with torch.no_grad():
        trainer.state.selector.proj_s.copy_(torch.from_numpy(proj_s.copy()))
        trainer.state.selector.proj_t.copy_(torch.from_numpy(proj_t.copy()))
    tranks = []
    port_step = trainer._step

    def port_recording_step(state, imgs, labs):
        state, metrics = port_step(state, imgs, labs)
        tranks.append(metrics["mp_ranks"].numpy())
        return state, metrics

    trainer._step = port_recording_step
    replay = iter(draws)
    mp = pytest.MonkeyPatch()
    mp.setattr(ttrain, "sample_step_draws", lambda generator, batch: next(replay))
    try:
        thistory = trainer.train(train, val)
    finally:
        mp.undo()
    return jhistory, thistory, jranks, tranks, trainer


def test_epoch_metrics_match_the_jax_trainer(parity):
    jhistory, thistory, _, _, _ = parity
    np.testing.assert_allclose(thistory["train_loss"], jhistory["train_loss"],
                               rtol=RTOL_LOSS)
    assert thistory["val_acc"] == jhistory["val_acc"]
    assert thistory["val_acc_top5"] == jhistory["val_acc_top5"]
    np.testing.assert_allclose(thistory["loss"], jhistory["loss"], rtol=1e-3)


def test_every_step_has_the_jax_trainers_mp_ranks(parity):
    _, _, jranks, tranks, trainer = parity
    assert len(tranks) == len(jranks) == 8 == trainer.state.step
    np.testing.assert_array_equal(np.stack(tranks), np.stack(jranks))


def test_trainer_writes_checkpoints_and_step_times(parity):
    trainer = parity[-1]
    ckpt = trainer.checkpoints.dir
    for name in ("latest", "best_model"):
        assert (ckpt / name / "state.pt").exists()
        assert (ckpt / name / "custom.json").exists()
    assert (ckpt / "final_model.npz").exists() and (ckpt / "best_model.npz").exists()
    assert len(trainer.step_ms) == 8 and min(trainer.step_ms) > 0


def test_evaluation_leaves_the_y_point_untouched(parity):
    """The x-point is evaluated through functional_call: y stays bit for bit."""
    trainer = parity[-1]
    before = {k: v.clone() for k, v in trainer.state.student.state_dict().items()}
    images, labels = _data()[1]
    trainer.evaluate(images, labels)
    after = trainer.state.student.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    x = trainer.eval_model_params()
    assert any(not torch.equal(x[k], before[k]) for k in before)


def _state_tensors(trainer):
    st = trainer.state
    out = {f"student.{k}": v for k, v in st.student.state_dict().items()}
    for i, p in enumerate(st.optimizer.param_groups[0]["params"]):
        out[f"z.{i}"] = st.optimizer.state[p]["z"]
        out[f"v.{i}"] = st.optimizer.state[p]["exp_avg_sq"]
    out["log_t"] = st.selector.log_temperatures
    out["generator"] = st.generator.get_state()
    return out


def test_kill_and_resume_is_bit_exact(tmp_path):
    """A job killed after 5 steps resumes from the step-3 checkpoint and
    reproduces the uninterrupted run's metrics, parameters, optimizer state
    and generator bit for bit (the port's own augmentation draws)."""
    train, val = _data()
    clean = _port_trainer(tmp_path / "clean")
    clean_history = clean.train(train, val)

    killed = _port_trainer(tmp_path / "kill", save_every=3)
    real_step = killed._step
    calls = {"n": 0}

    def dying_step(*args):
        if calls["n"] == 5:
            raise RuntimeError("simulated preemption")
        calls["n"] += 1
        return real_step(*args)

    killed._step = dying_step
    with pytest.raises(RuntimeError, match="preemption"):
        killed.train(train, val)
    killed.checkpoints.wait()

    resumed = _port_trainer(tmp_path / "kill", save_every=3)
    start = resumed.load_checkpoint("latest")
    assert start == 0 and resumed._resume_batch == 3 and resumed.state.step == 3
    resumed_history = resumed.train(train, val, start_epoch=start)

    assert resumed_history == clean_history
    want, got = _state_tensors(clean), _state_tensors(resumed)
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(want[key], got[key]), key
    assert resumed.state.step == clean.state.step == 8


def test_restore_into_a_fresh_trainer_equals_the_live_state(parity, tmp_path):
    trainer = parity[-1]
    fresh = _port_trainer(tmp_path)
    fresh.checkpoints = trainer.checkpoints
    assert fresh.load_checkpoint("latest") == 1
    want, got = _state_tensors(trainer), _state_tensors(fresh)
    for key in want:
        assert torch.equal(want[key], got[key]), key
    assert fresh.state.step == trainer.state.step
    assert fresh.best_val_acc == trainer.best_val_acc


def test_train_and_evaluate_entry_points(tmp_path):
    """`train.main` on basd_smoke (128 train images, one epoch) writes the
    JAX run's files; the snapshot carries the derived depth and loads in
    the JAX package; `evaluate.main` from it reproduces the primary
    numbers."""
    argv = ["experiment=basd_smoke", f"run.output_dir={tmp_path}",
            "data.dataset=synthetic/cifar10-like-128n",
            "evaluation.efficiency_batches=2"]
    results, trainer = ttrain_entry.main(argv, device="cpu")
    out = tmp_path / "basd_smoke"
    assert set(results) == {"run", "primary", "robustness", "efficiency"}
    assert set(results["primary"]) == {"dataset", "val_acc", "val_acc_top5", "loss"}
    assert set(results["efficiency"]) == {
        "param_count", "param_count_m", "gflops", "throughput_img_per_sec"}
    assert json.loads((out / "metrics.json").read_text()) == results
    assert (out / "checkpoints" / "latest").is_dir()
    assert (out / "checkpoints" / "final_model.npz").exists()
    snap = jax_load_config(out / "config.yaml")
    assert snap.model.arch_overrides["depth"] == 6  # the teacher's depth
    assert trainer.state.student.config.depth == 6

    eval_results = tevaluate.main(
        [f"config={out / 'config.yaml'}",
         f"checkpoint.path={out / 'checkpoints' / 'final_model.npz'}",
         f"run.output_dir={tmp_path / 'eval'}"], device="cpu")
    assert eval_results["primary"] == results["primary"]
    assert (tmp_path / "eval" / "basd_smoke" / "metrics.json").exists()


def test_entry_points_refuse_a_mesh_beyond_one_device(tmp_path):
    for ov in ("hardware.mesh.model=2", "hardware.mesh.data=4"):
        with pytest.raises(ValueError, match="one device"):
            ttrain_entry.main(["experiment=basd_smoke", f"run.output_dir={tmp_path}",
                               ov], device="cpu")


def test_the_split_the_port_trains_on_is_the_jax_packages():
    (images, labels), _ = _data()
    jimages, jlabels = jax_load_split_arrays("synthetic/cifar10-like", "train")
    assert images.tobytes() == jimages[:128].tobytes()
    assert labels.tobytes() == jlabels[:128].tobytes()
