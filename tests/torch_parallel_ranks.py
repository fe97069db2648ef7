"""The ranks of tests/test_torch_parallel.py (no tests here).

`start` spawns a world of gloo ranks on the CPU with `torch.multiprocessing`
and a `file://` rendezvous; each rank runs `run_scenarios` on the inputs the
test wrote to `payload.pt` and writes what it found to
`result-<scenario>-<rank>.pt`. Spawned children re-import this module, so
it imports no JAX: only torch, numpy and the port.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import torch
import torch.distributed as dist

CPU = torch.device("cpu")


def start(world: int, workdir: Path):
    """Start `run_scenarios` on `world` ranks; returns the process context."""
    return torch.multiprocessing.start_processes(
        _entry, args=(world, str(workdir)), nprocs=world, join=False,
        start_method="spawn")


def join(ctx, timeout: float) -> None:
    """Wait for the ranks; raise if one failed or the group outlives
    `timeout` seconds (its processes are then killed)."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")


def _entry(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            rank=rank, world_size=world)
    try:
        run_scenarios(rank, Path(workdir))
    finally:
        dist.destroy_process_group()


def _save(workdir: Path, scenario: str, rank: int, result: dict) -> None:
    torch.save(result, workdir / f"result-{scenario}-{rank}.pt")


# ---- the models both sides build ----


def build_teacher(payload):
    from basd_tpu_torch.models import load_teacher

    teacher = load_teacher(payload["teacher_preset"], img_size=payload["img"],
                           dtype=torch.float32, device=CPU)
    teacher.module.load_state_dict(payload["teacher_sd"])
    return teacher


def build_student(payload, *, drop_path=0.0, arch=None, state_dict=None):
    from basd_tpu_torch.models import create_student

    student, _ = create_student(
        payload["student_preset"], num_classes=payload["classes"],
        drop_path_rate=drop_path, img_size=payload["img"],
        arch_overrides=payload["arch"] if arch is None else arch,
        capture_layers=payload["points"], dtype=torch.float32, remat=False,
        device=CPU)
    if state_dict is not None:
        student.load_state_dict(state_dict)
    return student


def build_selector(payload, student_dim=None):
    """The JAX package's selector, or one drawn from seed 1 for a student of
    another width."""
    from basd_tpu_torch.losses import init_selector
    from basd_tpu_torch.models.convert import selector_state_from_numpy

    log_t, proj_s, proj_t = payload["selector"]
    if student_dim is not None and student_dim != proj_s.shape[0]:
        return init_selector(1, len(log_t), student_dim, proj_t.shape[1], device=CPU)
    return selector_state_from_numpy(log_t, proj_s, proj_t, device=CPU)


def one_step(payload, student, *, augment, mesh=None, seed=0):
    """One train step of `student` (full; sharded here over a model axis)
    on the payload's batch (this rank's shard over a mesh). Returns the
    metrics, the student after the step as a full state dict, and the
    updated temperatures."""
    from basd_tpu_torch.parallel.mesh import batch_shard
    from basd_tpu_torch.parallel.sharding_rules import gather_state_dict, shard_module
    from basd_tpu_torch.training.train_step import make_train_step

    teacher = build_teacher(payload)
    student = shard_module(student, mesh)
    init_fn, step_fn = make_train_step(student, teacher, **payload["step_kw"],
                                       mesh=mesh, augment=augment)
    state = init_fn(seed, build_selector(payload, student.config.embed_dim))
    images = torch.from_numpy(payload["images"])
    labels = torch.from_numpy(payload["labels"])
    if mesh is not None:
        images, labels = batch_shard(mesh, images, labels)
    state, metrics = step_fn(state, images, labels)
    params = dict(state.student.state_dict())
    if mesh is not None:
        params = gather_state_dict(params, mesh, student.config.num_heads)
    temps = torch.nn.functional.softplus(state.selector.log_temperatures).detach()
    return metrics, params, temps, state


def step_result(metrics, params, temps, state) -> dict:
    return {
        "loss": float(metrics["loss"]), "ce": float(metrics["ce_loss"]),
        "geo": float(metrics["geo_loss"]), "acc": float(metrics["train_acc"]),
        "weights": metrics["mixing_weights"].numpy(),
        "ranks": metrics["mp_ranks"].numpy(),
        "temps_after": temps.numpy(),
        "params": {k: v.clone() for k, v in params.items()},
        "local_params": {k: v.detach().clone()
                         for k, v in state.student.state_dict().items()},
        "generator": state.generator.get_state(),
    }


def selector_grads(payload, mesh=None):
    """Gradients of a fixed linear function of `select_and_mix`'s outputs
    with respect to the student tokens and the log-temperatures; over a
    mesh on this rank's slice (the function's share of it)."""
    from basd_tpu_torch.losses.selector import select_and_mix

    sel = build_selector(payload)
    g = payload["grad_inputs"]
    tensors = {k: torch.from_numpy(v) for k, v in g.items()}
    if mesh is not None:
        b = tensors["student"].shape[1] // mesh.data
        rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
        tensors = {k: v[:, rows] for k, v in tensors.items()}
    student = tensors["student"].clone().requires_grad_(True)
    mixed, mixed_imp, aux = select_and_mix(
        sel, student, tensors["teacher"], tensors["importance"],
        subspace_k=payload["grad_k"], mesh=mesh)
    f = (mixed * tensors["r_tokens"]).sum() + (mixed_imp * tensors["r_importance"]).sum()
    f.backward()
    return {"student": student.grad.clone(), "log_t": sel.log_temperatures.grad.clone(),
            "weights": aux["mixing_weights"].detach().clone()}


def full_state_tensors(trainer, mesh=None) -> dict:
    """Every tensor of a trainer's state in the one-process layout: the
    student, z and v by parameter name, the optimizer's step and weight
    sum, the log-temperatures, the generator and the step."""
    from basd_tpu_torch.parallel.sharding_rules import (
        gather_optimizer_state,
        gather_state_dict,
        optimizer_names,
    )

    st = trainer.state
    names = optimizer_names(st.student)
    heads = st.student.config.num_heads
    student = dict(st.student.state_dict())
    opt = st.optimizer.state_dict()
    if mesh is not None and mesh.model > 1:
        student = gather_state_dict(student, mesh, heads)
        opt = gather_optimizer_state(opt, names, mesh, heads)
    out = {f"param {k}": v.detach().clone() for k, v in student.items()}
    for i, slot in opt["state"].items():
        out[f"z {names[int(i)]}"] = slot["z"].clone()
        out[f"v {names[int(i)]}"] = slot["exp_avg_sq"].clone()
    group = opt["param_groups"][0]
    out["optimizer step, weight sum"] = torch.tensor(
        [group["step"], group["weight_sum"]], dtype=torch.float64)
    out["log_temperatures"] = st.selector.log_temperatures.detach().clone()
    out["generator"] = st.generator.get_state()
    out["step"] = torch.tensor(st.step)
    return out


def make_trainer(payload, output_dir, mesh=None):
    from basd_tpu_torch.config import compose_config
    from basd_tpu_torch.training.trainer import Trainer

    config = compose_config(["experiment=basd_smoke", f"run.output_dir={output_dir}",
                             *payload["trainer_overrides"]])
    teacher = build_teacher(payload)
    student = build_student(payload, state_dict=payload["student_sd"])
    return Trainer(config, student=student, student_cfg=student.config, teacher=teacher,
                   teacher_stats=payload["step_kw"]["teacher_stats"],
                   dataset_stats=payload["step_kw"]["dataset_stats"], mesh=mesh)


# ---- the scenarios, in order ----


def run_scenarios(rank: int, workdir: Path) -> None:
    from basd_tpu_torch.evaluation.metrics import evaluate_model
    from basd_tpu_torch.parallel.mesh import create_mesh
    from basd_tpu_torch.parallel.sharding_rules import (
        gather_optimizer_state,
        gather_state_dict,
        optimizer_names,
        shard_optimizer_state,
        shard_state_dict,
    )
    from basd_tpu_torch.training.schedule_free import ScheduleFreeAdamW

    payload = torch.load(workdir / "payload.pt", weights_only=False)

    # the mesh: shapes, coordinates and the refused grid
    dp4 = create_mesh(-1, 1, device=CPU)
    tp22 = create_mesh(2, 2, device=CPU)
    try:
        create_mesh(3, 2, device=CPU)
        refused = False
    except ValueError:
        refused = True
    student = build_student(payload, state_dict=payload["student_sd"])
    sd = student.state_dict()
    roundtrip = gather_state_dict(shard_state_dict(sd, tp22, 4), tp22, 4)
    odd = build_student(payload, arch=payload["odd_arch"])
    odd_sd = odd.state_dict()
    odd_roundtrip = gather_state_dict(shard_state_dict(odd_sd, tp22, 3), tp22, 3)
    opt = ScheduleFreeAdamW(list(student.parameters()), 1e-3)
    g = torch.Generator().manual_seed(0)  # the same v on every rank
    for st in opt.state.values():
        st["exp_avg_sq"].normal_(generator=g)
    names = [n for n, _ in student.named_parameters()]
    opt_sd = opt.state_dict()
    opt_roundtrip = gather_optimizer_state(
        shard_optimizer_state(opt_sd, names, tp22, 4), names, tp22, 4)
    _save(workdir, "mesh", rank, {
        "dp4": (dp4.shape, dp4.data_index, dp4.model_index, dp4.backend),
        "tp22": (tp22.shape, tp22.data_index, tp22.model_index),
        "refused": refused,
        "local_qkv": shard_state_dict(sd, tp22, 4)["blocks.0.attn.qkv.weight"],
        "roundtrip_exact": all(torch.equal(roundtrip[k], sd[k]) for k in sd),
        "odd_roundtrip_exact": all(torch.equal(odd_roundtrip[k], odd_sd[k]) for k in odd_sd),
        "opt_roundtrip_exact": all(
            torch.equal(opt_roundtrip["state"][i][k], opt_sd["state"][i][k])
            for i in opt_sd["state"] for k in opt_sd["state"][i]),
        "optimizer_names": optimizer_names(student),
    })

    # one step on the JAX package's weights and batch, augment=False
    for name, mesh in (("jax_dp4", dp4), ("jax_tp22", tp22)):
        student = build_student(payload, state_dict=payload["student_sd"])
        _save(workdir, name, rank, step_result(*one_step(payload, student,
                                                         augment=False, mesh=mesh)))

    # the augmented step (global draws, mixup's neighbour) with drop path
    student = build_student(payload, drop_path=0.1, state_dict=payload["student_sd"])
    _save(workdir, "augment_dp4", rank,
          step_result(*one_step(payload, student, augment=True, mesh=dp4)))

    # heads that tp = 2 does not divide: the attention stays whole
    student = build_student(payload, arch=payload["odd_arch"])
    _save(workdir, "odd_tp22", rank,
          step_result(*one_step(payload, student, augment=False, mesh=tp22)))

    # the selector's gradient through the data-group sum
    _save(workdir, "selector_grad", rank, selector_grads(payload, dp4))

    # sharded evaluation, a tail batch shorter than the data size
    student = build_student(payload, state_dict=payload["student_sd"])
    ev = payload["eval"]
    _save(workdir, "eval_dp4", rank, evaluate_model(
        student, None, ev["images"], ev["labels"], batch_size=ev["batch_size"],
        mesh=dp4, **ev["view"]))

    # the trainer over 2 x 2: one epoch, evaluation, checkpoints
    trainer = make_trainer(payload, workdir / "tp22", tp22)
    history = trainer.train(*payload["trainer_data"])
    _save(workdir, "trainer_tp22", rank, {
        "history": history, "state": full_state_tensors(trainer, tp22)})
    # ... and the one-process trainer's checkpoint restored into a 2 x 2 one
    restored = make_trainer(payload, workdir / "tp22_restore", tp22)
    restored.load_checkpoint(str(payload["one_process_latest"]))
    _save(workdir, "restore_tp22", rank, {"state": full_state_tensors(restored, tp22)})


def build_kernels_in(build_dir: str, stub_dir: str, log: str) -> None:
    """`kernels.build_all` into `build_dir` with the `nvcc` on PATH replaced
    by the stub in `stub_dir` (tests/test_torch_build_lock.py)."""
    os.environ["PATH"] = f"{stub_dir}{os.pathsep}{os.environ['PATH']}"
    os.environ["STUB_NVCC_LOG"] = log
    from basd_tpu_torch import kernels

    kernels.BUILD_DIR = Path(build_dir)
    kernels.build_all()
