"""The port's entry check: the counterpart of `__graft_entry__.py`.

    python -m basd_tpu_torch.entry [--device cpu]

runs `entry()`'s forward once, then `dryrun_multichip(8)`.

`entry()` returns a forward step of the flagship model: the ViT-Tiny
student with intermediate capture (patch 4 at 32 px), the model the
headline benchmark trains. `dryrun_multichip(n)` runs one full BASD train
step on tiny shapes over n ranks on a (data, model) mesh
(`parallel/mesh.py`): data parallelism on the batch, Megatron tensor
parallelism on the student's wide matmuls. Where the caller is not already
one of n ranks, it re-executes this module under `torch.distributed.run`
with n ranks, as `__graft_entry__.py` re-executes itself under n virtual
devices. The ranks' backend comes from `mesh.choose_backend`: gloo when
ranks share the one card or run on the CPU, NCCL when each has a card.
Rank 0 prints `dryrun_multichip ok devices=n mesh=(dxm) loss=...`; the
result it returns (the unrounded loss, its kernel launches and sketches of
the step's gradient and update, `sketch`) comes back to the caller on a
`dryrun_multichip detail {json}` line.

Both run on the card unless `device="cpu"` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from basd_tpu_torch import kernels
from basd_tpu_torch.device import resolve_device

_ROOT = Path(__file__).resolve().parents[1]
DETAIL = "dryrun_multichip detail "
DRYRUN_TIMEOUT_S = 900
SKETCH_ROWS = 128
# The dryrun over a mesh against `dryrun_step` in one process on the same
# global batch (`dryrun_distances`): bounds on the loss's relative error
# and on the sketches' distances of the step's gradient and update. Their
# floor is fp32 sums in another order: the one-process step on 1 and 2 CPU
# threads reads 1.6e-7, 1.0e-2 and 5.9e-2, and the 2 x 2 mesh of CPU ranks
# against one process 1.6e-7, 1.5e-2 and 7.8e-2. The update's floor is high
# because ScheduleFree's first update is about gamma sign(g), which the
# near-zero gradient entries flip. A missing or halved all-reduce of the
# gradients reads 0.5 in the gradient, and shards of one model rank left
# without an update read 0.70 in the update.
DRYRUN_BOUNDS = dict(loss=1e-5, grad=5e-2, update=0.25)


def entry(device=None):
    """(forward, (params, images)): forward(params, images) -> (logits,
    tokens) of the bf16 ViT-Tiny student (patch 4 at 32 px, 100 classes,
    captures at `extraction_points(12, 4)`, no remat) on a batch of 8
    zero images. On the card the kernels' start-up check runs first."""
    from basd_tpu_torch.losses import extraction_points
    from basd_tpu_torch.models import create_student
    from basd_tpu_torch.utils.kernel_smoke import validate_kernel_dispatches

    dev = resolve_device(device)
    validate_kernel_dispatches(dev, verbose=False)
    student, _ = create_student(
        "vit_tiny_patch16", num_classes=100, drop_path_rate=0.0, img_size=32,
        arch_overrides={"patch_size": 4}, capture_layers=extraction_points(12, 4),
        dtype=torch.bfloat16, remat=False, device=dev)
    images = torch.zeros((8, 32, 32, 3), dtype=torch.float32, device=dev)
    params = {k: v.detach() for k, v in student.state_dict().items()}

    def forward(params, images):
        with torch.no_grad():
            out = torch.func.functional_call(student, params, (images,), {"train": False})
        return out.logits, out.tokens

    return forward, (params, images)


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """(data, model) of the dryrun: model 2 where n is even and at least 4."""
    model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return n_devices // model, model


def sketch(tensors: dict) -> list[float]:
    """SKETCH_ROWS seeded Gaussian projections of `tensors` (flattened in
    float64, by sorted name), over sqrt(SKETCH_ROWS). The norm of the
    difference of two sketches is that of the two tensor sets' difference
    within a few per cent (Johnson-Lindenstrauss: 1/sqrt(2 SKETCH_ROWS) =
    6% standard error), so a JSON line carries a whole step's gradient or
    update for a comparison."""
    gen = torch.Generator().manual_seed(0)
    out = torch.zeros(SKETCH_ROWS, dtype=torch.float64)
    for name in sorted(tensors):
        v = tensors[name].detach().to("cpu", torch.float64).reshape(-1)
        out += torch.randn(SKETCH_ROWS, v.numel(), generator=gen, dtype=torch.float64) @ v
    return (out / SKETCH_ROWS**0.5).tolist()


def sketch_distance(got: list[float], want: list[float]) -> float:
    """||got - want|| / ||want|| of two sketches."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def dryrun_distances(got: dict, want: dict) -> dict[str, float]:
    """The loss's relative error and the gradient's and update's sketch
    distances of dryrun result `got` against `want` (`DRYRUN_BOUNDS`)."""
    return dict(loss=abs(got["loss"] / want["loss"] - 1),
                grad=sketch_distance(got["grad"], want["grad"]),
                update=sketch_distance(got["update"], want["update"]))


def dryrun_step(n_devices: int, mesh=None, device=None) -> dict:
    """`__graft_entry__._dryrun_multichip_impl`'s step: a ViT-Mini teacher
    and a ViT-Micro student at 16 px (fp32, drop path 0.1, remat), a batch
    of 2n uint8 20 px images from `default_rng(0)`, one augmented step.
    Over a `mesh` this rank takes its shard of the batch; without one the
    step takes the whole batch in one process. Returns the global batch's
    loss, this process's kernel launches in the step, and sketches of the
    step's gradient and update of the student (gathered over the model
    axis) and the selector's log-temperatures."""
    from basd_tpu_torch.losses import extraction_points, init_selector
    from basd_tpu_torch.models import create_student, load_teacher
    from basd_tpu_torch.parallel.mesh import batch_shard
    from basd_tpu_torch.parallel.sharding_rules import gather_state_dict, shard_module
    from basd_tpu_torch.training.train_step import make_train_step

    dev = mesh.device if mesh is not None else resolve_device(device)
    img_size = 16
    teacher = load_teacher("vit_mini_patch4", img_size=img_size, dtype=torch.float32,
                           device=dev)
    points = extraction_points(4, 2)
    student, cfg = create_student(
        "vit_micro_patch4", num_classes=10, drop_path_rate=0.1, img_size=img_size,
        capture_layers=points, dtype=torch.float32, remat=True, device=dev)
    student = shard_module(student, mesh)
    selector = init_selector(1, len(points), cfg.embed_dim, teacher.spec.embed_dim,
                             device=dev)
    init_fn, step_fn = make_train_step(
        student, teacher, learning_rate=1e-3, weight_decay=0.01, warmup_steps=2,
        label_smoothing=0.1, img_size=img_size, crop_ratio=16 / 24,
        teacher_stats=((0.5,) * 3, (0.5,) * 3), dataset_stats=((0.5,) * 3, (0.25,) * 3),
        num_classes=10, mesh=mesh)
    state = init_fn(0, selector)
    batch = 2 * n_devices
    rng = np.random.default_rng(0)
    images = torch.from_numpy((rng.random((batch, 20, 20, 3)) * 255).astype(np.uint8))
    labels = torch.from_numpy(rng.integers(0, 10, batch, dtype=np.int64))
    images, labels = images.to(dev), labels.to(dev)
    if mesh is not None:
        images, labels = batch_shard(mesh, images, labels)
    trained = dict(state.student.named_parameters(),
                   log_temperatures=state.selector.log_temperatures)
    before = {k: p.detach().clone() for k, p in trained.items()}
    kernels.reset_launches()
    _, metrics = step_fn(state, images, labels)
    loss = float(metrics["loss"])
    launches = dict(kernels.LAUNCHES)
    grad = {k: p.grad for k, p in trained.items()}
    update = {k: p.detach() - before[k] for k, p in trained.items()}
    if mesh is not None:
        # the model axis's shards, whole (log_temperatures is not split)
        grad, update = (gather_state_dict(t, mesh, cfg.num_heads) for t in (grad, update))
    return dict(loss=loss, launches=launches, grad=sketch(grad), update=sketch(update))


def _dryrun_multichip_impl(n_devices: int, device=None) -> dict | None:
    """One rank of the dryrun; rank 0 prints and returns the result."""
    from basd_tpu_torch.parallel.mesh import create_mesh, shutdown

    data, model = mesh_shape(n_devices)
    mesh = create_mesh(data, model, device=device)
    try:
        t0 = time.perf_counter()
        step = dryrun_step(n_devices, mesh)
        if not np.isfinite(step["loss"]):
            raise AssertionError(f"multichip dryrun loss not finite: {step['loss']}")
        result = dict(devices=n_devices, mesh=[data, model], backend=mesh.backend,
                      **step, step_s=time.perf_counter() - t0)
        if mesh.is_main:
            print(f"dryrun_multichip ok devices={n_devices} mesh=({data}x{model}) "
                  f"loss={step['loss']:.4f}", flush=True)
            print(DETAIL + json.dumps(result), flush=True)
            return result
        return None
    finally:
        shutdown()


def _inside_world(n_devices: int) -> bool:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() == n_devices
    return "RANK" in os.environ and int(os.environ.get("WORLD_SIZE", "0")) == n_devices


def dryrun_multichip(n_devices: int, device=None) -> dict | None:
    """Run the train step over an n-rank mesh: here when this process is
    already one of n ranks, else in n ranks started by
    `torch.distributed.run` (their output copied to stdout; a failure
    raises with its tail). Returns rank 0's result (None on other ranks)."""
    resolve_device(device)  # the card, unless the CPU is asked for: raises without one
    if _inside_world(n_devices):
        return _dryrun_multichip_impl(n_devices, device)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n_devices}", "-m", "basd_tpu_torch.entry",
           "--dryrun-impl", str(n_devices)]
    if device is not None:
        cmd += ["--device", str(device)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_ROOT), env.get("PYTHONPATH", "")) if p)
    proc = subprocess.Popen(cmd, cwd=_ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"dryrun_multichip: the ranks outlived {DRYRUN_TIMEOUT_S} s:\n"
                           f"{out[-2000:]}") from None
    # the ranks' output but the detail line (another rank's unterminated
    # print may share that line)
    details = []
    for line in out.splitlines():
        if DETAIL in line:
            line, detail = line.split(DETAIL, 1)
            details.append(detail)
        if line:
            print(line)
    sys.stdout.flush()
    if proc.returncode != 0 or not details:
        raise RuntimeError(f"dryrun_multichip subprocess failed rc={proc.returncode}:\n"
                           f"{out[-2000:]}")
    return json.loads(details[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu for the plain torch path")
    ap.add_argument("--dryrun-impl", type=int, default=None, metavar="N",
                    help="run as one of N ranks (set by the re-execution)")
    args = ap.parse_args(argv)
    if args.dryrun_impl is not None:
        _dryrun_multichip_impl(args.dryrun_impl, args.device)
        return 0
    forward, fargs = entry(args.device)
    out = forward(*fargs)
    print("entry ok:", tuple(tuple(o.shape) for o in out), flush=True)
    dryrun_multichip(8, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
