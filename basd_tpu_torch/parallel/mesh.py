"""Data and tensor parallelism over a ('data', 'model') grid of processes:
the port of `basd_tpu/parallel/mesh.py`.

The JAX package runs one program over a device mesh and lets GSPMD insert
the collectives, so every cross-replica reduction (the gradient sum, the
metric sums and the selector's Gram statistics) is exact over the global
batch. The port runs one process per mesh position, launched by
`python -m torch.distributed.run`, and writes those collectives out here,
with the same contract: one step over a mesh of W ranks computes the
one-process step on the global batch.

Rank r sits at (data index r // model, model index r % model), as the JAX
package reshapes its devices to (data, model). The ranks of one model
group (one data index) hold the same batch slice and split the student's
wide matmuls (`sharding_rules.py`); the ranks of one data group (one model
index) hold the same parameter shards and split the batch.

The backend is decided once, before the process group starts, from the
topology: `nccl` where each rank of a node has a card of its own
(`LOCAL_WORLD_SIZE` <= the card count), `gloo` where ranks share a card or
run on the CPU. NCCL refuses two ranks on one card; gloo takes CUDA
tensors for `all_reduce` and `broadcast` (it stages them through the
host), and only those two are used on the card. Nothing switches backend
or device after a failure.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist


@dataclass(eq=False)
class Mesh:
    """This rank's place in a (data, model) grid and its two groups."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    data_group: Any  # the ranks with this rank's model index
    model_group: Any  # the ranks with this rank's data index
    # host ms of each collective by name, when set to a dict (the card is
    # synchronized before and after each one, so a timed run is slower)
    timings: dict[str, list[float]] | None = field(default=None)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def launched_world() -> int:
    """The number of processes launched: the process group's size once it
    exists, else torchrun's `WORLD_SIZE` (1 when not launched by it)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def choose_backend(device: torch.device) -> str:
    """`nccl` when every rank of this node has a card of its own, `gloo`
    when ranks share a card or the device is the CPU."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU if asked for, else the card
    `LOCAL_RANK % card count` (ranks share cards when there are fewer cards
    than ranks), made the current one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank device was asked for and none is available")
    if dev.index is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init_process_group(device: torch.device, backend: str | None = None) -> str:
    """Start the default process group from torchrun's environment (or an
    `init_method` the caller already used) unless it exists; returns the
    backend, chosen by `choose_backend` unless given, and prints it."""
    if dist.is_initialized():
        return dist.get_backend()
    backend = backend or choose_backend(device)
    if int(os.environ.get("RANK", "0")) == 0:
        print(f"process group: backend {backend} (device {device}, "
              f"{os.environ.get('LOCAL_WORLD_SIZE', '1')} ranks on this node, "
              f"{torch.cuda.device_count() if device.type == 'cuda' else 0} cards)",
              flush=True)
    dist.init_process_group(backend)
    return backend


def create_mesh(data: int = -1, model: int = 1, *, backend: str | None = None,
                device=None) -> Mesh:
    """Mesh over the launched world; data=-1 takes what `model` leaves.
    Raises where data x model != world, before any process group starts.
    Every rank must call it with the same arguments (it creates every
    group of the grid)."""
    n = launched_world()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} processes not divisible by model={model}")
        data = n // model
    if data < 1 or model < 1 or data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    dev = rank_device(device)
    backend = init_process_group(dev, backend)
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(model):
        group = dist.new_group([d * model + m for d in range(data)])
        if m == rank % model:
            data_group = group
    for d in range(data):
        group = dist.new_group([d * model + m for m in range(model)])
        if d == rank // model:
            model_group = group
    return Mesh(data, model, rank, dev, backend, data_group, model_group)


def mesh_from_config(config, device=None) -> Mesh | None:
    """The entry points' mesh: `hardware.mesh` over the torchrun world, or
    None in one process, where `hardware.mesh` is ignored (as the JAX
    package ignores it on one device)."""
    if launched_world() <= 1:
        return None
    spec = config.hardware.mesh
    return create_mesh(int(spec.data), int(spec.model), device=device)


def main_print(mesh: Mesh | None):
    """`print` in one process and on rank 0; a no-op on the other ranks."""
    return print if mesh is None or mesh.is_main else (lambda *args, **kwargs: None)


def shutdown() -> None:
    """Destroy the default process group if one exists."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# batch slices
# ---------------------------------------------------------------------------


def shard_rows(n: int, parts: int, index: int) -> tuple[int, int]:
    """Rows [lo, hi) of part `index` when n rows are cut into `parts`
    contiguous parts, the first n % parts of them one row longer."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def batch_shard(mesh: Mesh, *tensors):
    """This rank's contiguous slice of a global batch (the counterpart of
    `shard_batch`): the ranks of one model group hold the same slice. The
    batch must divide by the data size."""
    out = []
    for t in tensors:
        if t.shape[0] % mesh.data:
            raise ValueError(f"batch {t.shape[0]} not divisible by data={mesh.data}")
        b = t.shape[0] // mesh.data
        out.append(t[mesh.data_index * b:(mesh.data_index + 1) * b])
    return tuple(out) if len(out) > 1 else out[0]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _size(group) -> int:
    return dist.get_world_size(group)


@contextmanager
def _timed(mesh: Mesh, name: str):
    if mesh.timings is None:
        yield
        return
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    yield
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    mesh.timings.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)


def all_reduce_(t: torch.Tensor, group, mesh: Mesh, name: str) -> torch.Tensor:
    """Sum `t` over `group` in place (nothing over a group of one)."""
    if _size(group) > 1:
        with _timed(mesh, name):
            dist.all_reduce(t, group=group)
    return t


def data_all_reduce(t: torch.Tensor, mesh: Mesh, name: str = "data_sum") -> torch.Tensor:
    """A copy of `t` summed over the data group, outside autograd."""
    out = t.detach().clone()
    return all_reduce_(out, mesh.data_group, mesh, name)


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Broadcast `t` in place from global rank `src` to every rank."""
    if mesh.world > 1:
        dist.broadcast(t, src)
    return t


def broadcast_int(value: int | None, mesh: Mesh | None) -> int:
    """Rank 0's `value` on every rank (the others pass anything)."""
    if mesh is None:
        return int(value)
    t = torch.tensor([0 if value is None else int(value)], dtype=torch.int64,
                     device=mesh.device)
    return int(broadcast_(t, mesh).item())


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None and mesh.world > 1:
        dist.barrier()


def data_shift(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The previous data rank's `x` (rank 0 takes the last rank's): the
    cyclic neighbour across shard boundaries, by one sum over the data
    group of a buffer where each rank fills its own slot."""
    buf = torch.zeros((mesh.data,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[mesh.data_index] = x
    all_reduce_(buf, mesh.data_group, mesh, "data_shift")
    return buf[(mesh.data_index - 1) % mesh.data]


class _DataSum(torch.autograd.Function):
    """Sum over the data group; the backward sums the upstream gradients
    over the data group too. Every rank computes the same loss terms from
    the summed statistics, but each rank's backward carries only its own
    batch slice's terms, so the sum of the upstream gradients is the
    gradient of the global loss with respect to the global statistics,
    which each rank then multiplies by its own slice's Jacobian."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_(x.detach().clone(), mesh.data_group, mesh, "selector_sums")

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        return all_reduce_(grad.contiguous().clone(), mesh.data_group, mesh,
                           "selector_sums_backward"), None


def data_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _DataSum.apply(x, mesh)


def _model_sum32(x: torch.Tensor, mesh: Mesh, name: str) -> torch.Tensor:
    """`x` summed over the model group in fp32, returned in fp32."""
    out = x.float().contiguous().clone()
    return all_reduce_(out, mesh.model_group, mesh, name)


class _CopyToModel(torch.autograd.Function):
    """Megatron's "copy" (f): the identity forward, the input of a
    column-parallel layer; its backward sums the partial input gradients
    of the model group's shards."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        return _model_sum32(grad, ctx.mesh, "tp_copy_backward").to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's "reduce" (g): the sum of the model group's partial
    outputs of a row-parallel layer, in fp32; the identity backward (every
    model rank holds the same upstream gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _model_sum32(x, mesh, "tp_reduce")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum the gradients of `params` over the data group with one flat
    all-reduce (a parameter without a gradient counts as zeros). The model
    group needs no sum: a column- or row-parallel shard's gradient is its
    own, and a replicated parameter's is already equal on every model rank
    (the copy operator sums the partial input gradients)."""
    params = list(params)
    if mesh.data == 1:
        return
    flat = torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
        for p in params
    ])
    all_reduce_(flat, mesh.data_group, mesh, "grad_all_reduce")
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
        offset += n
