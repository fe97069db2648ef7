"""Megatron tensor-parallel rules for the student ViT's state dict: the port
of `basd_tpu/parallel/sharding_rules.py`, on the port's timm keys.

Column-parallel (the output rows split over the model group):
`attn.qkv.weight`/`.bias` and `mlp.fc1.weight`/`.bias`. Row-parallel (the
input columns split): `attn.proj.weight` and `mlp.fc2.weight`, whose
biases stay whole and are added after the model group's sum. Everything
else is replicated, and the ScheduleFree `z` and `v` follow their
parameter, as in the JAX package's `state_sharding`.

The timm `qkv.weight` is (3D, D) in [q | k | v] order, so it is split by
whole heads inside each of its three D-row blocks: model rank m holds
[q_m | k_m | v_m], the rows of its H/tp heads. In the JAX package the
split is a layout that GSPMD reshards; here it is the math, and
`gather_state_dict` inverts it exactly. Where tp does not divide the
heads, the attention stays whole on every rank and only the MLP splits
(`attention_split`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from basd_tpu_torch.parallel.mesh import Mesh

_COLUMN = ("attn.qkv.weight", "attn.qkv.bias", "mlp.fc1.weight", "mlp.fc1.bias")
_ROW = ("attn.proj.weight", "mlp.fc2.weight")


def attention_split(num_heads: int, model: int) -> bool:
    """Whether the attention splits over `model` ranks (by whole heads)."""
    return model > 1 and num_heads % model == 0


def split_axis(name: str, attention: bool = True) -> int | None:
    """The axis of parameter `name` that the model group splits: 0 for a
    column-parallel tensor, 1 for a row-parallel weight, None when it is
    replicated; the attention's only when `attention`."""
    if not attention and ".attn." in f".{name}":
        return None
    if name.endswith(_COLUMN):
        return 0
    if name.endswith(_ROW):
        return 1
    return None


def _qkv(name: str) -> bool:
    return name.endswith(("attn.qkv.weight", "attn.qkv.bias"))


def shard_tensor(name: str, t: torch.Tensor, model: int, index: int,
                 num_heads: int) -> torch.Tensor:
    """Model rank `index`'s shard of the full parameter `name` (a copy)."""
    axis = split_axis(name, attention_split(num_heads, model))
    if axis is None or model == 1:
        return t.detach().clone()
    if t.shape[axis] % model:
        raise ValueError(f"{name}: axis {axis} of {tuple(t.shape)} not divisible "
                         f"by model={model}")
    if _qkv(name):
        parts = t.reshape(3, model, t.shape[0] // (3 * model), *t.shape[1:])
        return parts[:, index].reshape(-1, *t.shape[1:]).clone()
    return t.chunk(model, dim=axis)[index].clone()


def merge_shards(name: str, shards: list[torch.Tensor], num_heads: int) -> torch.Tensor:
    """The full parameter `name` from every model rank's shard, in order:
    the exact inverse of `shard_tensor`."""
    model = len(shards)
    axis = split_axis(name, attention_split(num_heads, model))
    if axis is None or model == 1:
        return shards[0]
    if _qkv(name):
        rest = shards[0].shape[1:]
        blocks = [s.reshape(3, -1, *rest) for s in shards]
        return torch.stack(blocks, dim=1).reshape(-1, *rest)
    return torch.cat(shards, dim=axis)


def shard_state_dict(state_dict: dict, mesh: Mesh, num_heads: int) -> dict:
    """Full state dict -> this rank's shards (no communication)."""
    return {name: shard_tensor(name, t, mesh.model, mesh.model_index, num_heads)
            for name, t in state_dict.items()}


def gather_state_dict(state_dict: dict, mesh: Mesh, num_heads: int,
                      param_of=lambda key: key) -> dict:
    """This rank's shards -> the full state dict on every rank of the model
    group: exactly the tensors `shard_state_dict` was given. `param_of`
    names the parameter a key holds (the identity for a state dict). Each
    model rank broadcasts its split tensors as one flat fp32 buffer
    (broadcast is exact; all shards of a key have one shape)."""
    attention = attention_split(num_heads, mesh.model)
    split = [k for k in state_dict
             if mesh.model > 1 and split_axis(param_of(k), attention) is not None]
    out = dict(state_dict)
    if not split:
        return out
    local = torch.cat([state_dict[k].detach().reshape(-1) for k in split])
    shards: dict[str, list[torch.Tensor]] = {k: [] for k in split}
    for m in range(mesh.model):
        buf = local.clone() if m == mesh.model_index else torch.empty_like(local)
        dist.broadcast(buf, dist.get_global_rank(mesh.model_group, m),
                       group=mesh.model_group)
        offset = 0
        for k in split:
            t = state_dict[k]
            shards[k].append(buf[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    for k in split:
        out[k] = merge_shards(param_of(k), shards[k], num_heads)
    return out


def shard_module(model, mesh: Mesh | None):
    """A tensor-parallel twin of a full student ViT on its device, holding
    this rank's shards; the model itself where the mesh has no model axis."""
    if mesh is None or mesh.model == 1:
        return model
    from basd_tpu_torch.models.vit import VisionTransformer

    device = next(model.parameters()).device
    twin = VisionTransformer(model.config, model.capture_layers, mesh=mesh).to(device)
    twin.load_state_dict(shard_state_dict(model.state_dict(), mesh,
                                          model.config.num_heads))
    return twin


def full_module(model, params: dict | None, mesh: Mesh | None):
    """(a one-process student, its parameters) for a possibly
    tensor-parallel `model` at `params` (its own weights when None): the
    shards gathered on every rank of the model group."""
    if mesh is None or mesh.model == 1:
        return model, params
    from basd_tpu_torch.models.vit import VisionTransformer

    heads = model.config.num_heads
    full = gather_state_dict(dict(model.state_dict()) if params is None else dict(params),
                             mesh, heads)
    device = next(model.parameters()).device
    plain = VisionTransformer(model.config, model.capture_layers).to(device)
    if params is None:
        plain.load_state_dict(full)
        return plain, None
    return plain, full


def optimizer_names(student) -> list[str]:
    """The parameter name of each optimizer slot: the student's parameters
    in order, then the selector's log-temperatures (`init_train_state`)."""
    return [n for n, _ in student.named_parameters()] + ["log_temperatures"]


def _map_optimizer_state(opt_state: dict, fn) -> dict:
    """`opt_state` with each non-scalar tensor v of slot i, key k replaced
    by fn(i, k, v)."""
    state = {i: {k: fn(i, k, v) if isinstance(v, torch.Tensor) and v.ndim else v
                 for k, v in slot.items()}
             for i, slot in opt_state["state"].items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def shard_optimizer_state(opt_state: dict, names: list[str], mesh: Mesh,
                          num_heads: int) -> dict:
    """A one-process ScheduleFree state dict -> this rank's: z and v follow
    their parameter (`names[i]` names slot i)."""
    return _map_optimizer_state(opt_state, lambda i, k, v: shard_tensor(
        names[int(i)], v, mesh.model, mesh.model_index, num_heads))


def gather_optimizer_state(opt_state: dict, names: list[str], mesh: Mesh,
                           num_heads: int) -> dict:
    """This rank's ScheduleFree state dict -> the one-process one."""
    tensors = {}
    _map_optimizer_state(opt_state, lambda i, k, v: tensors.setdefault((i, k), v))
    full = gather_state_dict(tensors, mesh, num_heads,
                             param_of=lambda key: names[int(key[0])])
    return _map_optimizer_state(opt_state, lambda i, k, v: full[(i, k)])
