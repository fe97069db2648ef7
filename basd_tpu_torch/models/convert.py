"""Weights for the port's models.

* Carried across from the JAX package: flax parameter trees (as numpy
  arrays) onto the port's timm/DINOv2/torchvision-keyed state dicts, the
  inverses of `basd_tpu/models/convert.py`'s `torch_vit_to_flax`,
  `torch_resnet_to_flax` and `torch_convnext_to_flax`.
* Loaded from weight files (the port of the JAX module's second half):
  `.npz` exports and `.pth`/`.pt` state dicts in timm/DINOv2/torchvision
  keys, which are the port's own keys, so loading is a strict key audit,
  a position-embedding resample where the grid differs, and
  `load_state_dict`; normalization stats recorded with the file.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.losses.selector import SelectorState


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(p: Mapping[str, Any], prefix: str, out: dict) -> None:
    out[prefix + ".weight"] = _t(p["kernel"]).T.contiguous()  # (in, out) -> (out, in)
    out[prefix + ".bias"] = _t(p["bias"])


def _norm(p: Mapping[str, Any], prefix: str, out: dict) -> None:
    out[prefix + ".weight"] = _t(p["scale"])
    out[prefix + ".bias"] = _t(p["bias"])


def _conv(p: Mapping[str, Any], prefix: str, out: dict) -> None:
    """flax conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    out[prefix + ".weight"] = _t(p["kernel"]).permute(3, 2, 0, 1).contiguous()
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map a flax ViT param tree onto the port's state dict: linear kernels
    transposed, the conv kernel (kh, kw, in, out) -> (out, in, kh, kw),
    LayerScale `ls1`/`ls2` -> `ls1.gamma`/`ls2.gamma`."""
    sd: dict[str, torch.Tensor] = {}
    _conv(params["patch_embed"], "patch_embed.proj", sd)
    if "cls_token" in params:
        sd["cls_token"] = _t(params["cls_token"]).reshape(1, 1, -1)
    sd["pos_embed"] = _t(params["pos_embed"])
    _norm(params["norm"], "norm", sd)
    depth = sum(1 for key in params if key.startswith("block"))
    for i in range(depth):
        blk, pre = params[f"block{i}"], f"blocks.{i}."
        _norm(blk["norm1"], pre + "norm1", sd)
        _norm(blk["norm2"], pre + "norm2", sd)
        _linear(blk["attn"]["qkv"], pre + "attn.qkv", sd)
        _linear(blk["attn"]["proj"], pre + "attn.proj", sd)
        _linear(blk["mlp"]["fc1"], pre + "mlp.fc1", sd)
        _linear(blk["mlp"]["fc2"], pre + "mlp.fc2", sd)
        for ls in ("ls1", "ls2"):
            if ls in blk:
                sd[pre + ls + ".gamma"] = _t(blk[ls]).reshape(-1)
    if "head" in params:
        _linear(params["head"], "head", sd)
    return sd


def _blocks(params: Mapping[str, Any], stage: int) -> int:
    return sum(1 for key in params if key.startswith(f"stage{stage}_block"))


def resnet_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map flax ResNet variables ({"params", "batch_stats"}) onto the port's
    torchvision-keyed state dict: BatchNorm scale/bias -> weight/bias, its
    batch_stats mean/var -> running_mean/running_var, the head -> `fc`."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    def bn(name: str, scope: Mapping, scope_stats: Mapping, prefix: str) -> None:
        _norm(scope[name], prefix, sd)
        sd[prefix + ".running_mean"] = _t(scope_stats[name]["mean"])
        sd[prefix + ".running_var"] = _t(scope_stats[name]["var"])

    _conv(params["stem_conv"], "conv1", sd)
    bn("stem_bn", params, stats, "bn1")
    stage = 0
    while _blocks(params, stage):
        for b in range(_blocks(params, stage)):
            name, pre = f"stage{stage}_block{b}", f"layer{stage + 1}.{b}."
            blk, blk_stats = params[name], stats[name]
            _conv(blk["conv1"], pre + "conv1", sd)
            _conv(blk["conv2"], pre + "conv2", sd)
            bn("bn1", blk, blk_stats, pre + "bn1")
            bn("bn2", blk, blk_stats, pre + "bn2")
            if "downsample_conv" in blk:
                _conv(blk["downsample_conv"], pre + "downsample.0", sd)
                bn("downsample_bn", blk, blk_stats, pre + "downsample.1")
        stage += 1
    if "head" in params:
        _linear(params["head"], "fc", sd)
    return sd


def convnext_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map flax ConvNeXt variables ({"params"}) onto the port's timm-keyed
    state dict: the V2 GRN's gamma/beta -> `mlp.grn.weight`/`bias` as (C,),
    the V1 layer scale -> `gamma`, the head -> `head.fc`."""
    params = variables["params"]
    sd: dict[str, torch.Tensor] = {}
    _conv(params["stem_conv"], "stem.0", sd)
    _norm(params["stem_norm"], "stem.1", sd)
    stage = 0
    while _blocks(params, stage):
        if stage > 0:
            _norm(params[f"down{stage}_norm"], f"stages.{stage}.downsample.0", sd)
            _conv(params[f"down{stage}_conv"], f"stages.{stage}.downsample.1", sd)
        for b in range(_blocks(params, stage)):
            blk, pre = params[f"stage{stage}_block{b}"], f"stages.{stage}.blocks.{b}."
            _conv(blk["dwconv"], pre + "conv_dw", sd)
            _norm(blk["norm"], pre + "norm", sd)
            _linear(blk["pwconv1"], pre + "mlp.fc1", sd)
            _linear(blk["pwconv2"], pre + "mlp.fc2", sd)
            if "grn" in blk:
                sd[pre + "mlp.grn.weight"] = _t(blk["grn"]["gamma"]).reshape(-1)
                sd[pre + "mlp.grn.bias"] = _t(blk["grn"]["beta"]).reshape(-1)
            else:
                sd[pre + "gamma"] = _t(blk["gamma"]).reshape(-1)
        stage += 1
    if "head" in params:
        _linear(params["head"], "head.fc", sd)
    return sd


def selector_state_from_numpy(
    log_temperatures, proj_s, proj_t, *, device=None
) -> SelectorState:
    """A selector state from numpy arrays (e.g. a JAX `SelectorState`); the
    log-temperatures require grad."""
    dev = resolve_device(device)
    return SelectorState(
        _t(log_temperatures).to(dev).requires_grad_(True),
        _t(proj_s).to(dev),
        _t(proj_t).to(dev),
    )


# ---- weight files ----


def _load_state_file(path: str | Path) -> dict[str, np.ndarray]:
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            # "__*__" keys carry normalization metadata, not weights
            return {k: z[k] for k in z.files if not k.startswith("__")}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return {k: v.numpy() for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_checkpoint_stats(
    path: str | Path,
) -> tuple[tuple[float, ...], tuple[float, ...]] | None:
    """Normalization (mean, std) recorded with a weight file, so a teacher
    is normalized with ITS stats. Sources, in order: a `<file>.stats.json`
    sidecar ({"mean": [...], "std": [...]}), an `.npz` export's
    `__norm_mean__`/`__norm_std__` arrays (`export_teacher_npz`), a `.pth`
    bundle's `pretrained_cfg` entry (timm full saves). None when the file
    records none (the caller uses the preset's)."""
    path = Path(path)
    sidecar = path.with_name(path.name + ".stats.json")
    if sidecar.exists():
        meta = json.loads(sidecar.read_text())
        return tuple(meta["mean"]), tuple(meta["std"])
    if path.suffix == ".npz":
        with np.load(path) as z:
            if "__norm_mean__" in z.files and "__norm_std__" in z.files:
                return (
                    tuple(float(v) for v in z["__norm_mean__"]),
                    tuple(float(v) for v in z["__norm_std__"]),
                )
        return None
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        cfg = obj.get("pretrained_cfg")
        if isinstance(cfg, dict) and "mean" in cfg and "std" in cfg:
            return tuple(cfg["mean"]), tuple(cfg["std"])
    return None


def export_teacher_npz(
    path: str | Path,
    state: Mapping[str, Any],
    *,
    mean: tuple[float, ...] | None = None,
    std: tuple[float, ...] | None = None,
) -> None:
    """Write a state dict to `.npz`, with the normalization stats as
    `__norm_mean__`/`__norm_std__` metadata arrays."""
    arrays = {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in state.items()
    }
    if mean is not None and std is not None:
        arrays["__norm_mean__"] = np.asarray(mean, np.float64)
        arrays["__norm_std__"] = np.asarray(std, np.float64)
    np.savez(path, **arrays)


def interpolate_vit_pos_embed(pos: np.ndarray, target_len: int) -> np.ndarray:
    """Resample a (1, N, D) ViT position embedding to a new square patch
    grid, as DINOv2's `interpolate_pos_encoding` does: the CLS entry kept
    verbatim, the patch grid resized bicubically (align_corners=False).
    DINOv2 files ship the 518 px grid (37 x 37 + 1)."""
    pos = np.asarray(pos)
    n_src, n_dst = pos.shape[1], target_len

    def grid_side(n: int) -> tuple[int, bool]:
        for extra, has_cls in ((1, True), (0, False)):
            side = int(round((n - extra) ** 0.5))
            if side * side == n - extra:
                return side, has_cls
        raise ValueError(f"pos_embed length {n} is not a square patch grid")

    src_side, src_cls = grid_side(n_src)
    dst_side, dst_cls = grid_side(n_dst)
    if src_cls != dst_cls:
        raise ValueError(
            f"pos_embed CLS mismatch: source len {n_src} vs target {n_dst}"
        )
    cls_part = pos[:, :1] if src_cls else pos[:, :0]
    grid = (pos[:, 1:] if src_cls else pos).astype(np.float32)
    t = (
        torch.from_numpy(np.ascontiguousarray(grid))
        .reshape(1, src_side, src_side, -1)
        .permute(0, 3, 1, 2)
    )
    t = torch.nn.functional.interpolate(
        t, size=(dst_side, dst_side), mode="bicubic", align_corners=False
    )
    resized = t.permute(0, 2, 3, 1).reshape(1, dst_side * dst_side, -1).numpy()
    return np.concatenate(
        [cls_part.astype(np.float32), resized], axis=1
    ).astype(pos.dtype)


# Source keys that legitimately go unread: DINOv2's `mask_token` serves
# masked-image-modeling pretraining only; BatchNorm counters carry no
# weights. Classifier heads may be absent on either side: teachers are
# feature extractors, and a head of another class count is not loaded.
_IGNORABLE_SOURCE_KEYS = ("mask_token",)
_IGNORABLE_SOURCE_SUFFIXES = ("num_batches_tracked",)
_HEAD_NAMES = ("head", "fc")
# older CaiT-style dumps name the LayerScale gammas `gamma_1`/`gamma_2`
_ALIASES = (("ls1.gamma", "gamma_1"), ("ls2.gamma", "gamma_2"))


def _is_head(key: str) -> bool:
    return key.split(".", 1)[0] in _HEAD_NAMES


def load_converted_weights(
    path: str | Path, module: torch.nn.Module, *, strict: bool = True
) -> torch.nn.Module:
    """Load a weight file into `module` (shape-checked key by key) and
    return it.

    Strict by default: source keys the module never reads AND module keys
    the file never fills both raise, so a file with unmapped weights (e.g.
    DINOv2 `ls1`/`ls2` against a spec without LayerScale, or register
    tokens) fails loudly instead of giving a silently wrong teacher.
    Allowlisted: classifier heads (absent on either side by design),
    `mask_token` and BatchNorm counters. A position embedding of another
    grid is resampled (`interpolate_vit_pos_embed`); an entry stored with
    extra unit dimensions (a (1, 1, D) gamma, a (1, 1, 1, C) GRN weight) is
    reshaped."""
    source = _load_state_file(path)
    target = module.state_dict()
    used: set[str] = set()
    loaded: dict[str, torch.Tensor] = {}
    unfilled: list[str] = []
    for key, leaf in target.items():
        src_key = key
        if src_key not in source:
            for ours, theirs in _ALIASES:
                alt = key[: -len(ours)] + theirs
                if key.endswith(ours) and alt in source:
                    src_key = alt
        if src_key not in source:
            if not _is_head(key):
                unfilled.append(key)
            continue
        arr = np.asarray(source[src_key])
        used.add(src_key)
        want = tuple(leaf.shape)
        if arr.shape != want:
            if (key.split(".")[-1] == "pos_embed" and arr.ndim == 3
                    and len(want) == 3 and arr.shape[2] == want[2]):
                arr = interpolate_vit_pos_embed(arr, want[1])
            elif np.squeeze(arr).shape == tuple(d for d in want if d != 1):
                arr = arr.reshape(want)
            else:
                raise ValueError(
                    f"shape mismatch at {key}: module {want} vs file {arr.shape}"
                )
        loaded[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(leaf.dtype)

    if strict:
        unconsumed = sorted(
            k for k in set(source) - used
            if k not in _IGNORABLE_SOURCE_KEYS
            and not k.endswith(_IGNORABLE_SOURCE_SUFFIXES)
            and not _is_head(k)
        )
        problems = []
        if unconsumed:
            problems.append(
                f"source keys never consumed: {unconsumed[:8]}"
                + (f" (+{len(unconsumed) - 8} more)" if len(unconsumed) > 8 else "")
            )
        if unfilled:
            problems.append(
                f"module keys never filled: {sorted(unfilled)[:8]}"
                + (f" (+{len(unfilled) - 8} more)" if len(unfilled) > 8 else "")
            )
        if problems:
            raise ValueError(
                f"strict weight load of {path} failed — " + "; ".join(problems)
                + ". The file and the target architecture disagree (wrong "
                "preset flags, e.g. LayerScale, or an unsupported variant). "
                "Pass strict=False only if you know exactly which weights "
                "will be dropped or stay random."
            )
    module.load_state_dict(loaded, strict=False)
    return module
