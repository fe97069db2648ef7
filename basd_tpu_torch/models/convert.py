"""Weights carried across from the JAX package: flax parameter trees (as
numpy arrays) onto the port's timm/DINOv2/torchvision-keyed state dicts.
The inverses of `basd_tpu/models/convert.py`'s `torch_vit_to_flax`,
`torch_resnet_to_flax` and `torch_convnext_to_flax`."""

from __future__ import annotations

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
