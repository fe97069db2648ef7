"""Weights carried across from the JAX package: flax parameter trees (as
numpy arrays) onto the port's timm/DINOv2-keyed state dicts. The inverse
of `basd_tpu/models/convert.py:torch_vit_to_flax`."""

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


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map a flax ViT param tree onto the port's state dict: linear kernels
    transposed, the conv kernel (kh, kw, in, out) -> (out, in, kh, kw),
    LayerScale `ls1`/`ls2` -> `ls1.gamma`/`ls2.gamma`."""
    sd: dict[str, torch.Tensor] = {}
    conv = params["patch_embed"]
    sd["patch_embed.proj.weight"] = _t(conv["kernel"]).permute(3, 2, 0, 1).contiguous()
    sd["patch_embed.proj.bias"] = _t(conv["bias"])
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
