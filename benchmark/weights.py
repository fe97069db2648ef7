"""Seeded weights of a ViT under the timm/DINOv2 state-dict keys that the
port's modules load, made on the device in one draw.

Both sides of a run get these same tensors: the port loads them into its
modules, the reference reads them again from the same seed. Linear
kernels are N(0, 2 / fan_in), the patch convolution N(0, 2 / (p^2 D)),
the CLS token and positions N(0, 0.02^2); biases are 0, LayerNorm scales
1 and LayerScale gammas 1. A pretrained teacher's blocks change its
residual stream, so that its layers differ and the selector has layers to
choose between; at the initial LayerScale of 1e-5 every layer would carry
the same tokens and the mixing weights would stay uniform. Values are
float32, the type the port keeps its parameters in.
"""

from __future__ import annotations

import math

import torch

# every LayerScale gamma, where the model has LayerScale
LAYER_SCALE = 1.0


def vit_leaves(m: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, kind, value) of every parameter of the ViT that `m`
    sizes: kind "normal" (value = std), "fill" (value = constant)."""
    d, depth, p = m["embed_dim"], m["depth"], m["patch_size"]
    hidden = int(d * m["mlp_ratio"])
    tokens = (m["img_size"] // p) ** 2 + 1
    out = [("patch_embed.proj.weight", (d, 3, p, p), "normal", math.sqrt(2.0 / (p * p * d))),
           ("patch_embed.proj.bias", (d,), "fill", 0.0),
           ("cls_token", (1, 1, d), "normal", 0.02),
           ("pos_embed", (1, tokens, d), "normal", 0.02)]
    for i in range(depth):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (d,), "fill", 1.0), (b + "norm1.bias", (d,), "fill", 0.0),
                (b + "attn.qkv.weight", (3 * d, d), "normal", math.sqrt(2.0 / d)),
                (b + "attn.qkv.bias", (3 * d,), "fill", 0.0),
                (b + "attn.proj.weight", (d, d), "normal", math.sqrt(2.0 / d)),
                (b + "attn.proj.bias", (d,), "fill", 0.0),
                (b + "norm2.weight", (d,), "fill", 1.0), (b + "norm2.bias", (d,), "fill", 0.0),
                (b + "mlp.fc1.weight", (hidden, d), "normal", math.sqrt(2.0 / d)),
                (b + "mlp.fc1.bias", (hidden,), "fill", 0.0),
                (b + "mlp.fc2.weight", (d, hidden), "normal", math.sqrt(2.0 / hidden)),
                (b + "mlp.fc2.bias", (d,), "fill", 0.0)]
        if m.get("layer_scale_init") is not None:
            out += [(b + "ls1.gamma", (d,), "fill", LAYER_SCALE),
                    (b + "ls2.gamma", (d,), "fill", LAYER_SCALE)]
    out += [("norm.weight", (d,), "fill", 1.0), ("norm.bias", (d,), "fill", 0.0)]
    if m.get("num_classes", 0) > 0:
        out += [("head.weight", (m["num_classes"], d), "normal", math.sqrt(2.0 / d)),
                ("head.bias", (m["num_classes"],), "fill", 0.0)]
    return out


def make_weights(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The ViT's parameters by name: every normal leaf a scaled view of one
    standard-normal draw from a generator on `device` seeded with `seed`."""
    leaves = vit_leaves(m)
    total = sum(math.prod(shape) for _, shape, kind, _ in leaves if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, shape, kind, value in leaves:
        if kind == "normal":
            n = math.prod(shape)
            out[name] = flat[offset:offset + n].view(shape).mul_(value)
            offset += n
        else:
            out[name] = torch.full(shape, value, dtype=torch.float32, device=device)
    return out
