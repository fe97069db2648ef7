"""The student's backward dissected at the Table-1 shape: the port of
`tools/probe_student_bwd.py`.

    python -m basd_tpu_torch.tools.probe_student_bwd

ViT-S/16 at 224 px, batch 256, bf16, no remat (bench's composition):

  patch_embed   the 16 x 16 stride-16 convolution: forward, forward and
                backward w.r.t. its weights AND the input images (the case
                the JAX probe recorded: the train step never takes the
                image gradient), and the weight gradient alone
  patchify      the same contraction as a reshape and one product: its
                largest difference from the convolution, forward, weight
                gradient
  block         one block forward, and forward and backward w.r.t. its
                parameters and its input
  attn_half, mlp_half
                x + attn(LN(x)) and x + mlp(LN(x)), forward and backward
  student f+b base
                the whole student, CE, gradients w.r.t. its parameters
                (drop path 0.05), as the train step takes them

Each is the mean of `--n` calls by CUDA events after warm-up
(`tools/timing.py:device_ms`); inputs are normals drawn on the device from
seed 0. `main(argv, device="cpu", **SMOKE)` runs the JAX probe's smoke
shapes on the CPU, where no time is measured.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.losses import extraction_points
from basd_tpu_torch.models import create_student
from basd_tpu_torch.models.vit import Block, ViTConfig, _layer_norm
from basd_tpu_torch.tools.timing import fmt_ms, stage_ms

# the JAX probe's BASD_PROBE_SMOKE shapes
SMOKE = dict(b=4, n_tok=17, d=64, h=2, depth=3, img=32, patch=8)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20, help="timed calls per line")
    return ap.parse_args(argv)


def loss_of(y: torch.Tensor) -> torch.Tensor:
    return (y.float() * 1e-4).sum()


def main(argv=None, *, device=None, b: int = 256, n_tok: int = 197, d: int = 384,
         h: int = 6, depth: int = 12, img: int = 224, patch: int = 16) -> dict:
    """Print one line per piece; returns {piece: ms or the parity}."""
    args = parse_args(argv)
    dev = resolve_device(device)
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn((b, n_tok, d), generator=gen, device=dev) * 0.02).to(dt)
    imgs = torch.randn((b, img, img, 3), generator=gen, device=dev)
    results: dict = {}

    def report(label: str, fn) -> None:
        results[label.rstrip(": ")] = ms = stage_ms(fn, dev, args.n)
        print(f"{label} {fmt_ms(ms)}", flush=True)

    def grad(f, *leaves):
        def fb():
            ls = [t.detach().requires_grad_(True) for t in leaves]
            return torch.autograd.grad(f(*ls), ls)
        return fb

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        conv = torch.nn.Conv2d(3, d, patch, stride=patch)
        cfg = ViTConfig(embed_dim=d, num_heads=h)
        block = Block(cfg, 0.0)
        attn_norm, mlp_norm = torch.nn.LayerNorm(d, eps=1e-6), torch.nn.LayerNorm(d, eps=1e-6)
    conv, block = conv.to(dev), block.to(dev)
    attn_norm, mlp_norm = attn_norm.to(dev), mlp_norm.to(dev)
    cw, cb = conv.weight.detach(), conv.bias.detach()

    # ---- the patch embedding, as the student computes it ----
    def patch_embed(w, bias, im):
        return loss_of(F.conv2d(im.to(dt).permute(0, 3, 1, 2), w.to(dt), bias.to(dt),
                                stride=patch))

    with torch.no_grad():
        report("patch_embed fwd:   ", lambda: patch_embed(cw, cb, imgs))
    report("patch_embed f+b:   ", grad(patch_embed, cw, cb, imgs))
    report("patch_embed wgrad: ", grad(lambda w, bias: patch_embed(w, bias, imgs), cw, cb))

    # ---- the same contraction as a reshape and one product ----
    def patchify(w, bias, im):
        bb, hh, ww, cc = im.shape
        y = im.to(dt).reshape(bb, hh // patch, patch, ww // patch, patch, cc)
        y = y.permute(0, 1, 3, 5, 2, 4).reshape(bb, -1, cc * patch * patch)
        return y @ w.to(dt).reshape(d, -1).T + bias.to(dt)

    with torch.no_grad():
        y_conv = F.conv2d(imgs.to(dt).permute(0, 3, 1, 2), cw.to(dt), cb.to(dt),
                          stride=patch).flatten(2).transpose(1, 2)
        diff = (y_conv.float() - patchify(cw, cb, imgs).float()).abs().max().item()
    results["patchify parity"] = diff
    print(f"patchify parity:    max|conv-dot| = {diff:.3e}", flush=True)
    with torch.no_grad():
        report("patchify fwd:      ", lambda: loss_of(patchify(cw, cb, imgs)))
    report("patchify wgrad:    ",
           grad(lambda w, bias: loss_of(patchify(w, bias, imgs)), cw, cb))

    # ---- one block, its parameters and its input differentiated ----
    bparams = list(block.parameters())

    def block_grad():
        xi = x.detach().requires_grad_(True)
        return torch.autograd.grad(loss_of(block(xi, dt, None, None)[0]), [*bparams, xi])

    with torch.no_grad():
        report("block fwd:         ", lambda: loss_of(block(x, dt, None, None)[0]))
    report("block f+b:         ", block_grad)

    def half_grad(norm, fn):
        params = [*norm.parameters(), *fn.parameters()]

        def fb():
            xi = x.detach().requires_grad_(True)
            y = fn(_layer_norm(xi, norm), dt)
            y = y[0] if isinstance(y, tuple) else y
            return torch.autograd.grad(loss_of(xi + y), [*params, xi])
        return fb

    report("attn_half f+b:     ", half_grad(attn_norm, block.attn))
    report("mlp_half f+b:      ", half_grad(mlp_norm, block.mlp))

    # ---- the whole student, bench's composition ----
    smoke_arch = {"patch_size": patch, "embed_dim": d, "depth": depth, "num_heads": h}
    full = (patch, d, depth, h) == (16, 384, 12, 6)
    student, _ = create_student(
        "vit_small_patch16" if full else "vit_tiny_patch16",
        num_classes=1000 if full else 10, drop_path_rate=0.05, img_size=img,
        arch_overrides=None if full else smoke_arch,
        capture_layers=extraction_points(depth, 4), dtype=dt, remat=False, device=dev)
    labels = torch.from_numpy(np.random.default_rng(0).integers(0, 10, b)).to(dev)
    sparams = list(student.parameters())

    def student_grad():
        out = student(imgs, train=True, generator=gen)
        ce = -torch.log_softmax(out.logits, -1)[torch.arange(b, device=dev), labels].mean()
        return torch.autograd.grad(ce, sparams)

    report("student f+b base:", student_grad)
    return results


if __name__ == "__main__":
    main()
