"""One teacher block dissected at the Table-1 shape: the port of
`tools/probe_teacher_block.py`.

    python -m basd_tpu_torch.tools.probe_teacher_block [--gelu]

A DINOv2 ViT-B/14 block (D 768, 12 heads, LayerScale 1e-5) on bf16 tokens
(256, 257, 768): the whole block, its attention half (qkv, K1, proj and
the CLS importance), its MLP half, one LayerNorm, and the bare pieces (the
qkv product, K1 alone on the qkv slices, the CLS importance). `--gelu`
times fc1 and fc2 with each activation between them instead: none, erf
GELU (the model's, in fp32), tanh GELU, ReLU and erf GELU in bf16. Each
line is the mean of `--n` calls by CUDA events after warm-up
(`tools/timing.py:device_ms`); inputs are normals times 0.02 drawn on the
device from seed 0, weights torch's default initialization under seed 0.
`main(argv, device="cpu", **SMOKE)` runs a small block on the CPU, where no
time is measured.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.models.vit import Block, ViTConfig, _layer_norm
from basd_tpu_torch.ops.activations import gelu
from basd_tpu_torch.ops.attention import fused_attention
from basd_tpu_torch.tools.timing import fmt_ms, stage_ms

SMOKE = dict(b=4, n=17, d=64, h=2)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gelu", action="store_true",
                    help="time the MLP's activation variants instead")
    ap.add_argument("--n", type=int, default=20, help="timed calls per line")
    return ap.parse_args(argv)


def main(argv=None, *, device=None, b: int = 256, n: int = 257, d: int = 768,
         h: int = 12) -> dict:
    """Print one line per piece; returns {piece: ms} (None on the CPU)."""
    args = parse_args(argv)
    dev = resolve_device(device)
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev) * 0.02
    x = randn(b, n, d).to(dt)
    results: dict = {}

    def report(label: str, fn) -> None:
        results[label.rstrip(": ")] = ms = stage_ms(fn, dev, args.n)
        print(f"{label} {fmt_ms(ms)}", flush=True)

    if args.gelu:
        w1, w2 = randn(d, 4 * d).to(dt), randn(4 * d, d).to(dt)
        with torch.no_grad():
            report("fc1+fc2 (no act):  ", lambda: (x @ w1) @ w2)
            report("fc1+erf-gelu+fc2:  ", lambda: gelu(x @ w1) @ w2)
            report("fc1+tanh-gelu+fc2: ", lambda: F.gelu(
                (x @ w1).float(), approximate="tanh").to(dt) @ w2)
            report("fc1+relu+fc2:      ", lambda: F.relu(x @ w1) @ w2)
            report("fc1+bf16-erf+fc2:  ", lambda: F.gelu(x @ w1) @ w2)
        return results

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        block = Block(ViTConfig(embed_dim=d, num_heads=h, layer_scale_init=1e-5), 0.0)
    block = block.to(dev).requires_grad_(False)
    hd = d // h
    with torch.no_grad():
        report("full block:        ", lambda: block(x, dt, None, None))
        report("attn (qkv+core+proj+imp):", lambda: block.attn(x, dt))
        report("mlp (fc1+gelu+fc2):      ", lambda: block.mlp(x, dt))
        report("layernorm:         ", lambda: _layer_norm(x, block.norm1))
        wqkv = randn(d, 3 * d).to(dt)
        report("qkv matmul:        ", lambda: x @ wqkv)
        qkv = randn(b, n, 3 * d).to(dt)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        report("fused attn core:   ", lambda: fused_attention(q, k, v, hd))
        report("cls importance:    ", lambda: block.attn._cls_importance(q, k, hd**-0.5))
    return results


if __name__ == "__main__":
    main()
