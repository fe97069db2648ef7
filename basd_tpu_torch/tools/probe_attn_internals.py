"""Which pass of the attention forward takes the time, at the teacher's
attention shape (B = 256, H = 12, N = 257, hd = 64, bf16): the port of
`tools/probe_attn_internals.py`.

    python -m basd_tpu_torch.tools.probe_attn_internals [variant ...]

Runs the attention-probe kernel (K6, `ops/attn_probe.py`) in each of its
six variants, which drop or change one pass of a softmax-free forward
(full -> tilemax -> nomax -> bf16exp -> noexp -> mxonly), and prints each
one's time (CUDA events after warm-up) and rate with the JAX tool's FLOP
count, 4 B H N^2 hd. Beside them it times the port's softmax attention
forward (K1) on the same q, k, v in K1's (B, N, H * hd) layout, the real
forward whose redesign the probe informs. The variants compute wrong math
on purpose; their outputs are for timing only.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.ops.attention import attention_forward
from basd_tpu_torch.ops.attn_probe import VARIANTS, probe_attention, probe_flops
from basd_tpu_torch.tools.timing import device_ms, fmt_ms


def make_inputs(b, h, n, hd, device, seed: int = 0):
    """q, k, v (B, H, N, hd) bf16 from numpy normal(0, 1) * 0.1, in the
    JAX tool's draw order."""
    rng = np.random.default_rng(seed)
    mk = lambda: torch.from_numpy(
        rng.normal(size=(b, h, n, hd)).astype(np.float32) * 0.1
    ).to(torch.bfloat16).to(device)
    return mk(), mk(), mk()


def main(
    *, device=None, batch: int = 256, heads: int = 12, seq: int = 257,
    head_dim: int = 64, group: int = 8, variants=VARIANTS, reps: int = 10,
) -> dict:
    """Print and return each variant's ms and TF/s, and K1's beside them."""
    dev = resolve_device(device)
    b, h, n, hd = batch, heads, seq, head_dim
    q, k, v = make_inputs(b, h, n, hd, dev)
    tf = probe_flops(b, h, n, hd) / 1e12
    rate = lambda ms: "" if ms is None else f" ({tf / (ms * 1e-3):6.1f} TF/s)"
    out = {"shape": (b, h, n, hd), "variants": {}}
    for variant in variants:
        o = probe_attention(q, k, v, variant=variant, group=group)
        if not bool(torch.isfinite(o.float()).all()):
            raise AssertionError(f"{variant}: non-finite output")
        ms = device_ms(lambda: probe_attention(q, k, v, variant=variant,
                                               group=group), dev, reps)
        out["variants"][variant] = ms
        print(f"{variant:8s}: {fmt_ms(ms)}{rate(ms)}", flush=True)

    # the real forward at the same shape: K1 takes (B, N, H * hd), q scaled
    native = lambda x: x.transpose(1, 2).reshape(b, n, h * hd).contiguous()
    qn, kn, vn = native(q * hd**-0.5), native(k), native(v)
    ms = device_ms(lambda: attention_forward(qn, kn, vn, hd), dev, reps)
    out["attention_fwd"] = ms
    print(f"{'K1 fwd':8s}: {fmt_ms(ms)}{rate(ms)} (softmax attention, "
          f"({b}, {n}, {h * hd}) H={h})", flush=True)
    return out


if __name__ == "__main__":
    main(variants=tuple(sys.argv[1:]) or VARIANTS)
