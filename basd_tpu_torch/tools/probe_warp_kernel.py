"""The fused warp kernel K4 against the op-by-op tap sweep at Table-1's
augment shape (256, 224, 224, 3): the port of `tools/probe_warp_kernel.py`.

    python -m basd_tpu_torch.tools.probe_warp_kernel

Inputs are the JAX probe's, draw for draw (`probe_inputs`): uniform images
from `default_rng(0)` and TrivialAugment's parameter mix, 5 of 14 ops
geometric, one op per sample, half the samples flipped. Two paths:
  "tap sweep": the JAX probe's XLA path in its production form, the hflip
  conjugated through the warp (negated angle, shears and x translation,
  then the output flipped), over `augment._geometric_warp`, the port's
  op-by-op tap sweep (`warp_kernel.geometric_warp_plain`);
  "fused": `warp_kernel.fused_geometric_warp` (K4 on the card).
It prints their parity (max abs difference), each path's ms per call as
the JAX probe's slope (`tools/timing.py:slope_ms`, n1 = 6, n2 = 18), K4's
route (`warp_route`) and the bound: one read and one write of the batch at
3.35 TB/s. `main(device="cpu", **SMOKE)` runs the JAX probe's smoke shape
on the CPU, where both paths are torch ops and no time is measured.
"""

from __future__ import annotations

import numpy as np
import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.ops import augment
from basd_tpu_torch.ops import warp_kernel as wk
from basd_tpu_torch.tools.timing import fmt_ms, slope_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SMOKE = dict(b=8, n=32)


def probe_inputs(b: int, n: int):
    """(images (b, n, n, 3) fp32, (angle, shear_x, shear_y, trans_x,
    trans_y) fp32, flip bool) on the CPU, drawn as the JAX warp probes draw
    them from `default_rng(0)`."""
    rng = np.random.default_rng(0)
    x = rng.random((b, n, n, 3)).astype(np.float32)
    op = rng.integers(0, 14, b)
    mag = (rng.integers(0, 31, b) / 30.0) * np.where(rng.random(b) < 0.5, 1, -1)
    angle = np.where(op == 5, mag * 135.0 * np.pi / 180.0, 0).astype(np.float32)
    shx = np.where(op == 1, mag * 0.99, 0).astype(np.float32)
    shy = np.where(op == 2, mag * 0.99, 0).astype(np.float32)
    tx = np.where(op == 3, mag * 32.0, 0).astype(np.float32)
    ty = np.where(op == 4, mag * 32.0, 0).astype(np.float32)
    flip = rng.random(b) < 0.5
    t = torch.from_numpy
    return t(x), tuple(t(v) for v in (angle, shx, shy, tx, ty)), t(flip)


def tap_sweep_path(x, vals, flip):
    """The hflip conjugated through `augment._geometric_warp`."""
    angle, shx, shy, tx, ty = vals
    neg = torch.where(flip, -1.0, 1.0)
    out = augment._geometric_warp(x, angle * neg, shx * neg, shy * neg, tx * neg, ty)
    return torch.where(flip[:, None, None, None], out.flip(2), out)


def fused_path(x, vals, flip):
    return wk.fused_geometric_warp(x, *vals, flip)


def main(*, device=None, b: int = 256, n: int = 224) -> dict:
    """Print the parity, each path's ms and K4's route and bound; returns
    them."""
    dev = resolve_device(device)
    x, vals, flip = probe_inputs(b, n)
    x, vals, flip = x.to(dev), tuple(v.to(dev) for v in vals), flip.to(dev)
    sweep = lambda: tap_sweep_path(x, vals, flip)
    fused = lambda: fused_path(x, vals, flip)
    err = float((sweep() - fused()).abs().max())
    out = dict(parity_max_err=err, tap_sweep_ms=slope_ms(sweep, dev, n1=6, n2=18),
               fused_ms=slope_ms(fused, dev, n1=6, n2=18), route=wk.warp_route(n, 3),
               bound_ms=2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3)
    print(f"parity max err: {err:.3e}", flush=True)
    print(f"tap sweep (the xla path): {fmt_ms(out['tap_sweep_ms'])}", flush=True)
    print(f"fused: {fmt_ms(out['fused_ms'])} (route {out['route']}; bound "
          f"{out['bound_ms']:.4f} ms, one read and one write of {tuple(x.shape)} fp32)",
          flush=True)
    return out


if __name__ == "__main__":
    main()
