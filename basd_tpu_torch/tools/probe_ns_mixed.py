"""Per-step precision schedules of the Newton-Schulz square root behind the
Procrustes nuclear norm: the port of `tools/probe_ns_mixed.py`.

    python -m basd_tpu_torch.tools.probe_ns_mixed

`ns_value` is tr((G_t G_s)^1/2) by the seven scheduled quintic steps of
`spectral/ops.py:_ns_sqrt_pair`, with every product of step k in precision
`precs[k]`. The JAX probe mixes DEFAULT (one bf16 pass on the MXU) with
HIGH (bf16 x 3); here "bf16" is bf16 operands with fp32 accumulation, and
"fp32" the port's shipping fp32 products (`spectral/ops.py:12-13`). "tf32"
is the card's other low precision: fp32 operands with TF32 switched on
around that step's products only (`probe_ns_precision._tf32`). The four
schedules of the JAX probe run beside its three mixed ones with TF32 in
place of bf16.

Inputs are the JAX probe's, draw for draw: bp pairs of (n, n)
decaying-spectrum Grams from numpy seeds 1 and 2, at Table-1's loss-tail
shape (1024 pairs of 197 tokens, d = 64). The oracle is float64 `eigvals`
on the host over the first 64 pairs. Per schedule it prints the relative
error's max and median and the ms per call: the mean of 16 calls (the
JAX probe's count) by CUDA events after warm-up (`tools/timing.py:device_ms`).
`main(device="cpu", **SMOKE)` runs the JAX probe's smoke shape on the CPU,
where bf16 rounds the operands as on the card, TF32 does not exist and no
time is measured.
"""

from __future__ import annotations

import numpy as np
import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.spectral.ops import _NS_SQRT_SCHED, _frob
from basd_tpu_torch.tools.probe_ns_precision import _tf32
from basd_tpu_torch.tools.timing import device_ms, fmt_ms

SMOKE = dict(bp=8, n_tok=17, d=12)
ORACLE_PAIRS = 64
TIMED_CALLS = 16


def schedules(k: int = len(_NS_SQRT_SCHED)) -> tuple[tuple[str, tuple[str, ...]], ...]:
    """(name, per-step precisions): the JAX probe's four (DEFAULT -> bf16,
    HIGH -> fp32), then its three mixed ones with TF32 for bf16."""
    out = [("all-fp32 (shipping)", ("fp32",) * k)]
    for low in ("bf16", "tf32"):
        out += [(f"{low}*5 + fp32*2", (low,) * (k - 2) + ("fp32",) * 2),
                (f"{low}*4 + fp32*3", (low,) * (k - 3) + ("fp32",) * 3),
                (f"all-{low}", (low,) * k)]
    return tuple(out)


def _mm(p: torch.Tensor, q: torch.Tensor, prec: str) -> torch.Tensor:
    """p @ q in fp32 out of `prec` operands. bf16: on the card one bf16
    pass of the tensor cores accumulating in fp32 (`bmm` with
    out_dtype); on the CPU the same products of bf16-rounded operands,
    summed in fp32."""
    if prec == "bf16":
        p, q = p.to(torch.bfloat16), q.to(torch.bfloat16)
        if p.is_cuda:
            return torch.bmm(p, q, out_dtype=torch.float32)
        return p.float() @ q.float()
    with _tf32(prec == "tf32"):
        return p @ q


def ns_value(gs: torch.Tensor, gt: torch.Tensor, precs) -> torch.Tensor:
    """tr((G_t G_s)^1/2) by the scheduled quintic with step k's products in
    precision `precs[k]` (len == len(_NS_SQRT_SCHED)); the Gram product and
    trace of `spectral/ops.py:_sqrt_trace`, as the JAX probe's `ns_value`."""
    if len(precs) != len(_NS_SQRT_SCHED):
        raise ValueError(f"{len(precs)} precisions for {len(_NS_SQRT_SCHED)} steps")
    w = gt @ gs
    scale = _frob(w)
    a = w / scale
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    y, z = a, eye.expand(a.shape).contiguous()
    for (ca, cb, cc), prec in zip(_NS_SQRT_SCHED, precs):
        m = _mm(z, y, prec)
        t = ca * eye + cb * m + cc * _mm(m, m, prec)
        y = _mm(y, t, prec)
        z = _mm(t, z, prec)
    return torch.sqrt(scale[..., 0, 0]) * torch.diagonal(y, dim1=-2, dim2=-1).sum(-1)


def grams(seed: int, bp: int, n_tok: int, d: int) -> np.ndarray:
    """The JAX probe's decaying-spectrum token Grams, draw for draw."""
    r = np.random.default_rng(seed)
    u = r.standard_normal((bp, n_tok, d))
    u = u * np.geomspace(1.0, 1e-3, d)
    return (u @ u.transpose(0, 2, 1)).astype(np.float32)


def main(*, device=None, bp: int = 1024, n_tok: int = 197, d: int = 64) -> dict:
    """Print one line per schedule; returns {name: readings}."""
    dev = resolve_device(device)
    gs_np, gt_np = grams(1, bp, n_tok, d), grams(2, bp, n_tok, d)
    want = np.array([
        np.sqrt(np.clip(np.linalg.eigvals(
            gt_np[i].astype(np.float64) @ gs_np[i].astype(np.float64)).real, 0.0, None)).sum()
        for i in range(min(bp, ORACLE_PAIRS))
    ])
    gs, gt = torch.from_numpy(gs_np).to(dev), torch.from_numpy(gt_np).to(dev)
    results = {}
    with torch.no_grad():
        for name, precs in schedules():
            got = ns_value(gs, gt, precs).double().cpu().numpy()[: len(want)]
            rel = np.abs(got - want) / np.abs(want)
            ms = device_ms(lambda: ns_value(gs, gt, precs), dev, reps=TIMED_CALLS, warmup=3)
            results[name] = dict(relerr_max=float(rel.max()),
                                 relerr_median=float(np.median(rel)), ms=ms)
            print(f"{name:<22}: relerr max {rel.max():.2e} median {np.median(rel):.2e}; "
                  f"{fmt_ms(ms)}", flush=True)
    return results


if __name__ == "__main__":
    main()
