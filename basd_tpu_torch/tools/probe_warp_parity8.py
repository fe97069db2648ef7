"""The batched flip + warp on the card and on the CPU, and sample 4 alone on
each, and who disagrees with whom: the port of `tools/probe_warp_parity8.py`.

    python -m basd_tpu_torch.tools.probe_warp_parity8

At (256, 224, 224, 3), with the JAX probe's images and parameter mix
(`probe_warp_kernel.probe_inputs`), the production entry
`ops/warp_kernel.py:fused_geometric_warp` runs on each device (K4 on the
card, its plain version on the CPU): the batch flipped by its mask then
warped, and sample 4 alone with its own flip (none at the full size, as in
the JAX probe). `warp_params` is taken on each device beside it for the
report. It prints the JAX probe's four max differences of sample 4 (CPU
batched against CPU alone, against the card batched and the card alone,
and the card batched against the card alone), then the whole batch card
against CPU, and the params' eight columns card against CPU. The JAX probe
needs two processes and a file; here both devices are in one. Every
difference must be 0.0: on one that is not, it names the pair, and the
rows and params columns where the two devices' params differ, and exits 1.
`main(device="cpu", **SMOKE)` runs it small with the CPU on both sides, at
a size whose draws rotate sample 4 by 135 degrees.
"""

from __future__ import annotations

import sys

import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.ops import warp_kernel as wk
from basd_tpu_torch.tools.probe_warp_kernel import probe_inputs

SMOKE = dict(b=15, n=24)  # sample 4 rotated by 135 degrees, 7 rows geometric
SAMPLE = 4


def side(x, vals, flip, device: torch.device) -> dict:
    """On `device`: the params, the batched flip + warp and sample 4 alone;
    all returned on the CPU."""
    to = lambda v: v.to(device)
    vals, flip = tuple(map(to, vals)), to(flip)
    one = slice(SAMPLE, SAMPLE + 1)
    batched = wk.fused_geometric_warp(to(x), *vals, flip)
    iso = wk.fused_geometric_warp(to(x[one]), *(v[one] for v in vals), flip[one])
    return dict(params=wk.warp_params(*vals, flip).cpu(), batched=batched.cpu(),
                iso=iso[0].cpu())


def differences(cpu: dict, card: dict) -> dict[str, float]:
    """The max absolute differences, by pair."""
    d = lambda a, b: float((a - b).abs().max())
    return {
        "cpu-batched vs cpu-iso4": d(cpu["batched"][SAMPLE], cpu["iso"]),
        "cpu-batched vs card-batched": d(cpu["batched"][SAMPLE], card["batched"][SAMPLE]),
        "cpu-batched vs card-iso4": d(cpu["batched"][SAMPLE], card["iso"]),
        "card-batched vs card-iso4": d(card["batched"][SAMPLE], card["iso"]),
        "cpu vs card, whole batch": d(cpu["batched"], card["batched"]),
        "cpu vs card, params": d(cpu["params"], card["params"]),
    }


def check(diffs: dict[str, float], cpu: dict, card: dict) -> None:
    """Raise unless every difference is 0.0, naming the pairs that broke and
    the (row, column) entries where the two devices' params differ."""
    broke = [k for k, v in diffs.items() if v != 0.0]
    if broke:
        rows, cols = torch.nonzero(cpu["params"] != card["params"], as_tuple=True)
        raise AssertionError(f"warp parity broke in {broke}; params differ at (row, column) "
                             f"{list(zip(rows.tolist(), cols.tolist()))}")


def main(*, device=None, b: int = 256, n: int = 224) -> dict:
    """Print each difference; raise if one is not 0.0. Returns them."""
    dev = resolve_device(device)
    x, vals, flip = probe_inputs(b, n)
    cpu = side(x, vals, flip, torch.device("cpu"))
    card = side(x, vals, flip, dev)
    diffs = differences(cpu, card)
    for tag, v in diffs.items():
        print(f"{tag:<27}: {v:.3e}", flush=True)
    check(diffs, cpu, card)
    return diffs


if __name__ == "__main__":
    try:
        main()
    except AssertionError as err:
        print(err, flush=True)
        sys.exit(1)
