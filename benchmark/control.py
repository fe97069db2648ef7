"""The readings that set a cell's limits: the program's own, and from
above the precision control's and the planted faults', each put in the
program's place and compared with the float32 reference as a run compares
the program.

    python -m benchmark.control --workload <cell> --seeds <n> [<n> ...] [--smoke]

Per seed one JSON line of the compared numbers (`judge.numbers`) of
- `program`: the port's first steps, staged as a run stages them;
- `control`: the reference with every value that the configuration
  computes in bf16 (both models' weights, activations, products and
  residual streams, the teacher tokens and the selector's projection of
  them, and the gradients the backward hands back through each) rounded
  to float8 e4m3, one scale per tensor: the nearest precision below the
  bf16 the configurations state;
- `half_batch`: the reference with half of each batch left out and the
  mean taken over the rest;
- `flat_selector`: the reference with every principal-angle distance taken
  as 0 (uniform mixing weights);
- `mp_rank_short`: the reference with every teacher layer's MP rank one
  short (before the cap at K).
A step that leaves the state unchanged reads 1 on `update_leaf` and
`grad_leaf` by their definition and needs no run. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch

from benchmark import harness, judge

VARIANTS = (("control", {"fp8": True}), ("half_batch", {"fault": "half_batch"}),
            ("flat_selector", {"fault": "flat_selector"}),
            ("mp_rank_short", {"fault": "mp_rank_short"}))


def readings(spec, cfg, seed: int, device) -> dict:
    seeds = harness.derive_seeds(seed)
    stage = importlib.import_module(f"benchmark.stage.{cfg['family']}")
    prog, feed, first = harness.first_steps(stage, cfg, spec.traffic, seeds, device)
    batches = feed.kept
    del prog, feed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = judge.reference_run(cfg, seeds, batches, device)
    out = {"seed": seed, "program": judge.numbers(first, ref)}
    for name, kw in VARIANTS:
        alt = judge.reference_run(cfg, seeds, batches, device, **kw)
        out[name] = judge.numbers(judge.as_first(alt), ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--smoke", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    if args.smoke:
        cfg, device = harness.smoke_config(spec.config), torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("control: needs a CUDA device", file=sys.stderr)
            return 2
        cfg, device = spec.config, torch.device("cuda", 0)
        torch.cuda.set_device(device)
    for seed in args.seeds:
        print(json.dumps(readings(spec, cfg, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
