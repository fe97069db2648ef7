"""What decides `correct`: the program's first steps against the plain
reference's on the same weights, batches and generator seeds.

The numbers compared, each held to a limit of the cell's own
(`workloads/<cell>.json`, set from the program's readings over a dozen
seeds and more and from the precision control's and the faults'
readings, PERF.md). Each but `rank_gap` is the widest over the checked
steps:

- `loss_rel`: the relative gap of a step's loss (the views, both models,
  the selector, Procrustes, CE and UW-SO);
- `geo_rel`: the same of the Procrustes loss alone, which UW-SO's
  weighting would dilute;
- `rank_gap`: the teacher layers' MP ranks, exact integers on both sides:
  the sum of their gaps over the layers and the checked steps (bf16 tokens
  put an eigenvalue at the Marchenko-Pastur edge now and then, which moves
  one rank by one);
- `mix_rel`: the mixing weights' logits, log w less its mean over the
  teacher layers (softmax(-d2 / tau) makes them -(d2 - mean d2) / tau: the
  principal-angle distances over the temperatures), over the layers whose
  ranks agree at that step: the norm of their gap over the reference's
  norm, at each extraction point's row;
- `grad_leaf`: the first gradient as the optimizer holds it (its second
  moment after step 1), by the worst leaf: the gap between the two norms
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger (the backward);
- `tau_grad_rel`: the same for the temperatures' leaf over its own norm,
  which the median leaf's would swamp;
- `update_leaf`: the parameters' change over the checked steps, by the
  worst leaf, measured as `grad_leaf` (the ScheduleFree update). Entries
  whose first reference gradient is under a thousandth of the median
  leaf's root-mean-square gradient move by round-off alone under Adam's
  normalization (a key's bias under the softmax, a slice of each fused qkv
  bias) and are left out, in both sides' change.

A cell compares the numbers its `limits` name.
"""

from __future__ import annotations

import importlib
import statistics
import sys
import time
from types import SimpleNamespace

import torch

TEMPERATURES = "selector.log_temperatures"


def _leaf_gaps(prog: dict, ref: dict, names) -> dict:
    floor = statistics.median(ref[n] for n in ref)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names}


def worst(gaps: dict) -> tuple[str, float]:
    name = max(gaps, key=gaps.get)
    return name, gaps[name]


def _rel(prog, ref) -> float:
    return abs(float(prog) - float(ref)) / max(abs(float(ref)), 1e-30)


def mixing_logits(weights: torch.Tensor, layers: torch.Tensor) -> torch.Tensor:
    """(P, L') log-weights of the teacher `layers` (a mask over L), less
    each row's mean over them."""
    logw = weights.double().clamp(min=1e-300).log()[:, layers]
    return logw - logw.mean(dim=-1, keepdim=True)


def _mix_gap(p: dict, r: dict) -> float:
    agree = p["mp_ranks"].long() == r["mp_ranks"].long()
    lp, lr = mixing_logits(p["mixing_weights"], agree), mixing_logits(r["mixing_weights"], agree)
    return float(((lp - lr).norm(dim=-1) / lr.norm(dim=-1).clamp(min=1e-30)).max())


def numbers(first, ref, leaves: dict | None = None) -> dict:
    """The compared numbers from the program's first steps (`steps`,
    `grad_norms`, `params`, as `harness.first_steps` reads them) and the
    reference's (`reference.<family>.run_steps`, which also gives the
    weights both started from); `leaves`, if given, receives each leaf's
    gradient and update gap."""
    pairs = list(zip(first.steps, ref["steps"]))
    widest = lambda key: max(_rel(p[key], r[key]) for p, r in pairs)
    rank_gap = sum(int((p["mp_ranks"].long() - r["mp_ranks"].long()).abs().sum())
                   for p, r in pairs)
    rg, grads, start = ref["grad_norms"], ref["grads"], ref["start"]
    rms = statistics.median(float(g.double().pow(2).mean().sqrt()) for g in grads.values())
    mask = {n: g >= 1e-3 * rms for n, g in grads.items()}
    moved = [n for n in mask if bool(mask[n].any())]
    change = lambda ps: {n: float((ps[n].double() - start[n].double())[mask[n]].norm())
                         for n in moved}
    grad = _leaf_gaps(first.grad_norms, rg, rg)
    update = _leaf_gaps(change(first.params), change(ref["params"]), moved)
    if leaves is not None:
        leaves.update(grad=grad, update=update)
    return {"loss_rel": widest("loss"), "geo_rel": widest("geo_loss"), "rank_gap": rank_gap,
            "mix_rel": max(_mix_gap(p, r) for p, r in pairs),
            "grad_leaf": worst(grad)[1],
            "tau_grad_rel": _rel(first.grad_norms[TEMPERATURES], rg[TEMPERATURES]),
            "update_leaf": worst(update)[1]}


def reference_run(cfg, seeds, batches, device, **kw) -> dict:
    """The reference's first steps on `batches`, in float32 with TF32 off,
    from the run's weights (`run_steps` readings)."""
    from benchmark.weights import make_weights

    ref = importlib.import_module(f"benchmark.reference.{cfg['family']}")
    s, t = cfg["student"], cfg["teacher"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        student_w = make_weights(s, seeds["student"], device)
        teacher_w = make_weights({**t, "img_size": s["img_size"], "num_classes": 0},
                                 seeds["teacher"], device)
        return ref.run_steps(cfg, student_w, teacher_w,
                            [tuple(map(torch.from_numpy, b)) for b in batches],
                            step_seed=seeds["step"], selector_seed=seeds["selector"],
                            k=cfg["basd"]["subspace_k"], **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def as_first(run: dict):
    """A reference run's readings in the shape `numbers` takes for the
    program's, for a reference put in the program's place."""
    return SimpleNamespace(steps=run["steps"], grad_norms=run["grad_norms"],
                           params=run["params"])


def judge(cfg, seeds, batches, first, limits, device) -> dict:
    """{number: {"value", "limit"}} for the program's checked steps."""
    t0 = time.perf_counter()
    ref = reference_run(cfg, seeds, batches, device)
    print(f"judge: the reference's {len(batches)} steps took "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    leaves = {}
    got = numbers(first, ref, leaves)
    for kind, gaps in leaves.items():
        print("judge: worst {} leaves {}".format(kind, sorted(
            gaps.items(), key=lambda kv: -kv[1])[:3]), file=sys.stderr)
    return {name: {"value": got[name], "limit": limit} for name, limit in limits.items()}
