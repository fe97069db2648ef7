"""The BASD loss stack with the tokens as inputs, at Table-1's shapes: the
port of `tools/probe_loss_tail.py`.

    python -m basd_tpu_torch.tools.probe_loss_tail [--teacher dinov2_vitl14]

Times, each the mean of `--n` calls by CUDA events after warm-up
(`tools/timing.py:device_ms`), with the student's and the teacher's token
stacks given as inputs, so that the selector's backward, Procrustes, the
token interpolation and UW-SO are apart from the models' graphs:

  selector fwd       `select_and_mix` at K = 192 (bench.py --imagenet's K)
  basd_loss fwd      the whole loss
  basd_loss fwd+bwd  the loss and its gradients w.r.t. the student tokens,
                     the log-temperatures and the logits
  schedule-free adamw update
                     one update of the train step's optimizer on the real
                     parameter list (the student's and the
                     log-temperatures), gradients of ones

The teacher stack has the teacher's depth (12 layers of ViT-B/14, 24 of
ViT-L/14 with `--teacher dinov2_vitl14`), as the train step feeds the
selector; the JAX probe fed the extraction points' 4. Tokens are standard
normal, the importances a softmax of normals, drawn on the device from seed
0. `main(argv, device="cpu", **SMOKE)` runs the JAX probe's smoke shapes on
the CPU, where no time is measured.
"""

from __future__ import annotations

import argparse

import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.losses import basd_loss, extraction_points, init_selector
from basd_tpu_torch.losses.selector import select_and_mix
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.tools.timing import fmt_ms, stage_ms
from basd_tpu_torch.training.schedule_free import ScheduleFreeAdamW

# the JAX probe's BASD_PROBE_SMOKE shapes
SMOKE = dict(img_size=56, batch=4, num_classes=16, k=8)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--teacher", default="dinov2_vitb14")
    ap.add_argument("--n", type=int, default=8, help="timed calls per stage")
    return ap.parse_args(argv)


def main(argv=None, *, device=None, img_size: int = 224, batch: int = 256,
         num_classes: int = 1000, k: int = 192) -> dict:
    """Print one line per stage; returns {stage: ms} (None on the CPU)."""
    args = parse_args(argv)
    dev = resolve_device(device)
    bf16 = torch.bfloat16
    teacher = load_teacher(args.teacher, img_size=img_size, dtype=bf16, device=dev)
    points = extraction_points(12, 4)
    student, cfg = create_student(
        "vit_small_patch16", num_classes=num_classes, img_size=img_size,
        drop_path_rate=0.05, capture_layers=points, dtype=bf16, device=dev)
    selector = init_selector(1, len(points), cfg.embed_dim, teacher.spec.embed_dim,
                             device=dev)
    p, l_t = len(points), teacher.spec.depth
    n_s, n_t = cfg.num_patches + 1, teacher.num_tokens  # the JAX probe's counts
    d_s, d_t = cfg.embed_dim, teacher.spec.embed_dim
    print(f"shapes: student tokens ({p}, {batch}, {n_s}, {d_s}), teacher tokens "
          f"({l_t}, {batch}, {n_t}, {d_t}), K={k}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    s_tok = randn(p, batch, n_s, d_s).to(bf16)
    t_tok = randn(l_t, batch, n_t, d_t).to(bf16)
    t_imp = torch.softmax(randn(l_t, batch, n_t), dim=-1)
    logits = randn(batch, num_classes)
    labels = torch.randint(0, num_classes, (batch,), generator=gen, device=dev)
    onehot = torch.nn.functional.one_hot(labels, num_classes).float()
    results: dict = {}

    def report(label: str, name: str, fn) -> None:
        results[name] = stage_ms(fn, dev, args.n)
        print(f"{label} {fmt_ms(results[name])}", flush=True)

    def select():
        with torch.no_grad():
            return select_and_mix(selector, s_tok, t_tok, t_imp, subspace_k=k)[0]

    report("selector fwd:       ", "selector fwd", select)

    def loss_of(s, lt, lg):
        sel = selector._replace(log_temperatures=lt)
        return basd_loss(sel, lg, onehot, s, t_tok, t_imp, label_smoothing=0.01,
                         subspace_k=k)[0]

    def loss_fwd():
        with torch.no_grad():
            return loss_of(s_tok, selector.log_temperatures, logits)

    report("basd_loss fwd:      ", "basd_loss fwd", loss_fwd)

    def loss_grad():
        leaves = [s_tok.detach().requires_grad_(True),
                  selector.log_temperatures.detach().requires_grad_(True),
                  logits.detach().requires_grad_(True)]
        return torch.autograd.grad(loss_of(*leaves), leaves)

    report("basd_loss fwd+bwd:  ", "basd_loss fwd+bwd", loss_grad)

    # one update of the train step's optimizer on its real parameter list
    params = [*student.parameters(), selector.log_temperatures]
    opt = ScheduleFreeAdamW(params, 5e-4, weight_decay=0.05, warmup_steps=1000)
    for q in params:
        q.grad = torch.ones_like(q)
    report("schedule-free adamw update:", "schedule-free adamw update", opt.step)
    return results


if __name__ == "__main__":
    main()
