"""The selector's components one by one, at the Table-1 shapes by default:
the port of `tools/probe_selector_internals.py`.

    python -m basd_tpu_torch.tools.probe_selector_internals [--t3] [--teacher dinov2_vitl14]

Shapes (L teacher layers, batch B, N_t teacher tokens of width D_t, P
extraction points, N_s student tokens of width D_s, subspace K): Table-1
with the ViT-B/14 teacher by default (12, 256, 257, 768, 4, 197, 384, 200),
`--t3` Table-3's (12, 128, 5, 768, 4, 65, 192, 48), and `--teacher
dinov2_vitl14` the literal Table-1 teacher's 24 layers of 1024 at K = 192,
where the selector's eighs run on cuSOLVER. Each component is the mean of
`--n` calls by CUDA events after warm-up (`tools/timing.py:device_ms`):

  proj_t          (L, M_t, D_t) x (D_s, D_t) token projection
  ranks           Marchenko-Pastur ranks (Householder + Sturm), (L, D_s, D_s)
  topk_t, topk_s  subspace iteration and Rayleigh-Ritz eigh, teacher / student
  topk_s iter     the student's, from its Gram, forward and forward+backward
  topk_s eigh     a full eigh of the student's Gram instead, likewise
  angles          masked principal-angle distances of the (P, L) pairs
  angles_g        the same, forward and backward w.r.t. the student basis
  select          the whole `select_and_mix` forward

It prints which eigh route each of the selector's three batched eighs takes
(teacher and student Rayleigh-Ritz, the principal angles): K3's pingpong or
packed_log route, or `torch.linalg.eigh`. The tokens are standard normal
times 0.5 in bf16 and the importances uniform, drawn on the device from
seed 0 (the JAX probe draws them with numpy; 1.6e9 host draws at ViT-L/14
width take longer than the probe). `--model-tokens` feeds the models'
own tokens instead, as the train step does: the arm's teacher and student
(random weights from seeds, bench's staging) on the eval view of bench's
images, since an iterative eigh converges in a number of sweeps that
depends on the spectrum. `main(argv, device="cpu", **SMOKE)` runs the JAX
probe's smoke shapes on the CPU, where no time is measured.
"""

from __future__ import annotations

import argparse
from functools import partial

import numpy as np
import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.losses.selector import _project, init_selector, select_and_mix
from basd_tpu_torch.spectral.jacobi_kernel import eigh_route
from basd_tpu_torch.spectral.ops import (
    _eigh_desc,
    centered_gram,
    marchenko_pastur_rank,
    masked_principal_angle_distance,
    topk_basis,
    topk_basis_gram,
    use_jacobi,
)
from basd_tpu_torch.tools import DATASET_STATS, TEACHER_STATS
from basd_tpu_torch.tools.timing import fmt_ms, stage_ms

TABLE1 = dict(l_t=12, b=256, n_t=257, d_t=768, p=4, n_s=197, d_s=384, k=200)
TABLE3 = dict(l_t=12, b=128, n_t=5, d_t=768, p=4, n_s=65, d_s=192, k=48)
# the literal Table-1 teacher, DINOv2 ViT-L/14, at the calibrated K of the
# train step (PERF.md §4)
VITL14 = dict(l_t=24, d_t=1024, k=192)
# the JAX probe's BASD_PROBE_SMOKE shapes
SMOKE = dict(l_t=3, b=4, n_t=17, d_t=48, p=2, n_s=10, d_s=24, k=8)


def eigh_route_name(shape) -> str:
    """The route of the selector's eigh (`spectral/ops.py:_EighSafe`) on a
    batch of this shape."""
    if use_jacobi(shape):
        return f"K3 {eigh_route(shape[-1] + shape[-1] % 2)}"
    return "torch.linalg.eigh"


def model_tokens(dev, teacher_name: str, t3: bool, batch: int, img_size: int):
    """(teacher tokens (L, B, N_t, D_t), student tokens (P, B, N_s, D_s),
    teacher importance (L, B, N_t)) of bench's arm on the eval view of
    `batch` images from `default_rng(0)` (raw size img + 2 patch)."""
    from basd_tpu_torch.losses import extraction_points
    from basd_tpu_torch.models import create_student, extract_intermediates, load_teacher
    from basd_tpu_torch.ops.preprocess import eval_view

    bf16 = torch.bfloat16
    teacher = load_teacher(teacher_name, img_size=img_size, dtype=bf16, device=dev)
    student, cfg = create_student(
        "vit_tiny_patch16" if t3 else "vit_small_patch16", num_classes=1000,
        drop_path_rate=0.0, img_size=img_size,
        arch_overrides={"patch_size": 4} if t3 else None,
        capture_layers=extraction_points(12, 4), dtype=bf16, remat=False, device=dev)
    raw = img_size + 2 * cfg.patch_size
    images = torch.from_numpy((np.random.default_rng(0).random((batch, raw, raw, 3)) * 255
                               ).astype(np.uint8)).to(dev)
    with torch.no_grad():
        t_tokens, t_imp = extract_intermediates(
            teacher, eval_view(images, img_size, img_size / raw, *TEACHER_STATS))
        s_tokens = student(eval_view(images, img_size, img_size / raw, *DATASET_STATS),
                           train=False).tokens
    return t_tokens, s_tokens, t_imp


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t3", action="store_true", help="Table-3 shapes")
    ap.add_argument("--teacher", default=None,
                    help="dinov2_vitl14: the ViT-L/14 teacher's 24 x 1024 at K 192")
    ap.add_argument("--model-tokens", action="store_true",
                    help="the models' tokens on bench's images instead of normals")
    ap.add_argument("--n", type=int, default=12, help="timed calls per component")
    args = ap.parse_args(argv)
    if args.teacher not in (None, "dinov2_vitb14", "dinov2_vitl14"):
        ap.error(f"--teacher takes dinov2_vitb14 or dinov2_vitl14, not {args.teacher}")
    return args


def main(argv=None, *, device=None, img_size: int | None = None, **shapes) -> dict:
    """Print one line per component and the eigh routes; returns
    {component: ms} (None on the CPU) and {"routes": {eigh: route}}.
    Keyword `shapes` override the arm's (l_t, b, n_t, d_t, p, n_s, d_s, k);
    with `--model-tokens` the models' tokens set all but b and k, and
    `img_size` the image (the arm's 32 or 224 px by default)."""
    args = parse_args(argv)
    dev = resolve_device(device)
    sh = dict(TABLE3 if args.t3 else TABLE1)
    if args.teacher == "dinov2_vitl14":
        sh.update(VITL14)
    sh.update(shapes)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.model_tokens:
        t_tokens, s_tokens, t_imp = model_tokens(
            dev, args.teacher or "dinov2_vitb14", args.t3, sh["b"],
            img_size or (32 if args.t3 else 224))
        (sh["l_t"], _, sh["n_t"], sh["d_t"]), (sh["p"], _, sh["n_s"], sh["d_s"]) = (
            t_tokens.shape, s_tokens.shape)
    l_t, b, n_t, d_t, p, n_s, d_s, k = (sh[x] for x in
                                         ("l_t", "b", "n_t", "d_t", "p", "n_s", "d_s", "k"))
    print(f"shapes: L={l_t} B={b} N_t={n_t} D_t={d_t} P={p} N_s={n_s} D_s={d_s} K={k}; "
          f"{'the models' if args.model_tokens else 'normal'} tokens", flush=True)
    if not args.model_tokens:
        t_tokens = (torch.randn((l_t, b, n_t, d_t), generator=gen, device=dev) * 0.5
                    ).to(torch.bfloat16)
        s_tokens = (torch.randn((p, b, n_s, d_s), generator=gen, device=dev) * 0.5
                    ).to(torch.bfloat16)
        t_imp = torch.rand((l_t, b, n_t), generator=gen, device=dev)
    sel = init_selector(1, p, d_s, d_t, device=dev)
    results: dict = {}

    def report(name: str, fn) -> None:
        results[name] = stage_ms(fn, dev, args.n)
        print(f"{name:<16s}: {fmt_ms(results[name])}", flush=True)

    t_flat = t_tokens.reshape(l_t, b * n_t, d_t)
    s_flat = s_tokens.float().reshape(p, b * n_s, d_s)
    # the selector's own projection (`losses/selector.py:_project`)
    proj_t = lambda: _project(t_flat, sel.proj_t)
    with torch.no_grad():
        z_t = proj_t()
        z_s = s_flat @ sel.proj_s.T
        report("proj_t", proj_t)
        report("ranks", lambda: marchenko_pastur_rank(z_t))
        report("topk_t", lambda: topk_basis(z_t, k))
        report("topk_s", lambda: topk_basis(z_s, k))
        g_s = centered_gram(z_s)

    def grad_of(fn):
        def fb():
            g = g_s.detach().requires_grad_(True)
            return torch.autograd.grad(fn(g), g)
        return fb

    # the student-basis alternatives: the differentiated iteration against
    # a full eigh of the Gram
    with torch.no_grad():
        report("topk_s iter fwd", lambda: topk_basis_gram(g_s, k))
    report("topk_s iter f+b", grad_of(lambda g: (topk_basis_gram(g, k)[0] ** 2).sum()))
    with torch.no_grad():
        report("topk_s eigh fwd", lambda: _eigh_desc(g_s)[1][..., :k])
    report("topk_s eigh f+b", grad_of(lambda g: (_eigh_desc(g)[1][..., :k] ** 2).sum()))

    with torch.no_grad():
        basis_t, svals_t = topk_basis(z_t, k)
        basis_s, _ = topk_basis(z_s, k)
        ranks = torch.clamp(marchenko_pastur_rank(z_t), 1, k)

    def angles(bs):
        return masked_principal_angle_distance(bs[:, None], basis_t[None],
                                               svals_t[None], ranks[None])

    with torch.no_grad():
        report("angles", lambda: angles(basis_s))

    def angles_g():
        bs = basis_s.detach().requires_grad_(True)
        return torch.autograd.grad(angles(bs).sum(), bs)

    report("angles_g", angles_g)
    with torch.no_grad():
        report("select", partial(select_and_mix, sel, s_tokens, t_tokens, t_imp,
                                 subspace_k=k))
    # the three batched eighs of `select_and_mix` at its K (capped by the
    # token counts as the selector caps it)
    kk = min(k, d_s - 1, b * n_s, b * n_t)
    results["routes"] = {
        "teacher Rayleigh-Ritz": ((l_t, kk, kk), eigh_route_name((l_t, kk, kk))),
        "student Rayleigh-Ritz": ((p, kk, kk), eigh_route_name((p, kk, kk))),
        "principal angles": ((p, l_t, kk, kk), eigh_route_name((p, l_t, kk, kk))),
    }
    for name, (shape, route) in results["routes"].items():
        print(f"eigh route {name} {shape}: {route}", flush=True)
    return results


if __name__ == "__main__":
    main()
