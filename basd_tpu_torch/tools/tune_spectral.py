"""Sweep and iteration tuner for the spectral kernels, on Table-3 token
features: the port of `tools/tune_spectral.py`.

    python -m basd_tpu_torch.tools.tune_spectral

Three sections, each timed on the card with CUDA events after warm-up:

  1. the Jacobi eigenvalues kernel (K5) on the (L, D, D) teacher token
     covariances across sweep counts: time, error against float64 numpy
     `eigvalsh` and the Marchenko-Pastur ranks against LAPACK's;
  2. the Jacobi eigh kernel (K3) on the (P * L, K, K) Grams of the masked
     student-teacher cross bases across sweep counts: time and the error
     of the weighted principal-angle distance d^2 against LAPACK;
  3. the `topk_basis` (g_iters, polar_iters) grid on the teacher side:
     time, the weighted sin^2 subspace error and the singular-value error
     against the exact LAPACK top-k basis.

The inputs are token features of the staged models, not iid Gaussians:
Gram spectra of tokens are far more anisotropic, and convergence depends
on that. Weights are random from seeds (DINOv2 ViT-B/14 teacher, DeiT-Tiny
student with patch 4 at 32 px, batch 128, the `dual_view` of seed 0).
fp32 products run in full fp32 (TF32 off).
"""

from __future__ import annotations

import contextlib
import numpy as np
import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.losses import extraction_points, init_selector
from basd_tpu_torch.models import create_student, extract_intermediates, load_teacher
from basd_tpu_torch.models.specs import resolve_preset
from basd_tpu_torch.ops.preprocess import dual_view, sample_view_draws
from basd_tpu_torch.spectral.jacobi_kernel import (
    kernel_jacobi_eigh,
    kernel_jacobi_eigvals,
)
from basd_tpu_torch.spectral.ops import topk_basis
from basd_tpu_torch.tools.timing import device_ms, fmt_ms

TEACHER_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
DATASET_STATS = ((0.5,) * 3, (0.25,) * 3)
K5_SWEEPS = (3, 4, 5, 6, 7, 9)
K3_SWEEPS = (4, 5, 6, 7, 9)
TOPK_GRID = ((3, 6), (4, 6), (4, 8), (4, 10), (5, 8), (6, 8), (6, 10), (6, 14))
_F32_EPS = float(np.finfo(np.float32).eps)


def stage(
    *, device=None, teacher: str = "dinov2_vitb14",
    student: str = "vit_tiny_patch16", img_size: int = 32, patch: int = 4,
    batch: int = 128, num_points: int = 4, seed: int = 0,
) -> dict:
    """Token features of the staged models on one `dual_view` batch:
    z_t (L, M, D_s) and z_s (P, M_s, D_s) through the selector's
    projections, and the teacher covariances cov = z_t^T z_t / M."""
    dev = resolve_device(device)
    bf16 = torch.bfloat16
    t = load_teacher(teacher, img_size=img_size, dtype=bf16, device=dev)
    points = extraction_points(resolve_preset(student).depth, num_points)
    s, cfg = create_student(
        student, num_classes=100, drop_path_rate=0.0, img_size=img_size,
        arch_overrides={"patch_size": patch}, capture_layers=points,
        dtype=bf16, device=dev,
    )
    sel = init_selector(1, len(points), cfg.embed_dim, t.spec.embed_dim,
                        device=dev)
    raw = img_size * 5 // 4  # crop_ratio 0.8
    rng = np.random.default_rng(seed)
    u8 = torch.from_numpy(
        (rng.random((batch, raw, raw, 3)) * 255).astype(np.uint8)).to(dev)
    draws = sample_view_draws(torch.Generator(device=dev).manual_seed(seed), batch)
    clean, aug = dual_view(u8, draws, img_size=img_size, crop_ratio=0.8,
                           teacher_stats=TEACHER_STATS,
                           dataset_stats=DATASET_STATS)
    with torch.no_grad():
        t_tokens, _ = extract_intermediates(t, clean)
        s_tokens = s(aug, train=False).tokens
        z_t = t_tokens.float().flatten(1, 2) @ sel.proj_t.T
        z_s = s_tokens.float().flatten(1, 2) @ sel.proj_s.T
        m = z_t.shape[1]
        cov = z_t.transpose(-1, -2) @ z_t / m
    return dict(t_tokens=tuple(t_tokens.shape), s_tokens=tuple(s_tokens.shape),
                z_t=z_t, z_s=z_s, cov=cov, m=m, device=dev)


def mp_ranks(w: np.ndarray, m: int) -> np.ndarray:
    """Marchenko-Pastur ranks from ascending eigenvalues (..., D)."""
    d = w.shape[-1]
    lam_plus = np.median(w, axis=-1) * (1 + (d / m) ** 0.5) ** 2
    return (w > lam_plus[..., None]).sum(-1)


def _d2(w_desc: np.ndarray, sw: np.ndarray) -> np.ndarray:
    """Weighted principal-angle distance from descending Gram eigenvalues."""
    sig = np.sqrt(np.clip(w_desc, 0, None))
    th = np.arccos(np.clip(sig, None, 1 - _F32_EPS))
    return (sw * th**2).sum(-1) / sw.sum(-1)


def main(
    *, device=None, k: int = 96, k5_sweeps=K5_SWEEPS, k3_sweeps=K3_SWEEPS,
    topk_grid=TOPK_GRID, reps: int = 10, staged: dict | None = None,
    **stage_kw,
) -> dict:
    """Run the three sections; returns their rows. `staged`, a result of
    `stage`, is used in place of staging the models again."""
    dev = resolve_device(device)
    with _fp32_products(), torch.no_grad():
        return _sections(dev, k, k5_sweeps, k3_sweeps, topk_grid, reps,
                         staged or stage(device=dev, **stage_kw))


@contextlib.contextmanager
def _fp32_products():
    """HIGHEST-precision products: TF32 off for the tool's run only."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _sections(dev, k, k5_sweeps, k3_sweeps, topk_grid, reps, st) -> dict:
    z_t, z_s, cov, m = st["z_t"], st["z_s"], st["cov"], st["m"]
    print(f"teacher tokens {st['t_tokens']}  student tokens {st['s_tokens']}")
    out = {"device": str(dev), "cov_shape": tuple(cov.shape)}

    # ---- exact LAPACK answers on the host ----
    cov_np = cov.cpu().numpy()
    w_exact = np.linalg.eigvalsh(cov_np.astype(np.float64))
    d = cov.shape[-1]
    rank_exact = mp_ranks(w_exact, m)
    print(f"exact MP ranks: {rank_exact}")

    print(f"\n== jacobi eigenvalues kernel (MP path, shape {tuple(cov.shape)}) ==")
    out["k5"] = []
    for sweeps in k5_sweeps:
        w = kernel_jacobi_eigvals(cov, sweeps=sweeps).cpu().numpy()
        rank = mp_ranks(w.astype(np.float64), m)
        relerr = float(np.max(np.abs(w - w_exact)
                              / np.abs(w_exact).max(-1, keepdims=True)))
        ms = device_ms(lambda: kernel_jacobi_eigvals(cov, sweeps=sweeps),
                       dev, reps)
        ok = bool((rank == rank_exact).all())
        out["k5"].append(dict(sweeps=sweeps, ms=ms, relerr=relerr,
                              ranks_equal=ok, ranks=rank.tolist()))
        print(f"sweeps={sweeps}  {fmt_ms(ms)}  max-relerr={relerr:.2e} "
              f"ranks {'OK ' if ok else 'DIFF'} {rank}")

    # ---- angle-path eigh: Gram of the masked cross bases (K x K) ----
    k = min(k, d)
    p = z_s.shape[0]
    basis_t, svals_t = topk_basis(z_t, k)
    basis_s, _ = topk_basis(z_s, k)
    ranks = torch.from_numpy(np.clip(rank_exact, 1, k)).to(dev)
    mask = (torch.arange(k, device=dev)[None, :] < ranks[:, None]).float()
    cross = torch.einsum("pdi,ldj->plij", basis_s, basis_t)
    cross = cross * mask[None, :, None, :]
    gram = torch.einsum("plij,plkj->plik", cross, cross).reshape(-1, k, k)
    gram = gram.contiguous()
    w_c_exact = np.linalg.eigvalsh(gram.cpu().numpy().astype(np.float64))[:, ::-1]
    sw_rep = np.tile((svals_t * mask).cpu().numpy(), (p, 1))
    d2_exact = _d2(w_c_exact, sw_rep)

    print(f"\n== jacobi eigh kernel (angle path, shape {tuple(gram.shape)}) ==")
    out["k3"] = []
    for sweeps in k3_sweeps:
        w, _ = kernel_jacobi_eigh(gram, sweeps=sweeps)
        err = float(np.max(np.abs(_d2(w.cpu().numpy(), sw_rep) - d2_exact)))
        ms = device_ms(lambda: kernel_jacobi_eigh(gram, sweeps=sweeps),
                       dev, reps)
        out["k3"].append(dict(sweeps=sweeps, ms=ms, d2_err=err))
        print(f"sweeps={sweeps}  {fmt_ms(ms)}  max-d2-err={err:.2e}")

    # ---- topk_basis grid, against the exact LAPACK top-k basis ----
    z_np = z_t.cpu().numpy().astype(np.float64)
    zc = z_np - z_np.mean(1, keepdims=True)
    w_g, v_g = np.linalg.eigh(np.einsum("lmd,lme->lde", zc, zc))
    basis_exact = v_g[..., ::-1][..., :k]
    svals_exact = np.sqrt(np.clip(w_g[..., ::-1][..., :k], 0, None))

    print(f"\n== topk_basis (teacher side, shape {tuple(z_t.shape)} k = {k}) ==")
    out["topk"] = []
    for g_iters, polar_iters in topk_grid:
        run = lambda: topk_basis(z_t, k, g_iters=g_iters, polar_iters=polar_iters)
        b_c, s_c = run()
        proj = np.einsum("ldi,ldj->lij", b_c.cpu().numpy(), basis_exact)
        sines2 = 1 - np.clip((proj**2).sum(1), 0, 1)
        werr = float(((svals_exact**2 * sines2).sum(-1)
                      / (svals_exact**2).sum(-1)).max())
        serr = float(np.max(np.abs(s_c.cpu().numpy() - svals_exact)
                            / svals_exact[:, :1]))
        ms = device_ms(run, dev, reps)
        out["topk"].append(dict(g_iters=g_iters, polar_iters=polar_iters,
                                ms=ms, weighted_sin2_err=werr, sval_relerr=serr))
        print(f"g_iters={g_iters} polar={polar_iters:2d}  {fmt_ms(ms)}  "
              f"weighted-sin2-err={werr:.2e} sval-relerr={serr:.2e}")
    return out


if __name__ == "__main__":
    main()
