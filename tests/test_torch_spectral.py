"""Spectral core of the port (`basd_tpu_torch/spectral/`) held against the
JAX package on the CPU: the plain Jacobi eigh (the kernel's plain version)
against `jacobi_eigh` and the interpret-mode Pallas kernel, the eigh
backward, Marchenko-Pastur ranks, the top-k basis, singular values, the
pair nuclear norm and the masked principal-angle distance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.spectral import ops as jops
from basd_tpu.spectral.jacobi import jacobi_eigh as jax_jacobi_eigh
from basd_tpu.spectral.pallas_jacobi import pallas_jacobi_eigh
from basd_tpu_torch.spectral import jacobi as tjacobi
from basd_tpu_torch.spectral import ops as tops
from basd_tpu_torch.spectral.jacobi_kernel import kernel_jacobi_eigh
from test_torch_helpers import assert_close, planted_tokens, psd, t32, to_np

torch.set_num_threads(1)


def _matched_columns(v1, v2, w, min_gap):
    """|cos| between matching eigenvector columns whose eigenvalue is
    separated from its neighbours by more than min_gap * max|w|."""
    out = []
    for b in range(w.shape[0]):
        gaps = np.abs(np.diff(w[b]))
        scale = np.abs(w[b]).max()
        for i in range(w.shape[1]):
            left = gaps[i - 1] if i > 0 else np.inf
            right = gaps[i] if i < len(gaps) else np.inf
            if min(left, right) > min_gap * scale:
                out.append(abs(float(v1[b, :, i] @ v2[b, :, i])))
    return np.asarray(out)


@pytest.mark.parametrize("shape", [(6, 48, 48), (5, 33, 33)])
def test_plain_jacobi_matches_jax_and_pallas_interpret(shape):
    """sweeps=6, fp32. Eigenvalues within 1e-4 of max|w|: the same rotation
    sequence on both sides, rounding amplified by the tail sweeps=6 leaves
    unconverged. Eigenvectors with a gap > 5% of max|w| agree to
    |cos| > 1 - 1e-4."""
    a = psd(*shape[:2], seed=shape[1])
    w, v = tjacobi.jacobi_eigh(t32(a), sweeps=6)
    wk, vk = kernel_jacobi_eigh(t32(a), sweeps=6)  # CPU tensor: plain version
    assert torch.equal(w, wk) and torch.equal(v, vk)
    for name, (jw, jv) in {
        "jacobi_eigh": jax_jacobi_eigh(jnp.asarray(a), sweeps=6),
        "pallas interpret": pallas_jacobi_eigh(jnp.asarray(a), sweeps=6,
                                               interpret=True),
    }.items():
        assert_close(w, jw, 1e-4, f"eigenvalues vs {name}")
        cos = _matched_columns(to_np(v), np.asarray(jv), np.asarray(jw), 0.05)
        assert cos.size > 0 and cos.min() > 1 - 1e-4, (name, cos.min())
    # descending order, orthonormal vectors (fp32 floor of ~280 rotations)
    assert np.all(np.diff(to_np(w), axis=-1) <= 0)
    vtv = to_np(v.transpose(-1, -2) @ v)
    np.testing.assert_allclose(vtv, np.broadcast_to(np.eye(shape[1]), vtv.shape),
                               atol=5e-5)


def _eigh_loss_jax(a, c, s):
    w, v = jops._eigh_desc(a)
    return jnp.sum(c * w) + jnp.sum(jnp.einsum("bji,bjk,bki->bi", v, s, v))


def _eigh_loss_torch(a, c, s):
    w, v = tops._eigh_desc(a)
    return (c * w).sum() + torch.einsum("bji,bjk,bki->bi", v, s, v).sum()


@pytest.mark.parametrize("shape,rtol", [
    ((2, 12, 12), 1e-4),  # outside the Jacobi gate: LAPACK on both sides
    ((6, 24, 24), 1e-3),  # inside: plain Jacobi vs LAPACK forward
])
def test_eigh_desc_gradient_matches_jax_vjp(shape, rtol):
    """The gap-regularized eigh backward against jax.grad through the JAX
    custom JVP, on a sign-invariant loss sum(c w) + sum_i v_i^T S v_i;
    rtol of scale: 1e-4 with the same forward, 1e-3 with the Jacobi one."""
    rng = np.random.default_rng(7)
    a = psd(*shape[:2], seed=11)
    c = rng.standard_normal(shape[:2]).astype(np.float32)
    s = rng.standard_normal(shape).astype(np.float32)
    s = (s + s.transpose(0, 2, 1)) / 2
    jg = jax.grad(_eigh_loss_jax)(jnp.asarray(a), jnp.asarray(c), jnp.asarray(s))
    ta = t32(a).requires_grad_(True)
    _eigh_loss_torch(ta, t32(c), t32(s)).backward()
    assert_close(ta.grad, jg, rtol, "d loss / dA")


def test_eigh_backward_gradcheck_float64():
    """torch.autograd.gradcheck of the custom backward in float64 (outside
    the Jacobi gate, so the forward is LAPACK in float64) on w and the
    sign-invariant v * v."""
    a = torch.from_numpy(psd(2, 6, seed=3).astype(np.float64))
    a = (a + a.transpose(-1, -2)).requires_grad_(True)

    def fn(x):
        w, v = tops._eigh_desc(x)
        return w, v * v

    assert torch.autograd.gradcheck(fn, (a,), eps=1e-6, atol=1e-5, rtol=1e-4)


def _planted_grams(b, m, d, seed):
    x = planted_tokens((b, m, d), rank=d // 6, seed=seed)
    return np.einsum("bmd,bme->bde", x, x).astype(np.float32), m


@pytest.mark.parametrize("d", [48, 96])
def test_mp_rank_gram_exactly_equal(d):
    """Householder + Sturm MP ranks: exactly the JAX package's ranks and
    the float64 numpy oracle's on planted-rank Grams."""
    g, m = _planted_grams(6, 512, d, seed=d)
    got = tops.marchenko_pastur_rank_gram(t32(g), m).numpy()
    want = np.asarray(jops.marchenko_pastur_rank_gram(jnp.asarray(g), m))
    np.testing.assert_array_equal(got, want)
    ev = np.linalg.eigvalsh(g.astype(np.float64) / m)
    lp = np.median(ev, -1) * (1 + (d / m) ** 0.5) ** 2
    np.testing.assert_array_equal(got, (ev > lp[:, None]).sum(-1))
    assert got.min() > 0 and got.max() < d


def test_mp_rank_small_d_uses_eigvalsh_median():
    g, m = _planted_grams(3, 64, 6, seed=5)
    got = tops.marchenko_pastur_rank_gram(t32(g), m).numpy()
    want = np.asarray(jops.marchenko_pastur_rank_gram(jnp.asarray(g), m))
    np.testing.assert_array_equal(got, want)


def test_topk_basis_gram_projectors_and_gradient():
    """Top-k basis of a centered Gram (4, 64, 64) with a planted rank of
    k=24 (directions past the planted rank sit below the fp32 resolution of
    six normalized power steps, so both sides would return noise there):
    the (4, 24, 24) Rayleigh-Ritz eigh runs the plain Jacobi here and LAPACK
    in JAX. Singular values within 1e-5 of scale, the top-8 projector
    within 1e-4, the gradient of a loss on both within 1e-3."""
    x = planted_tokens((4, 256, 64), rank=24, seed=3)
    xc = x - x.mean(1, keepdims=True)
    g = np.einsum("bmd,bme->bde", xc, xc).astype(np.float32)
    rng = np.random.default_rng(4)
    cw = rng.standard_normal((4, 24)).astype(np.float32)
    mm = rng.standard_normal((4, 64, 64)).astype(np.float32)

    def jloss(g):
        basis, sv = jops.topk_basis_gram(g, 24)
        p = jnp.einsum("bdk,bek->bde", basis[..., :8], basis[..., :8])
        return jnp.sum(cw * sv) + jnp.sum(p * mm), (basis, sv)

    (jl, (jb, js)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(g))
    tg = t32(g).requires_grad_(True)
    basis, sv = tops.topk_basis_gram(tg, 24)
    p = basis[..., :8] @ basis[..., :8].transpose(-1, -2)
    loss = (t32(cw) * sv).sum() + (p * t32(mm)).sum()
    loss.backward()
    assert_close(sv, js, 1e-5, "singular values")
    jp = np.einsum("bdk,bek->bde", np.asarray(jb)[..., :8], np.asarray(jb)[..., :8])
    assert_close(p, jp, 1e-4, "top-8 projector")
    assert_close(tg.grad, jg, 1e-3, "gradient")
    with torch.no_grad():
        nb, ns = tops.topk_basis_gram_nograd(t32(g), 24)
    assert torch.equal(nb, basis.detach()) and torch.equal(ns, sv.detach())


@pytest.mark.parametrize("shape", [(3, 8, 20), (2, 20, 8)])
def test_svdvals_psd_values_and_gradient(shape):
    """Values within 1e-5 of scale and the subgradient VJP within 1e-4
    against the JAX custom VJP (LAPACK eigh on both sides)."""
    rng = np.random.default_rng(sum(shape))
    a = rng.standard_normal(shape).astype(np.float32)
    c = rng.standard_normal((shape[0], min(shape[1:]))).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda x: jnp.sum(c * jops.svdvals_psd(x)))(jnp.asarray(a))
    ta = t32(a).requires_grad_(True)
    sv = tops.svdvals_psd(ta)
    (t32(c) * sv).sum().backward()
    assert_close(sv, np.linalg.svd(a, compute_uv=False), 1e-5, "svdvals")
    assert_close(ta.grad, jg, 1e-4, "svdvals gradient")


def test_nuclear_norm_pair_gram_values_and_gradients():
    """tr((G_t G_s)^1/2) and its custom VJP against the JAX package: 5e-5
    of scale for the value and 1e-4 for the gradients (fp32 rounding through
    seven coupled quintic steps, in another summation order on each side);
    1e-4 for the value against numpy's SVD of S^T T (the truncated
    schedule's own error)."""
    # well-conditioned Grams: on a near-singular one the polar factor's
    # gradient W^-1/2 amplifies rounding far beyond the value's error
    rng = np.random.default_rng(1)
    s = rng.standard_normal((3, 16, 40)).astype(np.float32)
    t = rng.standard_normal((3, 16, 56)).astype(np.float32)
    gs = np.einsum("bnd,bmd->bnm", s, s).astype(np.float32)
    gt = np.einsum("bnd,bmd->bnm", t, t).astype(np.float32)
    cw = np.array([1.0, -0.5, 2.0], np.float32)
    jv = jops.nuclear_norm_pair_gram(jnp.asarray(gs), jnp.asarray(gt))
    jgs, jgt = jax.grad(
        lambda a, b: jnp.sum(cw * jops.nuclear_norm_pair_gram(a, b)), (0, 1)
    )(jnp.asarray(gs), jnp.asarray(gt))
    tgs, tgt = (t32(x).requires_grad_(True) for x in (gs, gt))
    val = tops.nuclear_norm_pair_gram(tgs, tgt)
    (t32(cw) * val).sum().backward()
    assert_close(val, jv, 5e-5, "value")
    want = np.linalg.svd(np.einsum("bnd,bne->bde", s, t), compute_uv=False).sum(-1)
    assert_close(val, want, 1e-4, "value vs SVD")
    assert_close(tgs.grad, jgs, 1e-4, "dG_s")
    assert_close(tgt.grad, jgt, 1e-4, "dG_t")


def test_masked_principal_angle_distance_value_and_gradient():
    """All (P, L) pairs at once, as the selector calls it: distances within
    1e-4 of scale and the gradient to the student basis within 1e-3 (the
    (12, 16, 16) spectra run the plain Jacobi here, LAPACK in JAX)."""
    rng = np.random.default_rng(9)
    p_, l_, d, k = 2, 6, 32, 16
    bs = np.linalg.qr(rng.standard_normal((p_, d, k)))[0].astype(np.float32)
    bt = np.linalg.qr(rng.standard_normal((l_, d, k)))[0].astype(np.float32)
    # partly shared subspaces, angles well away from 0 (where the arccos
    # derivative diverges and amplifies rounding without bound)
    bt[:3] = np.linalg.qr(bt[:3] + 0.7 * bs[:1])[0]
    svals = np.sort(rng.random((l_, k)).astype(np.float32) * 5, axis=-1)[:, ::-1].copy()
    ranks = np.array([3, 5, 8, 12, 16, 1], np.int32)
    cw = rng.standard_normal((p_, l_)).astype(np.float32)

    def jfn(b):
        d2 = jops.masked_principal_angle_distance(
            b[:, None], jnp.asarray(bt)[None], jnp.asarray(svals)[None],
            jnp.asarray(ranks)[None])
        return jnp.sum(cw * d2), d2

    (_, jd2), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(bs))
    tb = t32(bs).requires_grad_(True)
    d2 = tops.masked_principal_angle_distance(
        tb[:, None], t32(bt)[None], t32(svals)[None],
        torch.from_numpy(ranks)[None])
    (t32(cw) * d2).sum().backward()
    assert_close(d2, jd2, 1e-4, "distances")
    assert_close(tb.grad, jg, 1e-3, "gradient")


def test_topk_basis_values_and_gradient_to_the_tokens():
    """`topk_basis` from (4, 256, 64) tokens with a planted rank of k=24
    (past it both sides return noise): singular values within 1e-5 of
    scale, the top-8 projector within 1e-4 and the gradient of a loss on
    both to the tokens within 1e-3, as for `topk_basis_gram`."""
    x = planted_tokens((4, 256, 64), rank=24, seed=13)
    rng = np.random.default_rng(14)
    cw = rng.standard_normal((4, 24)).astype(np.float32)
    mm = rng.standard_normal((4, 64, 64)).astype(np.float32)

    def jloss(z):
        basis, sv = jops.topk_basis(z, 24)
        p = jnp.einsum("bdk,bek->bde", basis[..., :8], basis[..., :8])
        return jnp.sum(cw * sv) + jnp.sum(p * mm), (basis, sv)

    (_, (jb, js)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    tz = t32(x).requires_grad_(True)
    basis, sv = tops.topk_basis(tz, 24)
    p = basis[..., :8] @ basis[..., :8].transpose(-1, -2)
    ((t32(cw) * sv).sum() + (p * t32(mm)).sum()).backward()
    assert basis.shape == (4, 64, 24) and sv.shape == (4, 24)
    assert_close(sv, js, 1e-5, "singular values")
    jp = np.einsum("bdk,bek->bde", np.asarray(jb)[..., :8], np.asarray(jb)[..., :8])
    assert_close(p, jp, 1e-4, "top-8 projector")
    assert_close(tz.grad, jg, 1e-3, "gradient to the tokens")


@pytest.mark.parametrize("shape,rtol", [
    ((3, 40, 12), 5e-4),  # D = 12: torch.linalg.eigh here, jnp.linalg.eigh there
    ((4, 96, 24), 1e-3),  # D = 24 in the Jacobi gate: plain Jacobi here
])
def test_grassmann_basis_values_and_gradient(shape, rtol):
    """Full basis and singular values of the centered tokens: singular
    values within 1e-5 of scale (against numpy's SVD too), the projector on
    the planted top-4 directions within rtol, and the gradient of a loss on
    both within rtol: 5e-4 with two library eigensolvers (their fp32
    eigenvectors differ by rounding, which the eigenvector backward's
    1 / gap amplifies), 1e-3 with the plain Jacobi forward."""
    b, m, d = shape
    x = planted_tokens(shape, rank=4, seed=d)
    rng = np.random.default_rng(d + 1)
    cw = rng.standard_normal((b, d)).astype(np.float32)
    mm = rng.standard_normal((b, d, d)).astype(np.float32)

    def jloss(z):
        basis, sv = jops.grassmann_basis(z)
        p = jnp.einsum("bdk,bek->bde", basis[..., :4], basis[..., :4])
        return jnp.sum(cw * sv) + jnp.sum(p * mm), (basis, sv)

    (_, (jb, js)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    tz = t32(x).requires_grad_(True)
    basis, sv = tops.grassmann_basis(tz)
    p = basis[..., :4] @ basis[..., :4].transpose(-1, -2)
    ((t32(cw) * sv).sum() + (p * t32(mm)).sum()).backward()
    assert basis.shape == (b, d, d) and sv.shape == (b, d)
    assert_close(sv, js, 1e-5, "singular values")
    xc = x - x.mean(1, keepdims=True)
    assert_close(sv, np.linalg.svd(xc.astype(np.float64), compute_uv=False),
                 1e-5, "singular values vs numpy")
    jp = np.einsum("bdk,bek->bde", np.asarray(jb)[..., :4], np.asarray(jb)[..., :4])
    assert_close(p, jp, rtol, "top-4 projector")
    assert_close(tz.grad, jg, rtol, "gradient")


@pytest.mark.parametrize("shape,rtol", [
    ((3, 8, 20), 1e-4),   # small side 8: LAPACK on both sides
    ((2, 20, 8), 1e-4),   # transposed
    ((4, 24, 40), 1e-3),  # small side 24 in the Jacobi gate: plain Jacobi here
])
def test_nuclear_norm_value_and_gradient(shape, rtol):
    """The eigh nuclear norm and its U V^T backward against the JAX custom
    VJP: value within 1e-5 of scale (and of numpy's SVD), gradient within
    rtol (1e-4 with LAPACK on both sides, 1e-3 with the plain Jacobi)."""
    rng = np.random.default_rng(sum(shape))
    c = rng.standard_normal(shape).astype(np.float32)
    cw = rng.standard_normal(shape[0]).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda x: jnp.sum(cw * jops.nuclear_norm(x)))(jnp.asarray(c))
    tc = t32(c).requires_grad_(True)
    val = tops.nuclear_norm(tc)
    (t32(cw) * val).sum().backward()
    assert val.shape == (shape[0],)
    assert_close(val, np.asarray(jops.nuclear_norm(jnp.asarray(c))), 1e-5, "value")
    assert_close(val, np.linalg.svd(c.astype(np.float64), compute_uv=False).sum(-1),
                 1e-5, "value vs numpy")
    assert_close(tc.grad, jg, rtol, "gradient")


@pytest.mark.parametrize("shape", [(3, 16, 40), (2, 40, 16)])
def test_nuclear_norm_ns_value_and_gradient(shape):
    """Newton-Schulz polar nuclear norm (24 iterations) and its backward P
    against the JAX custom VJP: value within 1e-5 of scale, gradient within
    1e-4 (fp32 rounding through 24 cubic steps); value within 1e-3 of
    numpy's SVD (the truncated iteration's own error)."""
    rng = np.random.default_rng(sum(shape) + 1)
    c = rng.standard_normal(shape).astype(np.float32)
    cw = rng.standard_normal(shape[0]).astype(np.float32)
    jfn = lambda x: jnp.sum(cw * jops.nuclear_norm_ns(x))
    jg = jax.grad(jfn)(jnp.asarray(c))
    tc = t32(c).requires_grad_(True)
    val = tops.nuclear_norm_ns(tc)
    (t32(cw) * val).sum().backward()
    assert_close(val, np.asarray(jops.nuclear_norm_ns(jnp.asarray(c))), 1e-5, "value")
    assert_close(val, np.linalg.svd(c.astype(np.float64), compute_uv=False).sum(-1),
                 1e-3, "value vs numpy")
    assert_close(tc.grad, jg, 1e-4, "gradient")


def test_nuclear_norm_pair_values_and_gradients():
    """||S^T T||_nuc on the token side and its two-sided backward against
    the JAX custom VJP: 5e-5 of scale for the value and 1e-4 for both
    gradients, as for `nuclear_norm_pair_gram`; 1e-4 for the value against
    numpy's SVD of S^T T."""
    rng = np.random.default_rng(21)
    s = rng.standard_normal((3, 16, 40)).astype(np.float32)
    t = rng.standard_normal((3, 16, 56)).astype(np.float32)
    cw = np.array([1.0, -0.5, 2.0], np.float32)
    jv = jops.nuclear_norm_pair(jnp.asarray(s), jnp.asarray(t))
    jgs, jgt = jax.grad(
        lambda a, b: jnp.sum(cw * jops.nuclear_norm_pair(a, b)), (0, 1)
    )(jnp.asarray(s), jnp.asarray(t))
    ts, tt = (t32(x).requires_grad_(True) for x in (s, t))
    val = tops.nuclear_norm_pair(ts, tt)
    (t32(cw) * val).sum().backward()
    assert_close(val, jv, 5e-5, "value")
    want = np.linalg.svd(np.einsum("bnd,bne->bde", s, t), compute_uv=False).sum(-1)
    assert_close(val, want, 1e-4, "value vs SVD")
    assert_close(ts.grad, jgs, 1e-4, "dS")
    assert_close(tt.grad, jgt, 1e-4, "dT")


def test_spectral_package_exports_the_jax_package_names():
    import basd_tpu.spectral as jspec
    import basd_tpu_torch.spectral as tspec

    names = [n for n in dir(jspec) if not n.startswith("_")
             and callable(getattr(jspec, n)) and n not in ("ops",)]
    assert names and all(callable(getattr(tspec, n)) for n in names), names
