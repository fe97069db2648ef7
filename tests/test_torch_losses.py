"""The port's selector and losses (`basd_tpu_torch/losses/`) held against
the JAX package on the CPU with the JAX selector's own projections:
`select_and_mix`, `procrustes_loss_mixed` (Gram route with token-count
alignment, and the explicit-alignment route) and `basd_loss`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.losses import basd_loss as jax_basd_loss
from basd_tpu.losses import init_selector as jax_init_selector
from basd_tpu.losses import select_and_mix as jax_select_and_mix
from basd_tpu.losses.procrustes import procrustes_loss_mixed as jax_procrustes_mixed
from basd_tpu_torch.losses import basd_loss, select_and_mix
from basd_tpu_torch.losses.procrustes import procrustes_loss_mixed
from basd_tpu_torch.models.convert import selector_state_from_numpy
from test_torch_helpers import CPU, assert_close, planted_tokens, t32

torch.set_num_threads(1)

P, B, NS, DS = 2, 4, 16, 32
L, NT, DT = 6, 16, 48


def _setting(seed=0):
    rng = np.random.default_rng(seed)
    s_tok = np.stack([planted_tokens((B * NS, DS), rank=6, seed=seed + i)
                      for i in range(P)]).reshape(P, B, NS, DS)
    t_tok = np.stack([planted_tokens((B * NT, DT), rank=3 + i, seed=100 + i)
                      for i in range(L)]).reshape(L, B, NT, DT)
    imp = rng.random((L, B, NT)).astype(np.float32) + 0.1
    imp /= imp.sum(-1, keepdims=True)
    jsel = jax_init_selector(jax.random.PRNGKey(seed), P, DS, DT)
    tsel = selector_state_from_numpy(
        np.asarray(jsel.log_temperatures), np.asarray(jsel.proj_s),
        np.asarray(jsel.proj_t), device=CPU)
    return s_tok, t_tok, imp, jsel, tsel


def test_select_and_mix_matches_jax():
    """MP ranks exactly equal; mixing weights within 2e-3 (the tolerance the
    JAX package allows its own LAPACK-vs-Jacobi eigh swap, here the
    teacher Rayleigh-Ritz (6, 31, 31) and the (12, 31, 31) angle spectra
    run the plain Jacobi); distances within 1e-3 of scale; mixed tokens and
    importance within 2e-3 of scale (convex mixes under those weights)."""
    s_tok, t_tok, imp, jsel, tsel = _setting()
    jm, ji, jaux = jax_select_and_mix(
        jsel, jnp.asarray(s_tok), jnp.asarray(t_tok), jnp.asarray(imp))
    tm, ti, taux = select_and_mix(tsel, t32(s_tok), t32(t_tok), t32(imp))
    ranks = taux["mp_ranks"].numpy()
    np.testing.assert_array_equal(ranks, np.asarray(jaux["mp_ranks"]))
    assert len(set(ranks.tolist())) > 1  # the planted ranks differ per layer
    np.testing.assert_allclose(taux["mixing_weights"].detach().numpy(),
                               np.asarray(jaux["mixing_weights"]), atol=2e-3)
    assert_close(taux["grassmann_d2"], jaux["grassmann_d2"], 1e-3, "d2")
    assert_close(tm, jm, 2e-3, "mixed tokens")
    assert_close(ti, ji, 2e-3, "mixed importance")
    np.testing.assert_allclose(taux["temperatures"].detach().numpy(), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("ns,ds,nt,dt", [
    (16, 32, 8, 48),  # Gram route, token counts aligned in Gram space
    (24, 16, 12, 20),  # N_s > D_s: explicit alignment, feature-side route
])
def test_procrustes_loss_mixed_value_and_gradients(ns, ds, nt, dt):
    """Value within 1e-4 relative (it is tr + tr - 2 nuc, a difference of
    terms ~10x larger, so fp32 rounding of ~1e-6 in each shows as ~2e-5);
    gradients to the student and teacher tokens within 5e-3 of scale:
    centering leaves a null direction in each token Gram, where the polar
    factor's Z ~ W^-1/2 sits at the 1e-6 ridge and amplifies fp32
    rounding."""
    rng = np.random.default_rng(ns)
    s = rng.standard_normal((3, ns, ds)).astype(np.float32)
    t = rng.standard_normal((3, nt, dt)).astype(np.float32)
    w = (rng.random((3, nt)) + 0.2).astype(np.float32)
    (jv, (jgs, jgt)) = jax.value_and_grad(jax_procrustes_mixed, (0, 1))(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(w))
    ts, tt = (t32(x).requires_grad_(True) for x in (s, t))
    val = procrustes_loss_mixed(ts, tt, t32(w))
    val.backward()
    assert_close(val, jv, 1e-4, "value")
    assert_close(ts.grad, jgs, 5e-3, "d student")
    assert_close(tt.grad, jgt, 5e-3, "d teacher")


def test_basd_loss_value_and_gradients():
    """The full objective: loss within 1e-4 relative; CE exactly-ish (1e-6);
    gradients to the student tokens, logits and log-temperatures within
    1e-3 of scale (the selector's Jacobi-vs-LAPACK difference flows into
    the weights' gradient)."""
    s_tok, t_tok, imp, jsel, tsel = _setting(seed=1)
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((B, 10)).astype(np.float32)
    targets = np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)]

    def jfn(lg, st, lt):
        loss, aux = jax_basd_loss(
            jsel._replace(log_temperatures=lt), lg, jnp.asarray(targets), st,
            jnp.asarray(t_tok), jnp.asarray(imp), label_smoothing=0.1)
        return loss, aux

    (jl, jaux), jg = jax.value_and_grad(jfn, (0, 1, 2), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(s_tok), jsel.log_temperatures)
    tl, ts = t32(logits).requires_grad_(True), t32(s_tok).requires_grad_(True)
    loss, aux = basd_loss(tsel, tl, t32(targets), ts, t32(t_tok), t32(imp),
                          label_smoothing=0.1)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(aux["ce_loss"].detach()), float(jaux["ce_loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(aux["geo_loss"].detach()), float(jaux["geo_loss"]),
                               rtol=1e-4)
    assert_close(tl.grad, jg[0], 1e-3, "d logits")
    assert_close(ts.grad, jg[1], 1e-3, "d student tokens")
    assert_close(tsel.log_temperatures.grad, jg[2], 1e-3, "d log temperatures")
