"""The port's float64 oracle (`basd_tpu_torch/spectral/reference.py`) on the
CPU: bit for bit the JAX package's `spectral/reference.py`; its one
addition, `selector_d2_np`, against `selector_weights_np`; the port's torch
spectral ops and its selector against it at the JAX tests' tolerances; and
chip_smoke phase 5d's comparison on its planted input at small sizes, to
the bounds that phase holds the card to."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.losses import init_selector as jax_init_selector
from basd_tpu.losses import select_and_mix as jax_select_and_mix
from basd_tpu.spectral import reference as jref
from basd_tpu_torch.losses import init_selector, select_and_mix
from basd_tpu_torch.models.convert import selector_state_from_numpy
from basd_tpu_torch.spectral import ops as tops
from basd_tpu_torch.spectral import reference as tref
from basd_tpu_torch.spectral.tridiag import mp_rank_sturm
from test_torch_helpers import CPU, t32

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (phase 5d's planted input and comparison)

torch.set_num_threads(1)


def _low_rank_plus_noise(rng, m, d, rank, noise=0.05):
    """`tests/test_spectral.py`'s planted features."""
    u = rng.normal(size=(m, rank))
    v = rng.normal(size=(rank, d))
    scales = np.linspace(3.0, 1.0, rank)[:, None]
    return (u * scales.T) @ v / np.sqrt(rank) + noise * rng.normal(size=(m, d))


def _low_rank(rng, m, d, rank, noise=0.05):
    """`tests/test_losses.py`'s planted tokens."""
    u = rng.normal(size=(m, rank))
    v = rng.normal(size=(rank, d))
    return u @ v / np.sqrt(rank) + noise * rng.normal(size=(m, d))


def _selector_setting(seed=7, p=2, l=4, b=2, n_s=12, n_t=16, d_s=8, d_t=12):
    """`tests/test_losses.py`'s selector setting: random student tokens,
    teacher layers with planted ranks 2..l+1, the JAX selector's state."""
    rng = np.random.default_rng(seed)
    student = rng.normal(size=(p, b, n_s, d_s)).astype(np.float32)
    teacher = np.stack([_low_rank(rng, b * n_t, d_t, rank).reshape(b, n_t, d_t)
                        for rank in (2 + np.arange(l))]).astype(np.float32)
    imp = rng.random((l, b, n_t)).astype(np.float32)
    jsel = jax_init_selector(jax.random.PRNGKey(seed), p, d_s, d_t)
    return jsel, student, teacher, imp


def _port_state(jsel):
    return selector_state_from_numpy(
        np.asarray(jsel.log_temperatures), np.asarray(jsel.proj_s),
        np.asarray(jsel.proj_t), device=CPU)


# ---- the oracle is the JAX package's, bit for bit ----


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "mp_rank M >= D":
        x = _low_rank_plus_noise(rng, 512, 32, 5).astype(np.float32)
        return "marchenko_pastur_rank_np", (x,)
    if name == "mp_rank M < D":  # the m x m Gram
        return "marchenko_pastur_rank_np", (_low_rank_plus_noise(rng, 20, 48, 3),)
    if name in ("subspace k = 6", "subspace k = D"):
        z = _low_rank_plus_noise(rng, 300, 24, 6).astype(np.float32)
        return "grassmann_subspace_np", (z, 6 if name.endswith("6") else 24)
    if name == "angles at the 1 - eps clip":  # identical subspaces: sigma = 1
        u, s = jref.grassmann_subspace_np(rng.normal(size=(100, 12)), 5)
        return "principal_angle_distance_np", (u, u, s)
    if name == "angles":
        u_s, _ = jref.grassmann_subspace_np(rng.normal(size=(100, 12)), 5)
        u_t, s = jref.grassmann_subspace_np(_low_rank_plus_noise(rng, 100, 12, 5), 5)
        return "principal_angle_distance_np", (u_s, u_t, s)
    if name == "nuclear norm, rank-deficient":
        c = np.zeros((4, 7), dtype=np.float32)
        c[0, 0], c[1, 2] = 2.0, -0.5
        return "nuclear_norm_np", (c,)
    jsel, student, teacher, _ = _selector_setting()
    tau = 1.0 if name.endswith("1") else 0.3
    return "selector_weights_np", (student[0], teacher, np.asarray(jsel.proj_s),
                                   np.asarray(jsel.proj_t), tau, 7)


@pytest.mark.parametrize("name", [
    "mp_rank M >= D", "mp_rank M < D", "subspace k = 6", "subspace k = D",
    "angles at the 1 - eps clip", "angles", "nuclear norm, rank-deficient",
    "selector weights tau = 1", "selector weights tau = 0.3"])
def test_oracle_is_the_jax_package_oracle_bit_for_bit(name):
    fn, args = _case(name)
    got, want = getattr(tref, fn)(*args), getattr(jref, fn)(*args)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        np.testing.assert_array_equal(g, w)
    assert type(got) is type(want)
    if name == "angles at the 1 - eps clip":
        # sigma at or above 1 - eps is clipped there: no NaN, an angle of
        # at least arccos(1 - eps)
        eps = np.finfo(np.float64).eps
        assert np.arccos(1.0 - eps) ** 2 <= got < 1e-12


@pytest.mark.parametrize("temperature", [1.0, 0.3])
def test_selector_d2_softmax_is_selector_weights(temperature):
    """softmax(-d2 / tau) of `selector_d2_np` is `selector_weights_np` at
    every point, bit for bit; a sequence of layers, read one at a time,
    gives the stacked array's d2 and ranks."""
    jsel, student, teacher, _ = _selector_setting(p=3)
    proj_s, proj_t = np.asarray(jsel.proj_s), np.asarray(jsel.proj_t)
    d2, ranks = tref.selector_d2_np(student, teacher, proj_s, proj_t, 7)
    assert d2.shape == (3, 4) and len(set(ranks.tolist())) > 1
    for p in range(3):
        logits = -d2[p] / temperature
        w = np.exp(logits - logits.max())
        np.testing.assert_array_equal(
            w / w.sum(), tref.selector_weights_np(student[p], teacher, proj_s, proj_t,
                                                  temperature, 7))
    reads = []

    class Layers:
        def __len__(self):
            return teacher.shape[0]

        def __getitem__(self, l):
            reads.append(l)
            return teacher[l].astype(np.float64)

    d2_seq, ranks_seq = tref.selector_d2_np(student.astype(np.float64), Layers(),
                                            proj_s.astype(np.float64),
                                            proj_t.astype(np.float64), 7)
    assert reads == [0, 1, 2, 3]
    np.testing.assert_array_equal(ranks_seq, ranks)
    np.testing.assert_allclose(d2_seq, d2, rtol=1e-5)


# ---- the port's torch spectral ops against the oracle (the JAX tests' bounds) ----


@pytest.mark.parametrize("true_rank", [2, 5, 10])
def test_marchenko_pastur_rank_equals_oracle(true_rank):
    rng = np.random.default_rng(0)
    x = _low_rank_plus_noise(rng, 512, 32, true_rank).astype(np.float32)
    assert int(tops.marchenko_pastur_rank(t32(x))) == tref.marchenko_pastur_rank_np(x)


def test_marchenko_pastur_rank_batched_equals_oracle():
    rng = np.random.default_rng(2)
    xs = np.stack([_low_rank_plus_noise(rng, 256, 24, r) for r in (3, 6)]).astype(np.float32)
    ranks = tops.marchenko_pastur_rank(t32(xs))
    assert ranks.shape == (2,)
    assert ranks.tolist() == [tref.marchenko_pastur_rank_np(x) for x in xs]


def test_mp_rank_sturm_equals_oracle():
    """Householder + Sturm ranks on `tests/test_spectral.py`'s planted
    covariances equal the oracle's on their features."""
    rng = np.random.default_rng(0)
    m, d = 512, 96
    feats = []
    for _ in range(8):
        r = int(rng.integers(3, d * 2 // 3))
        u = rng.standard_normal((m, r)) * (3.0 + rng.random(r) * 5)
        feats.append(u @ rng.standard_normal((r, d)) + rng.standard_normal((m, d)))
    covs = np.stack([x.T @ x / m for x in feats]).astype(np.float32)
    got = mp_rank_sturm(t32(covs), m).numpy()
    np.testing.assert_array_equal(got, [tref.marchenko_pastur_rank_np(x) for x in feats])


def test_grassmann_basis_projectors_match_oracle():
    rng = np.random.default_rng(5)
    z = _low_rank_plus_noise(rng, 400, 20, 6).astype(np.float32)
    basis, _ = tops.grassmann_basis(t32(z))
    got = basis[:, :6].numpy()
    want, _ = tref.grassmann_subspace_np(z, 6)
    np.testing.assert_allclose(got @ got.T, want @ want.T, atol=5e-3)


@pytest.mark.parametrize("k", [2, 5, 9])
def test_masked_principal_angle_distance_matches_oracle(k):
    rng = np.random.default_rng(12 + k)
    zs = rng.normal(size=(200, 16)).astype(np.float32)
    zt = _low_rank_plus_noise(rng, 200, 16, k).astype(np.float32)
    basis_s, _ = tops.grassmann_basis(t32(zs))
    basis_t, svals_t = tops.grassmann_basis(t32(zt))
    got = tops.masked_principal_angle_distance(
        basis_s[None], basis_t[None], svals_t[None], torch.tensor([k]))
    us, _ = tref.grassmann_subspace_np(zs, k)
    ut, sw = tref.grassmann_subspace_np(zt, k)
    want = tref.principal_angle_distance_np(us, ut, sw)
    np.testing.assert_allclose(float(got[0]), want, rtol=2e-2, atol=1e-4)


@pytest.mark.parametrize("fn,rtol", [("nuclear_norm", 5e-3), ("nuclear_norm_ns", 2e-3),
                                     ("nuclear_norm_pair", 3e-3)])
def test_nuclear_norms_match_oracle(fn, rtol):
    rng = np.random.default_rng(10)
    if fn == "nuclear_norm_pair":
        s = rng.normal(size=(5, 20, 32)).astype(np.float32)
        t = rng.normal(size=(5, 20, 48)).astype(np.float32)
        got = tops.nuclear_norm_pair(t32(s), t32(t)).numpy()
        want = [tref.nuclear_norm_np(s[i].T @ t[i]) for i in range(5)]
    else:
        c = rng.normal(size=(6, 12, 24)).astype(np.float32)
        got = getattr(tops, fn)(t32(c)).numpy()
        want = [tref.nuclear_norm_np(x) for x in c]
    np.testing.assert_allclose(got, want, rtol=rtol)


# ---- the selector against the oracle ----


def test_select_and_mix_matches_oracle_at_full_rank():
    """`tests/test_losses.py`'s oracle test on the port: max_rank = D_s - 1
    (the port's k there), weights within 2e-2."""
    jsel, student, teacher, imp = _selector_setting()
    _, _, aux = select_and_mix(_port_state(jsel), t32(student), t32(teacher), t32(imp))
    got = aux["mixing_weights"].detach().numpy()
    for i in range(student.shape[0]):
        want = tref.selector_weights_np(student[i], teacher, np.asarray(jsel.proj_s),
                                        np.asarray(jsel.proj_t), temperature=1.0,
                                        max_rank=student.shape[-1] - 1)
        np.testing.assert_allclose(got[i], want, atol=2e-2)


def test_select_and_mix_below_width_no_further_from_oracle_than_jax():
    """Table-3's selector widths (D_s 192, D_t 768, 12 layers, 640 teacher
    tokens, K = 48) on random tokens: both packages' K-capped subspace
    iteration differs from the oracle's exact SVD (1.9e-3 in the weights,
    1.2e-2 relative in d^2); the port's max |dweights| is no larger than
    the JAX package's plus 1e-3, and the MP ranks are the oracle's."""
    rng = np.random.default_rng(3)
    p, l, b, n, d_s, d_t, k = 4, 12, 10, 64, 192, 768, 48
    student = rng.normal(size=(p, b, n, d_s)).astype(np.float32)
    teacher = rng.normal(size=(l, b, n, d_t)).astype(np.float32)
    imp = np.full((l, b, n), 1.0 / n, np.float32)
    jsel = jax_init_selector(jax.random.PRNGKey(0), p, d_s, d_t)
    _, _, jaux = jax.jit(lambda *a: jax_select_and_mix(*a, subspace_k=k))(
        jsel, jnp.asarray(student), jnp.asarray(teacher), jnp.asarray(imp))
    with torch.no_grad():
        _, _, taux = select_and_mix(_port_state(jsel), t32(student), t32(teacher),
                                    t32(imp), subspace_k=k)
    d2, ranks = tref.selector_d2_np(student.astype(np.float64), teacher.astype(np.float64),
                                    np.asarray(jsel.proj_s, np.float64),
                                    np.asarray(jsel.proj_t, np.float64), k)
    want = np.exp(-d2 - (-d2).max(-1, keepdims=True))
    want /= want.sum(-1, keepdims=True)
    port = np.abs(taux["mixing_weights"].numpy() - want).max()
    jax_err = np.abs(np.asarray(jaux["mixing_weights"]) - want).max()
    np.testing.assert_array_equal(taux["mp_ranks"].numpy(), ranks)
    np.testing.assert_array_equal(np.asarray(jaux["mp_ranks"]), ranks)
    assert port <= jax_err + 1e-3, (port, jax_err)
    assert port <= chip_smoke.ORACLE_WEIGHTS_ATOL


@pytest.mark.parametrize("shapes,ranks,k", [
    (((8, 33, 96), (8, 25, 48)), (5, 10, 15, 21), 24),
    (((256, 256, 96), (256, 196, 48)), (5, 10, 15, 21), 24),
    (((8, 128, 1024), (8, 98, 384)), chip_smoke.PLANTED_RANKS, chip_smoke.PLANTED_K),
], ids=["D_s=48", "D_s=48, Table-1 token counts", "Table-1 widths"])
def test_planted_input_within_phase_5d_bounds(shapes, ranks, k):
    """chip_smoke phase 5d's planted input and comparison at small sizes on
    the CPU: ranks equal, weights and d^2 within the bounds phase 5d holds
    the card to (`chip_smoke.PLANTED_WEIGHTS_ATOL`, `PLANTED_D2`),
    and the weights discriminate (each point's largest weight on its own
    layer)."""
    (t_shape, s_shape) = shapes
    sel = init_selector(1, 4, s_shape[-1], t_shape[-1], device=CPU)
    teacher, student = chip_smoke.planted_selector_inputs(
        sel.proj_s, sel.proj_t, t_shape, s_shape, seed=0, ranks=ranks)
    assert teacher.dtype == student.dtype == torch.bfloat16
    imp = torch.full(teacher.shape[:3], 1.0 / t_shape[1])
    reading = chip_smoke.oracle_check("planted", sel, student, teacher, imp, k,
                                      chip_smoke.PLANTED_WEIGHTS_ATOL,
                                      chip_smoke.PLANTED_D2)
    assert reading["ranks"] == list(ranks) and reading["ranks_equal"]
    with torch.no_grad():
        _, _, aux = select_and_mix(sel, student, teacher, imp, subspace_k=k)
    np.testing.assert_array_equal(aux["mixing_weights"].argmax(-1).numpy(),
                                  chip_smoke.PLANTED_PAIRS)


def test_mp_rank_below_sample_count_is_both_packages_not_the_oracle():
    """Fewer teacher tokens than the selector's width (B N_t = 20 < D_s =
    48): the oracle takes the m x m Gram and finds the planted rank 3; both
    packages take the D x D Gram (basd_tpu/spectral/ops.py:249-258), whose
    MP edge falls to about 0, and agree with each other on the sample
    count."""
    rng = np.random.default_rng(4)
    p, l, b, n_s, n_t, d_s, d_t = 2, 3, 2, 16, 10, 48, 64
    student = rng.normal(size=(p, b, n_s, d_s)).astype(np.float32)
    teacher = np.stack([_low_rank(rng, b * n_t, d_t, 3).reshape(b, n_t, d_t)
                        for _ in range(l)]).astype(np.float32)
    imp = np.full((l, b, n_t), 1.0 / n_t, np.float32)
    jsel = jax_init_selector(jax.random.PRNGKey(1), p, d_s, d_t)
    _, _, jaux = jax.jit(jax_select_and_mix)(
        jsel, jnp.asarray(student), jnp.asarray(teacher), jnp.asarray(imp))
    with torch.no_grad():
        _, _, taux = select_and_mix(_port_state(jsel), t32(student), t32(teacher), t32(imp))
    k = min(d_s - 1, b * n_t)
    _, ranks = tref.selector_d2_np(student, teacher, np.asarray(jsel.proj_s),
                                   np.asarray(jsel.proj_t), k)
    port, jax_ranks = taux["mp_ranks"].numpy(), np.asarray(jaux["mp_ranks"])
    np.testing.assert_array_equal(port, jax_ranks)
    assert (port == k).all() and (ranks == 3).all(), (port, ranks)  # samples; planted
