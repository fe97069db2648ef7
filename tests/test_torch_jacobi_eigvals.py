"""The port's Jacobi eigenvalues (K5's plain version,
`basd_tpu_torch.spectral.jacobi.jacobi_eigvals`) held against the JAX
package's `pallas_jacobi_eigvals` in interpret mode and against numpy on
the CPU, with the kernel wrapper's CPU route."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.spectral.pallas_jacobi import pallas_jacobi_eigvals
from basd_tpu_torch.spectral import jacobi as tjacobi
from basd_tpu_torch.spectral import jacobi_kernel
from test_torch_helpers import assert_close, psd, t32

torch.set_num_threads(1)


@pytest.mark.parametrize("sweeps", [3, 12])
@pytest.mark.parametrize("n", [12, 9, 16])
def test_plain_eigvals_match_pallas_interpret(n, sweeps):
    """Both sides run the same rotations in fp32: within 1e-5 of max|w|
    at sweeps 3 (unconverged) and 12, even and odd n."""
    a = psd(4, n, seed=n + sweeps)
    want = np.asarray(pallas_jacobi_eigvals(jnp.asarray(a), sweeps=sweeps,
                                            interpret=True))
    got = tjacobi.jacobi_eigvals(t32(a), sweeps=sweeps)
    assert got.shape == (4, n)
    assert_close(got, want, 1e-5, f"eigenvalues n={n} sweeps={sweeps}")


@pytest.mark.parametrize("n", [12, 9, 16])
def test_plain_eigvals_match_numpy_converged(n):
    """At sweeps 12 the eigenvalues are numpy's eigvalsh, ascending (rtol
    1e-4, atol 1e-5, as the JAX package's own test)."""
    a = psd(3, n, seed=100 + n)
    got = tjacobi.jacobi_eigvals(t32(a), sweeps=12).numpy()
    assert np.all(np.diff(got, axis=-1) >= 0)
    np.testing.assert_allclose(got, np.linalg.eigvalsh(a.astype(np.float64)),
                               rtol=1e-4, atol=1e-5)


def test_odd_n_drops_exactly_the_pad_zero():
    """An odd n's pad adds one zero eigenvalue, dropped as the entry of
    smallest |w|: a planted spectrum with negative, zero and positive
    eigenvalues comes back whole, zero included, and the batch shape is
    kept."""
    rng = np.random.default_rng(3)
    n = 9
    lam = np.array([-2.0, -0.5, 0.0, 0.3, 0.7, 1.0, 1.5, 2.5, 4.0])
    q = np.linalg.qr(rng.standard_normal((2, 3, n, n)))[0]
    a = np.einsum("...ik,k,...jk->...ij", q, lam, q).astype(np.float32)
    got = tjacobi.jacobi_eigvals(t32(a), sweeps=12)
    assert got.shape == (2, 3, n)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(lam, (2, 3, n)),
                               atol=1e-5)
    want = np.asarray(pallas_jacobi_eigvals(jnp.asarray(a), sweeps=12,
                                            interpret=True))
    assert_close(got, want, 1e-5, "odd n vs pallas")


def test_finish_eigvals_sorts_and_drops_the_smallest_magnitude():
    w = torch.tensor([[3.0, -1.0, 1e-7, 2.0], [0.5, -4.0, 1.0, -3e-6]])
    out = tjacobi.finish_eigvals(w, 3, (2,))
    assert torch.equal(out, torch.tensor([[-1.0, 2.0, 3.0], [-4.0, 0.5, 1.0]]))
    even = tjacobi.finish_eigvals(w, 4, (2,))
    assert torch.equal(even, torch.sort(w, dim=-1).values)


def test_kernel_wrapper_takes_the_plain_version_for_a_cpu_tensor(monkeypatch):
    a = t32(psd(5, 16, seed=1))
    want = tjacobi.jacobi_eigvals(a, sweeps=4)
    assert torch.equal(jacobi_kernel.kernel_jacobi_eigvals(a, sweeps=4), want)
    calls = []
    monkeypatch.setattr(tjacobi, "jacobi_eigvals",
                        lambda x, sweeps: calls.append(sweeps) or want)
    jacobi_kernel.kernel_jacobi_eigvals(a, sweeps=7)
    assert calls == [7]
