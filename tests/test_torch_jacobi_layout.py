"""The layout of the Jacobi eigh kernel's ping-pong route (n <= 96), held
on the CPU: the destination and source maps, the route that the wrapper
launches by n, one ping-pong step written as a scatter into a second
buffer, and the next step's rotations as the rotation lanes compute them,
bit for bit against `jacobi_step` and `pair_rotations` at every even n the
route takes; a whole run of ping-pong steps bit for bit against
`jacobi_eigh` and within tolerance of the JAX package's `jacobi_eigh`."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.spectral.jacobi import jacobi_eigh as jax_jacobi_eigh
from basd_tpu_torch.spectral import jacobi as tjacobi
from basd_tpu_torch.spectral import jacobi_kernel
from test_torch_helpers import assert_close, psd, t32

EVEN_N = list(range(4, jacobi_kernel.MAX_N_PINGPONG + 1, 2))


@pytest.mark.parametrize("n", EVEN_N)
def test_pingpong_step_is_jacobi_step_bit_for_bit(n):
    """dst is the inverse of the half-shift and src the half-shift, and one
    ping-pong step on (A, V^T) gives exactly the bits of `jacobi_step` on
    (A, V), and its next rotations those of `pair_rotations` on the next A
    (A a rotated PSD batch, so V is not the identity and the off-diagonal
    entries are all nonzero)."""
    dst, src = tjacobi.halfshift_dst(n), tjacobi.halfshift_src(n)
    assert sorted(dst) == list(range(n))
    moved = tjacobi.rotate_positions(torch.arange(n)[None, :], 1)[0]
    assert [dst[int(p)] for p in moved] == list(range(n))
    assert [int(p) for p in moved] == src

    a = t32(psd(3, n, seed=n))
    v = torch.eye(n).expand(3, n, n)
    for _ in range(3):
        a, v = tjacobi.jacobi_step(a, v)
    want_a, want_v = tjacobi.jacobi_step(a, v)
    got_a, got_vt, got_c, got_s = tjacobi.pingpong_step(
        a, v.transpose(-1, -2).contiguous(), *tjacobi.pair_rotations(a))
    assert torch.equal(got_a, want_a)
    assert torch.equal(got_vt, want_v.transpose(-1, -2))
    want_c, want_s = tjacobi.pair_rotations(want_a)
    assert torch.equal(got_c, want_c) and torch.equal(got_s, want_s)


@pytest.mark.parametrize("n", [4, 6, 34, 48, 66, 96])
def test_pingpong_pair_inputs_take_every_half(n):
    """The rotation lanes' a_kk, a_{k+h,k+h}, a_{k,k+h} are the next A's
    entries bit for bit, with rotations of both signs and exact zeros
    among the entries (a rank-deficient Gram), so that every swapped and
    negated operand and the signs of zeros are exercised."""
    h = n // 2
    a = t32(psd(4, n, seed=7 * n))
    a[:, :, n - 1] = 0.0
    a[:, n - 1, :] = 0.0
    v = torch.eye(n).expand(4, n, n)
    for _ in range(2):
        a, v = tjacobi.jacobi_step(a, v)
    c, s = tjacobi.pair_rotations(a)
    assert (s > 0).any() and (s < 0).any()
    nxt, _ = tjacobi.jacobi_step(a, v)
    app, aqq, apq = tjacobi.pingpong_pair_inputs(a, c, s)
    d = tjacobi.diag_of(nxt)
    assert torch.equal(app, d[:, :h]) and torch.equal(aqq, d[:, h:])
    assert torch.equal(apq, torch.diagonal(nxt[:, :h, h:], dim1=-2, dim2=-1))


class _RecordingLibrary:
    """Stands in for the Jacobi kernel library: records each entry point
    called and its arguments, and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("basd_jacobi_eigh"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("n", range(4, jacobi_kernel.MAX_N + 1, 2))
def test_raw_launch_takes_the_route_of_eigh_route(n, monkeypatch):
    """`_jacobi_raw_cuda` launches the route that `eigh_route` names, and
    only that: the ping-pong entry point to n = 96; above, the packed_log
    route's two launches in order, the first writing w and a rotation log
    of (batch, steps, log_pairs(n)) float2 that the wrapper allocated, the
    second replaying that log into vt; one launch counted per call."""
    lib = _RecordingLibrary()
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(empty(*a, **k)) or made[-1])
    monkeypatch.setattr(jacobi_kernel.kernels, "library", lambda name: lib)
    monkeypatch.setattr(jacobi_kernel, "_stream", lambda a: 0)
    monkeypatch.setitem(jacobi_kernel.kernels.LAUNCHES, "jacobi_eigh", 0)
    a = torch.zeros((2, n, n))
    w, vt = jacobi_kernel._jacobi_raw_cuda(a, sweeps=3)
    route = jacobi_kernel.eigh_route(n)
    steps = (n - 1) * 3
    if route == "pingpong":
        [(entry, args)] = lib.calls
        assert entry == "basd_jacobi_eigh_pingpong"
        assert args[:6] == (a.data_ptr(), w.data_ptr(), vt.data_ptr(), 2, n, steps)
    else:
        assert route == "packed_log"
        [(first, a1), (second, a2)] = lib.calls
        assert (first, second) == ("basd_jacobi_eigh_packed_log", "basd_jacobi_eigh_vt_replay")
        [log] = [t for t in made if t.data_ptr() == a1[2]]
        assert log.shape == (2, steps, jacobi_kernel.log_pairs(n), 2) and log.dtype == torch.float32
        assert a1[:2] == (a.data_ptr(), w.data_ptr()) and a1[3:6] == (2, n, steps)
        assert a2[:2] == (log.data_ptr(), vt.data_ptr()) and a2[2:5] == (2, n, steps)
    assert jacobi_kernel.kernels.LAUNCHES["jacobi_eigh"] == 1


def test_eigh_routes_by_n():
    assert jacobi_kernel.eigh_route(4) == "pingpong"
    assert jacobi_kernel.eigh_route(96) == "pingpong"
    for n in (98, 168, 170, 192, 238):
        assert jacobi_kernel.eigh_route(n) == "packed_log"
    # the log's rows: every rotation of a step, 16-byte aligned
    for n in range(4, jacobi_kernel.MAX_N + 1, 2):
        lp = jacobi_kernel.log_pairs(n)
        assert lp % 2 == 0 and n // 2 <= lp <= n // 2 + 1


def _pingpong_eigh(a: torch.Tensor, sweeps: int):
    """`jacobi_eigh` run as the ping-pong route runs it."""
    batch_shape = a.shape[:-2]
    a, n0 = tjacobi.symmetrize_pad(a)
    n = a.shape[-1]
    vt = torch.eye(n).expand(a.shape[0], n, n).contiguous()
    c, s = tjacobi.pair_rotations(a)
    for _ in range((n - 1) * sweeps):
        a, vt, c, s = tjacobi.pingpong_step(a, vt, c, s)
    return tjacobi.finish(tjacobi.diag_of(a), vt.transpose(-1, -2), n0,
                          batch_shape)


@pytest.mark.parametrize("n0", [16, 33, 48])
def test_pingpong_run_matches_jacobi_eigh(n0):
    """A whole run at sweeps=6 (n0 = 33 padded to 34): bit for bit against
    the plain `jacobi_eigh`; against the JAX package's `jacobi_eigh`
    within 1e-4 of max|w| (the rounding of ~280 rotations, amplified by the
    tail that sweeps=6 leaves unconverged)."""
    a = psd(4, n0, seed=100 + n0)
    w, v = _pingpong_eigh(t32(a), 6)
    wp, vp = tjacobi.jacobi_eigh(t32(a), sweeps=6)
    assert torch.equal(w, wp) and torch.equal(v, vp)
    jw, _ = jax_jacobi_eigh(jnp.asarray(a), sweeps=6)
    assert_close(w, np.asarray(jw), 1e-4, "ping-pong eigenvalues vs JAX")
