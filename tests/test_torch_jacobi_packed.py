"""The layout of the Jacobi eigenvalues kernel's packed route (K5, even
n <= 238), held on the CPU: A's upper block triangle in four planes, the
map that writes each rotated entry to its next slot, one packed step and
the next rotations as the rotation lanes compute them, bit for bit against
`jacobi_step` and `pair_rotations` on symmetric input at every even n to
96; whole packed runs within tolerance of the JAX package's
`pallas_jacobi_eigvals` (interpret mode); and the wrapper's dispatch by n
against a recording stand-in for the library, with the pointers, sizes
and stream each launch passes. The eigh kernel's packed_log
route (K3, 96 < n <= 238), the packed run's rotation log replayed onto V^T
(`replay_vt`): bit for bit `jacobi_eigh`'s V when fed its own rotations,
within tolerance of its raw (w, V) when fed the packed run's, at every
even n the route takes, and within tolerance of the JAX package's
`pallas_jacobi_eigh` (interpret mode)."""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.spectral.pallas_jacobi import pallas_jacobi_eigh, pallas_jacobi_eigvals
from basd_tpu_torch.spectral import jacobi as tjacobi
from basd_tpu_torch.spectral import jacobi_kernel
from test_torch_helpers import assert_close, psd, t32

torch.set_num_threads(1)

EVEN_N = list(range(4, jacobi_kernel.MAX_N + 1, 2))


def _symmetric(a: torch.Tensor) -> torch.Tensor:
    """(A + A^T) / 2, exactly symmetric in fp32."""
    return (a + a.transpose(-1, -2)) * 0.5


def _expected_next(a: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """The packed slots of `jacobi_step`'s next A as the packed route
    writes them: the entry that each written slot's source entry (p, q)
    moves to, (dst(p), dst(q)), read in that orientation."""
    n = a.shape[-1]
    dst = tjacobi.halfshift_dst(n)
    ps, qs = tjacobi.packed_positions(n)
    to = torch.tensor(tjacobi.packed_dst(n))
    keep = to >= 0
    out = torch.zeros((a.shape[0], len(ps)))
    out[:, to[keep]] = nxt[:, torch.tensor([dst[p] for p in ps])[keep],
                           torch.tensor([dst[q] for q in qs])[keep]]
    return out[:, torch.tensor(tjacobi.packed_read_slots(n))]


@pytest.mark.parametrize("n", list(range(4, 97, 2)))
def test_packed_step_is_jacobi_step_bit_for_bit(n):
    """On a symmetric A (a rotated PSD batch, off-diagonal entries all
    nonzero), one packed step writes to every slot the bits of the
    `jacobi_step` entry that its source entry moves to, and its next
    rotations are `pair_rotations` of `jacobi_step`'s next A, bit for bit."""
    a = t32(psd(3, n, seed=n))
    v = torch.eye(n).expand(3, n, n)
    for _ in range(3):
        a, v = tjacobi.jacobi_step(a, v)
    a = _symmetric(a)
    nxt, _ = tjacobi.jacobi_step(a, v)
    got, c, s = tjacobi.packed_step(tjacobi.pack_upper(a), *tjacobi.pair_rotations(a))
    assert torch.equal(got, _expected_next(a, nxt))
    want_c, want_s = tjacobi.pair_rotations(nxt)
    assert torch.equal(c, want_c) and torch.equal(s, want_s)
    assert torch.equal(tjacobi.packed_diag(got, n), tjacobi.diag_of(nxt))


@pytest.mark.parametrize("n", [4, 6, 34, 48, 66, 96])
def test_packed_pair_inputs_take_every_half(n):
    """The rotation lanes' a_kk, a_{k+h,k+h}, a_{k,k+h} are the next packed
    A's entries bit for bit, with rotations of both signs and exact zeros
    among the entries (a rank-deficient Gram), so that every swapped and
    negated operand and the signs of zeros are exercised."""
    h = n // 2
    a = t32(psd(4, n, seed=7 * n))
    a[:, :, n - 1] = 0.0
    a[:, n - 1, :] = 0.0
    v = torch.eye(n).expand(4, n, n)
    for _ in range(2):
        a, v = tjacobi.jacobi_step(a, v)
    upper = [tjacobi.packed_slot(k, k + h, n) for k in range(h)]  # a_{k,k+h}
    x = tjacobi.pack_upper(_symmetric(a))
    d = tjacobi.packed_diag(x, n)
    c, s = tjacobi.rotations(d[:, :h], d[:, h:], x[:, upper])
    assert (s > 0).any() and (s < 0).any()
    nxt, _, _ = tjacobi.packed_step(x, c, s)
    app, aqq, apq = tjacobi.packed_pair_inputs(x, c, s)
    d = tjacobi.packed_diag(nxt, n)
    assert torch.equal(app, d[:, :h]) and torch.equal(aqq, d[:, h:])
    assert torch.equal(apq, nxt[:, upper])


@pytest.mark.parametrize("n", EVEN_N)
def test_packed_map_writes_every_slot_once(n):
    """At every even n the kernel takes, one step writes each slot that the
    next step reads exactly once (the TL, TR and BR of each diagonal block
    and all four planes of the others), and only the h diagonal blocks'
    BL slots, which are read from their TR, are left unwritten; the
    buffers fit a CTA's 227 KB of shared memory."""
    h = n // 2
    m = h * (h + 1) // 2
    dst = tjacobi.packed_dst(n)
    read = tjacobi.packed_read_slots(n)
    written = [d for d in dst if d >= 0]
    assert len(dst) == 4 * m and dst.count(-1) == h
    assert sorted(written) == sorted(set(read)) and len(set(written)) == len(written)
    assert all(read[d] == d for d in written)
    ps, qs = tjacobi.packed_positions(n)
    assert {(min(p, q), max(p, q)) for p, q in zip(ps, qs)} == {
        (p, q) for p in range(n) for q in range(p, n)}
    assert 4 * (2 * (4 * m + 4) + 4 * h) <= 232448


def _packed_eigvals(a: torch.Tensor, sweeps: int) -> torch.Tensor:
    """`jacobi_eigvals` run as the packed route runs it."""
    batch_shape = a.shape[:-2]
    a, n0 = tjacobi.symmetrize_pad(a)
    n = a.shape[-1]
    x = tjacobi.pack_upper(a)
    c, s = tjacobi.pair_rotations(a)
    for _ in range((n - 1) * sweeps):
        x, c, s = tjacobi.packed_step(x, c, s)
    return tjacobi.finish_eigvals(tjacobi.packed_diag(x, n), n0, batch_shape)


@pytest.mark.parametrize("n0", [16, 33, 48])
def test_packed_run_matches_pallas_eigvals(n0):
    """A whole packed run at sweeps 9 (n0 = 33 padded to 34) within 1e-4 of
    max|w| of the JAX package's `pallas_jacobi_eigvals` in interpret mode
    and of the plain `jacobi_eigvals`: the packed route rotates the upper
    triangle only, so it rounds otherwise than the full matrix's
    rotations."""
    a = psd(4, n0, seed=200 + n0)
    got = _packed_eigvals(t32(a), 9)
    want = np.asarray(pallas_jacobi_eigvals(jnp.asarray(a), sweeps=9, interpret=True))
    assert_close(got, want, 1e-4, "packed eigenvalues vs JAX")
    assert_close(got, tjacobi.jacobi_eigvals(t32(a), sweeps=9).numpy(), 1e-4,
                 "packed eigenvalues vs plain")


def _packed_log_run(a: torch.Tensor, steps: int):
    """The packed_log route's two launches on a symmetric even-n batch:
    the packed run's diagonal after `steps` steps and its rotation log,
    (c, s) each (B, steps, h), replayed onto V^T."""
    n = a.shape[-1]
    x = tjacobi.pack_upper(a)
    c, s = tjacobi.pair_rotations(a)
    log = [(c, s)]
    for t in range(steps):
        x, c, s = tjacobi.packed_step(x, c, s)
        if t + 1 < steps:
            log.append((c, s))
    cs, ss = (torch.stack(v, dim=1) for v in zip(*log))
    return tjacobi.packed_diag(x, n), tjacobi.replay_vt(cs, ss)


PACKED_LOG_N = list(range(jacobi_kernel.MAX_N_PINGPONG + 2, jacobi_kernel.MAX_N + 1, 2))


@pytest.mark.parametrize("n", PACKED_LOG_N)
def test_replay_of_jacobi_rotations_is_jacobi_eigh_v_bit_for_bit(n, monkeypatch):
    """`replay_vt` fed the rotations that `jacobi_eigh` applies in one
    sweep (n - 1 steps) of a random PSD pair gives its raw (unsorted) V bit
    for bit: the same rounding of the same rotations, each row moved by the
    same half-shift, at every even n of the packed_log route."""
    log, pair_rotations = [], tjacobi.pair_rotations
    monkeypatch.setattr(tjacobi, "pair_rotations",
                        lambda a: log.append(pair_rotations(a)) or log[-1])
    _, v = tjacobi.jacobi_eigh(t32(psd(2, n, seed=n)), sweeps=1, sort=False)
    assert len(log) == n - 1
    cs, ss = (torch.stack(t, dim=1) for t in zip(*log))
    assert torch.equal(tjacobi.replay_vt(cs, ss), v.transpose(-1, -2))


@pytest.mark.parametrize("n", PACKED_LOG_N)
def test_packed_log_run_matches_jacobi_eigh(n):
    """One sweep of the packed_log route (the packed run's diagonal, its
    rotation log replayed onto V^T) at every even n it takes, on a
    diagonally dominant pair (diagonal 1..10, symmetric noise 3e-3, so every
    rotation is well conditioned), against `jacobi_eigh`'s raw (unsorted)
    (w, V): w within 1e-5 of max|w|, V^T within 1e-4 of V^T entry by entry
    (measured at most 5.8e-7 and 8.4e-6: the packed run rotates A's upper
    triangle, so it rounds otherwise than the full, not exactly symmetric,
    A). On random PSD input the early rotations are large and the two
    runs' rounding differences grow step by step (to 0.4 in w at n = 238
    after one sweep), so there the run is held to its own invariant
    (`test_packed_log_run_keeps_a_equal_to_v_at_vt`)."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, n, n)).astype(np.float32)
    a = t32(np.diag(np.linspace(1, 10, n, dtype=np.float32))
            + 3e-3 * (x + x.transpose(0, 2, 1)) / 2)
    w_raw, v_raw = tjacobi.jacobi_eigh(a, sweeps=1, sort=False)
    w, vt = _packed_log_run(a, n - 1)
    w_err = ((w - w_raw).abs().amax(-1) / w_raw.abs().amax(-1)).max().item()
    v_err = (vt - v_raw.transpose(-1, -2)).abs().max().item()
    assert w_err <= 1e-5 and v_err <= 1e-4, (w_err, v_err)


@pytest.mark.parametrize("n", [98, 130, 168, 170, 200, 238])
def test_packed_log_run_keeps_a_equal_to_v_at_vt(n):
    """One sweep of the packed_log route on a random PSD pair (large early
    rotations): A = V A_t V^T, with A_t the packed run's matrix unpacked
    from its slots and V^T the replayed log, within 5e-5 of ||A||
    (Frobenius; measured at most 7.0e-6, the fp32 rounding of n - 1
    steps); a log one step off or a row moved to the wrong position gives
    an error of order 1."""
    a = t32(psd(2, n, seed=n))
    x = tjacobi.pack_upper(a)
    c, s = tjacobi.pair_rotations(a)
    log = [(c, s)]
    for t in range(n - 1):
        x, c, s = tjacobi.packed_step(x, c, s)
        if t + 1 < n - 1:
            log.append((c, s))
    cs, ss = (torch.stack(v, dim=1) for v in zip(*log))
    vt = tjacobi.replay_vt(cs, ss)
    slots = torch.tensor([[tjacobi.packed_slot(p, q, n) for q in range(n)] for p in range(n)])
    err = (torch.linalg.matrix_norm(vt.transpose(-1, -2) @ x[:, slots] @ vt - a)
           / torch.linalg.matrix_norm(a))
    assert err.max().item() <= 5e-5, err


def test_packed_log_run_matches_pallas_eigh():
    """A whole packed_log run at n0 = 99 (padded to 100), sweeps 9, against
    the JAX package's `pallas_jacobi_eigh` in interpret mode: eigenvalues
    within 1e-4 of max|w| and each eigenvector within 1e-4 of the JAX
    one's up to its sign (|v . v_jax| within 1e-4 of 1; the two choose
    some columns' signs otherwise); V orthogonal within 1e-4."""
    n0, sweeps = 99, 9
    a = psd(2, n0, seed=99)
    a_even, _ = tjacobi.symmetrize_pad(t32(a))
    n = a_even.shape[-1]
    w, vt = _packed_log_run(a_even, (n - 1) * sweeps)
    w, v = tjacobi.finish(w, vt.transpose(-1, -2), n0, (2,))
    jw, jv = pallas_jacobi_eigh(jnp.asarray(a), sweeps=sweeps, interpret=True)
    assert_close(w, np.asarray(jw), 1e-4, "packed_log eigenvalues vs JAX")
    dots = np.abs(np.einsum("bij,bij->bj", v.numpy(), np.asarray(jv)))
    assert np.abs(dots - 1).max() <= 1e-4
    orth = v.transpose(-1, -2) @ v - torch.eye(n0)
    assert orth.abs().max().item() <= 1e-4


class _RecordingLibrary:
    """Stands in for the Jacobi kernel library: records each entry point
    called and its arguments, and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("basd_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("n", EVEN_N)
def test_raw_eigvals_launch_takes_the_route_of_eigvals_route(n, monkeypatch):
    """`_jacobi_eigvals_raw_cuda` launches the entry point of the route
    that `eigvals_route` names, and only that, with (batch, n, steps); one
    launch counted."""
    lib = _RecordingLibrary()
    monkeypatch.setattr(jacobi_kernel.kernels, "library", lambda name: lib)
    monkeypatch.setattr(jacobi_kernel, "_stream", lambda a: 0)
    monkeypatch.setitem(jacobi_kernel.kernels.LAUNCHES, "jacobi_eigvals", 0)
    jacobi_kernel._jacobi_eigvals_raw_cuda(torch.zeros((2, n, n)), sweeps=9)
    [(entry, args)] = lib.calls
    assert entry == f"basd_jacobi_eigvals_{jacobi_kernel.eigvals_route(n)}"
    assert args[2:5] == (2, n, (n - 1) * 9)
    assert jacobi_kernel.kernels.LAUNCHES["jacobi_eigvals"] == 1


@pytest.mark.parametrize("n", [6, 7, 48, 120])
def test_raw_launches_pass_pointers_sizes_and_stream(n, monkeypatch):
    """K3 (ping-pong to n = 96, packed_log at 120) and K5 at sweeps 2, an
    odd n padded to even first as `kernel_jacobi_eigh` pads it: each passes
    its input's and outputs' pointers, (batch, padded n, steps) and the
    current stream; packed_log's replay reads the log its first launch
    wrote; each call counts one launch."""
    lib = _RecordingLibrary()
    monkeypatch.setattr(jacobi_kernel.kernels, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    for name in ("jacobi_eigh", "jacobi_eigvals"):
        monkeypatch.setitem(jacobi_kernel.kernels.LAUNCHES, name, 0)
    padded, n0 = tjacobi.symmetrize_pad(t32(psd(3, n, seed=n)))
    m = n + n % 2
    assert n0 == n and padded.shape == (3, m, m)
    steps = (m - 1) * 2
    w, vt = jacobi_kernel._jacobi_raw_cuda(padded, 2)
    assert w.shape == (3, m) and vt.shape == (3, m, m)
    route = jacobi_kernel.eigh_route(m)
    assert route == ("packed_log" if n == 120 else "pingpong")
    if route == "pingpong":
        assert lib.calls == [("basd_jacobi_eigh_pingpong", (
            padded.data_ptr(), w.data_ptr(), vt.data_ptr(), 3, m, steps, 7))]
    else:
        [(first, a1), (second, a2)] = lib.calls
        assert (first, second) == ("basd_jacobi_eigh_packed_log", "basd_jacobi_eigh_vt_replay")
        assert a1[:2] == (padded.data_ptr(), w.data_ptr()) and a1[3:] == (3, m, steps, 7)
        assert a2 == (a1[2], vt.data_ptr(), 3, m, steps, 7)
    assert jacobi_kernel.kernels.LAUNCHES["jacobi_eigh"] == 1
    lib.calls.clear()
    w5 = jacobi_kernel._jacobi_eigvals_raw_cuda(padded, 2)
    assert w5.shape == (3, m)
    assert lib.calls == [("basd_jacobi_eigvals_packed", (
        padded.data_ptr(), w5.data_ptr(), 3, m, steps, 7))]
    assert jacobi_kernel.kernels.LAUNCHES["jacobi_eigvals"] == 1


def test_eigvals_routes_by_n():
    assert jacobi_kernel.eigvals_route(4) == "packed"
    assert jacobi_kernel.eigvals_route(190) == "packed"
    assert jacobi_kernel.eigvals_route(192) == "packed"
    assert jacobi_kernel.eigvals_route(238) == "packed"
    for bad in (2, 191, 240):
        with pytest.raises(ValueError, match="even 4 <= n <= 238"):
            jacobi_kernel.eigvals_route(bad)
