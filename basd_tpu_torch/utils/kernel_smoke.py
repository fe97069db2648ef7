"""Start-up check of the port's CUDA kernels; the port of
`basd_tpu/utils/kernel_smoke.py` without its fallback.

Before a long run stages data and steps, `validate_kernel_dispatches`
runs each kernel once at a tiny real shape on the card and holds its
result against the kernel's plain torch version on the same inputs:
attention forward (K1) and backward (K2), the TrivialAugment warp (K4),
the Jacobi eigh (K3, its ping-pong route), the MP rank (its one-CTA
route), the SwiGLU gate (both routes), the RoPE rotation (both routes)
and the LayerNorm (its three routes). A kernel that fails to build, to launch or to agree raises a
`RuntimeError` that names it and carries the original error. Nothing is
switched: the port has no fallback, so a run that cannot use a kernel
stops here rather than inside its first step.
On the CPU the plain versions run, so there is nothing to check.

The checks build their libraries through `kernels.library`, under
`kernels.build_lock`, so ranks that start together on a cold `_build/`
compile once. `python -m basd_tpu_torch.tools.smoke_kernels` runs the
same checks standalone.
"""

from __future__ import annotations

import numpy as np
import torch

from basd_tpu_torch import kernels

# K1/K2 in bf16: max |kernel - plain| / max |plain| (chip_smoke phase 4's
# bound for the bf16 attention kernels); K3's ping-pong route and K4 round
# every operation as their plain versions do, so those are held bit for bit,
# as are the MP rank's integer ranks
BF16_ATTENTION_TOL = 2e-2
# the SwiGLU gate rounds once from fp32: within one unit in the last place
# of the output dtype, relative to each value
GATE_ULP = {torch.bfloat16: 2.0**-7, torch.float32: 2.0**-23}
# the LayerNorm kernel sums a row in another order than torch's Welford
# kernel: each value within one unit in the last place of the output dtype
# at the plain version's value, and, where that value is near zero, within
# LN_ROW_ULPS fp32 ulps of its row's largest |value| (the statistics' own
# rounding, on the row's scale)
LN_ROW_ULPS = 4

_VALIDATED: set[str] = set()


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    diff = (got.float() - want.float()).abs().max().item()
    return diff / max(want.float().abs().max().item(), 1e-30)


def _within(pairs, what: str) -> str:
    worst = max(_rel_err(g, w) for g, w in pairs)
    if not worst <= BF16_ATTENTION_TOL:
        raise AssertionError(
            f"{what}: rel err {worst:.3g} against the plain version "
            f"> {BF16_ATTENTION_TOL}")
    return f"rel err {worst:.3g} (tol {BF16_ATTENTION_TOL})"


def _bit_for_bit(pairs, what: str) -> str:
    for got, want in pairs:
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(
                f"{what}: max err {err:.3g} against the plain version "
                "(bit for bit required)")
    return "bit for bit"


def _query(device: torch.device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((4, 33, 64)).astype(np.float32))
    return q.to(device=device, dtype=torch.bfloat16)


def _attention(device: torch.device) -> str:
    from basd_tpu_torch.ops.attention import attention_forward_plain, fused_attention

    q = _query(device)
    o = fused_attention(q, q, q, 32)
    return _within([(o, attention_forward_plain(q, q, q, 32)[0])], "attention")


def _attention_bwd(device: torch.device) -> str:
    """The gradient of sum(o.float() ** 2) with respect to q, k and v; the
    plain side runs the same chain as the kernels' autograd function."""
    from basd_tpu_torch.ops.attention import (
        attention_backward_plain,
        attention_forward_plain,
        fused_attention,
    )

    q = _query(device)
    leaves = [q.clone().requires_grad_(True) for _ in range(3)]
    o = fused_attention(*leaves, 32)
    got = torch.autograd.grad((o.float() ** 2).sum(), leaves)
    o, m, denom = attention_forward_plain(q, q, q, 32)
    do = (2.0 * o.float()).to(q.dtype)
    dd = (do.float() * o.float()).reshape(4, 33, 2, 32).sum(-1)
    want = attention_backward_plain(q, q, q, do, m, denom, dd, 32)
    return _within(zip(got, want), "attention_bwd")


def _warp(device: torch.device) -> str:
    from basd_tpu_torch.ops.warp_kernel import (
        fused_geometric_warp,
        geometric_warp_plain,
        warp_params,
    )

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((4, 32, 32, 3)).astype(np.float32)).to(device)
    a = torch.tensor([0.0, 0.3, -0.8, 1.6], device=device)
    z = torch.zeros(4, device=device)
    got = fused_geometric_warp(x, a, z, z, z, z, None)
    want = geometric_warp_plain(x, warp_params(a, z, z, z, z, None))
    return _bit_for_bit([(got, want)], "warp")


def _jacobi(device: torch.device) -> str:
    from basd_tpu_torch.spectral.jacobi import jacobi_eigh
    from basd_tpu_torch.spectral.jacobi_kernel import kernel_jacobi_eigh

    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 32, 32)).astype(np.float32)
    a = torch.from_numpy(a @ a.transpose(0, 2, 1)).to(device)
    got = kernel_jacobi_eigh(a, sweeps=4)
    want = jacobi_eigh(a, sweeps=4)
    return _bit_for_bit(zip(got, want), "jacobi")


def _mp_rank(device: torch.device) -> str:
    """Four Grams of 48 samples at n = 16, with 1 to 4 of their directions
    scaled up, against `mp_rank_sturm` on the covariance."""
    from basd_tpu_torch.spectral.mp_rank_kernel import kernel_mp_rank_gram, mp_covariance
    from basd_tpu_torch.spectral.tridiag import mp_rank_sturm

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 48, 16)).astype(np.float32)
    for i in range(4):
        x[i, :, : i + 1] *= 6.0
    x = torch.from_numpy(x).to(device)
    gram = x.transpose(1, 2) @ x
    got = kernel_mp_rank_gram(gram, 48)
    return _bit_for_bit([(got, mp_rank_sturm(mp_covariance(gram, 48), 48))], "mp_rank")


def _swiglu_gate(device: torch.device) -> str:
    """The gate on its vec route (bf16, g = 24) and its scalar route (fp32,
    g = 13), each against the plain version on the same rows."""
    from basd_tpu_torch.ops.activations import swiglu_gate, swiglu_gate_plain

    rng = np.random.default_rng(0)
    pairs = []
    for rows, g, dtype in ((5, 24, torch.bfloat16), (3, 13, torch.float32)):
        x = torch.from_numpy(3.0 * rng.standard_normal((rows, 2 * g)).astype(np.float32))
        x = x.to(device=device, dtype=dtype)
        pairs.append((swiglu_gate(x), swiglu_gate_plain(x)))
    if all(torch.equal(got, want) for got, want in pairs):
        return "bit for bit"
    for got, want in pairs:
        ulp = GATE_ULP[want.dtype]
        gap = (got.float() - want.float()).abs()
        if not bool((gap <= ulp * want.float().abs() + 1e-30).all()):
            raise AssertionError(f"swiglu_gate: max err {gap.max().item():.3g} against "
                                 f"the plain version ({want.dtype}: one ulp allowed)")
    return "within one ulp"


def _rope(device: torch.device) -> str:
    """The rotation on its vec route (bf16, head_dim 16) and its scalar
    route (fp32, head_dim 12), 5 prefix rows and a 2 x 2 grid, against the
    plain version on the same packed qkv: bit for bit (the kernel rounds
    each op as the plain version's torch ops do)."""
    from basd_tpu_torch.ops.rope import rope_qk, rope_qk_plain, rope_table

    rng = np.random.default_rng(0)
    pairs = []
    for hd, dtype in ((16, torch.bfloat16), (12, torch.float32)):
        qkv = torch.from_numpy(rng.standard_normal((3, 9, 3 * 2 * hd)).astype(np.float32))
        qkv = qkv.to(device=device, dtype=dtype)
        table = rope_table(2, 2, hd).to(device)
        pairs += zip(rope_qk(qkv, table, 2, 5, hd ** -0.5),
                     rope_qk_plain(qkv, table, 2, 5, hd ** -0.5))
    return _bit_for_bit(pairs, "rope_qk")


def layernorm_excess(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| over the LayerNorm kernel's allowance (`LN_ROW_ULPS`),
    in fp64, value by value: at most 1 where the kernel agrees."""
    g, w = got.double(), want.double()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - (8 if want.dtype == torch.bfloat16 else 24))
    row = w.abs().amax(dim=-1, keepdim=True) * (LN_ROW_ULPS * 2.0**-23)
    return (g - w).abs() / (ulp + row)


def _layernorm(device: torch.device) -> str:
    """The LayerNorm on its warp route (bf16, D 64), its CTA route (bf16, D
    2,048) and its scalar route (fp32, D 13), each as the library reports
    it on the card, against the plain version on the same rows: within
    `layernorm_excess`'s allowance."""
    from basd_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain, layernorm_route

    rng = np.random.default_rng(0)
    pairs = []
    for rows, d, dtype, route in ((5, 64, torch.bfloat16, "warp"),
                                  (3, 2048, torch.bfloat16, "cta"),
                                  (3, 13, torch.float32, "scalar")):
        x = torch.from_numpy((2.0 * rng.standard_normal((rows, d)) + 0.5).astype(np.float32))
        w, b = (torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(device)
                for _ in range(2))
        x = x.to(device=device, dtype=dtype)
        got = layer_norm(x, w, b, 1e-6)
        took = layernorm_route(x, got, w, b) if device.type == "cuda" else route
        if took != route:
            raise AssertionError(f"layernorm ({rows}, {d}) {dtype}: route {took}, want {route}")
        pairs.append((got, layer_norm_plain(x, w, b, 1e-6)))
    if all(torch.equal(got, want) for got, want in pairs):
        return "bit for bit"
    worst = max(layernorm_excess(got, want).max().item() for got, want in pairs)
    if not worst <= 1.0:
        raise AssertionError(f"layernorm: {worst:.3g} times the allowance against the plain "
                             f"version (one ulp, {LN_ROW_ULPS} fp32 ulps of the row)")
    return "within one ulp"


# (name, check): each check launches its kernels on `device` and returns
# what it read, or raises
KERNEL_CHECKS = (
    ("attention", _attention),
    ("attention_bwd", _attention_bwd),
    ("warp", _warp),
    ("jacobi", _jacobi),
    ("mp_rank", _mp_rank),
    ("swiglu_gate", _swiglu_gate),
    ("rope_qk", _rope),
    ("layernorm", _layernorm),
)


def run_kernel_checks(device) -> dict[str, str | Exception]:
    """Every check of `KERNEL_CHECKS` on `device`, each run whatever the
    others did: {name: what it read, or the exception it raised}."""
    device = torch.device(device)
    results: dict[str, str | Exception] = {}
    for name, check in KERNEL_CHECKS:
        try:
            results[name] = check(device)
        except Exception as e:  # noqa: BLE001 -- reported, then raised
            results[name] = e
    return results


def _key(device: torch.device) -> str:
    index = torch.cuda.current_device() if device.index is None else device.index
    return f"{device.type}:{index}"


def validate_kernel_dispatches(device, *, verbose: bool = True) -> dict[str, int]:
    """Run every kernel once on `device` against its plain version, once
    per process and device; raise a `RuntimeError` naming each kernel that
    failed, chained to the first failure's own error. Returns the launches
    that the checks made, by kernel (all zero on the CPU and when this
    device was already checked)."""
    device = torch.device(device)
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    if device.type == "cpu":
        return launches
    key = _key(device)
    if key in _VALIDATED:
        return launches
    before = dict(kernels.LAUNCHES)
    results = run_kernel_checks(device)
    launches = {n: kernels.LAUNCHES[n] - before[n] for n in before}
    failed = {n: r for n, r in results.items() if isinstance(r, Exception)}
    if verbose:
        for name, r in results.items():
            state = f"FAILED ({type(r).__name__}: {r})" if name in failed else f"ok, {r}"
            print(f"kernel_smoke {name} {state}", flush=True)
    if failed:
        raise RuntimeError(
            f"kernel check on {key} failed: "
            + "; ".join(f"{n}: {type(e).__name__}: {e}" for n, e in failed.items())
        ) from next(iter(failed.values()))
    _VALIDATED.add(key)
    return launches
