"""The last tools of the port on the CPU at small sizes, against the JAX
tools they port: `probe_ns_mixed` (the Newton-Schulz square root by
per-step precision schedules), `probe_warp_kernel` and
`probe_warp_parity8` (K4 against the tap sweep, and the card against the
CPU). The JAX tools are loaded from `tools/`
and run with their warp or square-root call replaced by a recorder, so
their own numpy draws are read, not copied."""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.ops import augment as jaug
from basd_tpu.spectral import ops as jops
from basd_tpu_torch.ops import warp_kernel as wk
from basd_tpu_torch.spectral.ops import _NS_SQRT_SCHED
from basd_tpu_torch.tools import (
    probe_ns_mixed,
    probe_warp_kernel,
    probe_warp_parity8,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"{name}_jax", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Recorded(Exception):
    """Raised by a recorder once it holds the call's arguments."""


def _record(store):
    def recorder(*args, **kwargs):
        store.extend(np.asarray(a) for a in args)
        raise _Recorded
    return recorder


# ---- probe_ns_mixed ----


def test_ns_schedules_are_the_jax_probes_with_tf32_beside_them():
    """The JAX probe's four schedules (DEFAULT -> bf16, HIGH -> fp32), by
    name and per-step precision, then its three mixed ones with TF32; each
    as long as the seven-step quintic, which equals the JAX package's."""
    assert _NS_SQRT_SCHED == jops._NS_SQRT_SCHED and len(_NS_SQRT_SCHED) == 7
    src = (ROOT / "tools" / "probe_ns_mixed.py").read_text()
    jax_names = re.findall(r'^\s*\("([^"]+)", \(_(?:HIGH|DEF)', src, re.M)
    assert jax_names == ["all-HIGH (shipping)", "DEF*5 + HIGH*2", "DEF*4 + HIGH*3",
                         "all-DEFAULT"]
    rename = lambda s: s.replace("DEFAULT", "bf16").replace("DEF", "bf16").replace(
        "HIGH", "fp32")
    scheds = probe_ns_mixed.schedules()
    names = [name for name, _ in scheds]
    assert names[:4] == [rename(n) for n in jax_names]
    assert names[4:] == [n.replace("bf16", "tf32") for n in names[1:4]]
    for name, precs in scheds:
        assert len(precs) == len(jops._NS_SQRT_SCHED), name
        m = re.match(r"(\w+)\*(\d) \+ fp32\*(\d)", name)
        if m:
            low, k_low, k_high = m.group(1), int(m.group(2)), int(m.group(3))
            assert precs == (low,) * k_low + ("fp32",) * k_high, name
        else:
            assert set(precs) == {name.split()[0].split("-")[1]}, name


def test_ns_grams_are_the_jax_probes_draws(monkeypatch):
    """The JAX probe at its smoke shape hands `ns_value` the port's Grams,
    bit for bit."""
    jprobe = _jax_tool("probe_ns_mixed")
    seen = []
    monkeypatch.setenv("BASD_PROBE_SMOKE", "1")
    monkeypatch.setattr(jprobe, "ns_value", _record(seen))
    monkeypatch.setattr(jprobe, "jax", type("eager", (), {"jit": staticmethod(lambda f: f)}))
    with pytest.raises(_Recorded):
        jprobe.main()
    s = probe_ns_mixed.SMOKE
    np.testing.assert_array_equal(seen[0], probe_ns_mixed.grams(1, s["bp"], s["n_tok"], s["d"]))
    np.testing.assert_array_equal(seen[1], probe_ns_mixed.grams(2, s["bp"], s["n_tok"], s["d"]))


def test_ns_value_at_fp32_matches_the_jax_probe_at_high():
    """All-fp32 against the JAX probe's all-HIGH on the smoke Grams (the CPU
    ignores JAX's precision, so both are fp32 products): rtol 2e-4, the
    fp32 floor of seven quintic steps on Grams whose spectrum decays to
    1e-6. There the JAX probe's own eager and jitted calls differ by
    7.6e-5, and fp32 is 2.2e-4 from the same iteration in float64; the
    port reads 1.0e-4."""
    jprobe = _jax_tool("probe_ns_mixed")
    s = probe_ns_mixed.SMOKE
    gs, gt = (probe_ns_mixed.grams(seed, s["bp"], s["n_tok"], s["d"]) for seed in (1, 2))
    high = (jax.lax.Precision.HIGH,) * 7
    want = np.asarray(jprobe.ns_value(jnp.asarray(gs), jnp.asarray(gt), high))
    jitted = np.asarray(jax.jit(lambda a, b: jprobe.ns_value(a, b, high))(gs, gt))
    got = probe_ns_mixed.ns_value(torch.from_numpy(gs), torch.from_numpy(gt), ("fp32",) * 7)
    floor = np.max(np.abs(jitted - want) / np.abs(want))
    assert 1e-5 < floor < 2e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4)


def test_ns_value_bf16_rounds_the_operands():
    """A bf16 step multiplies bf16-rounded operands in fp32: one bf16 step
    moves the value, and a TF32 schedule is fp32 on the CPU."""
    s = probe_ns_mixed.SMOKE
    gs, gt = (torch.from_numpy(probe_ns_mixed.grams(seed, s["bp"], s["n_tok"], s["d"]))
              for seed in (1, 2))
    fp32 = probe_ns_mixed.ns_value(gs, gt, ("fp32",) * 7)
    assert torch.equal(probe_ns_mixed.ns_value(gs, gt, ("tf32",) * 7), fp32)
    assert not torch.equal(probe_ns_mixed.ns_value(gs, gt, ("bf16",) + ("fp32",) * 6), fp32)
    p, q = gs[:2], gt[:2]
    want = p.to(torch.bfloat16).float() @ q.to(torch.bfloat16).float()
    assert torch.equal(probe_ns_mixed._mm(p, q, "bf16"), want)
    with pytest.raises(ValueError, match="6 precisions for 7 steps"):
        probe_ns_mixed.ns_value(gs, gt, ("fp32",) * 6)


def test_probe_ns_mixed_prints_every_schedule(capsys):
    before = torch.backends.cuda.matmul.allow_tf32
    out = probe_ns_mixed.main(device="cpu", **probe_ns_mixed.SMOKE)
    assert torch.backends.cuda.matmul.allow_tf32 == before
    text = capsys.readouterr().out
    names = [name for name, _ in probe_ns_mixed.schedules()]
    assert list(out) == names and text.count("not measured (cpu)") == 7
    for name in names:
        assert re.search(rf"^{re.escape(name)}\s*: relerr max ", text, re.M), name
    # against float64 eigvals: fp32 is within 1e-3 at the smoke shape
    assert out["all-fp32 (shipping)"]["relerr_max"] < 1e-3
    assert out["all-tf32"] == out["all-fp32 (shipping)"]


# ---- the warp probes ----


def _eager(monkeypatch, module):
    monkeypatch.setattr(module, "jax", type("eager", (), {
        "jit": staticmethod(lambda f: f), "default_backend": staticmethod(jax.default_backend),
        "tree_util": jax.tree_util}))


def test_warp_kernel_probe_draws_are_the_jax_probes(monkeypatch):
    """The JAX probe at its smoke shape hands the fused warp the port's
    images, five op magnitudes and flip mask, bit for bit."""
    jprobe = _jax_tool("probe_warp_kernel")
    seen = []
    monkeypatch.setenv("BASD_PROBE_SMOKE", "1")
    _eager(monkeypatch, jprobe)
    monkeypatch.setattr(jprobe, "_geometric_warp", lambda x, *rest: x)
    monkeypatch.setattr(jprobe, "fused_geometric_warp", _record(seen))
    with pytest.raises(_Recorded):
        jprobe.main()
    x, vals, flip = probe_warp_kernel.probe_inputs(**probe_warp_kernel.SMOKE)
    for got, want in zip((x, *vals, flip), seen):
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(seen) == 7


@pytest.mark.parametrize("params", ["its_own", "geometric"])
def test_tap_sweep_path_matches_the_jax_probes_xla_path(params, monkeypatch):
    """The JAX probe's own `xla_path` (the conjugated-hflip production form,
    jitted), taken from its smoke run with its flip mask, against the
    port's `tap_sweep_path` on the same inputs: the smoke draw itself (no
    geometric row at that size), and parity8's smoke rows that are
    geometric (turns of -135, 121.5 and -45 degrees, shears in x and y, an
    x translation) plus one that is not, given a y translation (none is
    drawn at that size), at 24 px. atol 1e-6, the bound of
    `tests/test_torch_warp.py`'s XLA comparisons (measured 0.0 on the smoke
    draw, 1.2e-7, one ulp below 1, on the geometric rows)."""
    jprobe = _jax_tool("probe_warp_kernel")
    seen = []
    monkeypatch.setenv("BASD_PROBE_SMOKE", "1")
    _eager(monkeypatch, jprobe)
    monkeypatch.setattr(jprobe, "fused_geometric_warp", lambda x, *rest, **kw: x)

    def record_slope(fn, args):
        seen.append((fn, args))
        raise _Recorded

    monkeypatch.setattr(jprobe, "slope", record_slope)
    with pytest.raises(_Recorded):
        jprobe.main()
    xla_path, args = seen[0]
    assert xla_path.__name__ == "xla_path"
    x, vals, flip = probe_warp_kernel.probe_inputs(**probe_warp_kernel.SMOKE)
    if params == "geometric":
        x24, vals24, _ = probe_warp_kernel.probe_inputs(**probe_warp_parity8.SMOKE)
        rows = [4, 5, 6, 8, 10, 12, 14, 0]
        x, vals = x24[rows], tuple(v[rows] for v in vals24)
        vals[4][7] = -12.8
        assert all(bool((v != 0).any()) for v in vals)
    else:
        assert not any(bool((v != 0).any()) for v in vals)
        for got, want in zip((x, *vals), args):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = np.asarray(jax.jit(xla_path)(*(jnp.asarray(t.numpy()) for t in (x, *vals))))
    got = probe_warp_kernel.tap_sweep_path(x, vals, flip).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_warp_parity8_draws_are_the_jax_probes(monkeypatch):
    """The JAX parity probe's batched graph at (256, 224, 224, 3) is fed the
    port's flipped images and five op magnitudes, bit for bit."""
    jprobe = _jax_tool("probe_warp_parity8")
    seen = []
    monkeypatch.setattr(jax, "jit", lambda f: f)
    monkeypatch.setattr(jaug, "_geometric_warp", _record(seen))
    with pytest.raises(_Recorded):
        jprobe.build()
    x, vals, flip = probe_warp_kernel.probe_inputs(256, 224)
    np.testing.assert_array_equal(seen[0], torch.where(flip[:, None, None, None],
                                                       x.flip(2), x).numpy())
    for got, want in zip(vals, seen[1:]):
        np.testing.assert_array_equal(got.numpy(), want)
    assert not bool(flip[probe_warp_parity8.SAMPLE])  # sample 4 is unflipped


def test_probe_warp_kernel_paths_agree_on_the_cpu(capsys):
    """The conjugated-hflip tap sweep and the fused path's plain version
    within the JAX package's fused-vs-XLA tolerance, 1e-5 (0.0 measured),
    at parity8's smoke size, where 7 of 15 rows are geometric (none is at
    the JAX probe's smoke size)."""
    out = probe_warp_kernel.main(device="cpu", **probe_warp_parity8.SMOKE)
    text = capsys.readouterr().out
    assert out["parity_max_err"] <= 1e-5 and out["route"] == "cta"
    assert out["tap_sweep_ms"] is None and out["fused_ms"] is None
    src = (ROOT / "tools" / "probe_warp_kernel.py").read_text()
    assert 'print(f"parity max err:' in src
    assert "parity max err: " in text and "fused: not measured (cpu)" in text


def test_warp_parity8_reads_zero_with_the_cpu_on_both_sides(capsys):
    diffs = probe_warp_parity8.main(device="cpu", **probe_warp_parity8.SMOKE)
    assert len(diffs) == 6 and set(diffs.values()) == {0.0}
    text = capsys.readouterr().out
    for tag in ("cpu-batched vs cpu-iso4", "cpu-batched vs card-batched",
                "cpu-batched vs card-iso4", "card-batched vs card-iso4"):
        assert re.search(rf"^{tag}\s*: 0\.000e\+00$", text, re.M), tag


@pytest.mark.parametrize("sample", [True, False])
def test_warp_parity8_raises_on_a_one_ulp_param(sample, monkeypatch):
    """sin(residual) one ulp off in `warp_params` on the "card" side, at
    sample 4's angle or at another rotated row's, breaks the batch's parity
    (and sample 4's, where it is sample 4's angle): the error names the
    (row, column) of the param."""
    x, vals, flip = probe_warp_kernel.probe_inputs(**probe_warp_parity8.SMOKE)
    cpu = probe_warp_parity8.side(x, vals, flip, CPU)
    angle = vals[0]
    rotated = torch.nonzero(cpu["params"][:, 1]).flatten().tolist()
    assert probe_warp_parity8.SAMPLE in rotated
    others = [r for r in rotated if angle[r] != angle[probe_warp_parity8.SAMPLE]]
    assert others
    row = probe_warp_parity8.SAMPLE if sample else others[-1]
    planted_rows = torch.nonzero(angle == angle[row]).flatten().tolist()
    real = wk.warp_params

    def one_ulp_off(a, *rest):
        p = real(a, *rest)
        hit = a == angle[row]
        p[:, 1] = torch.where(hit, torch.nextafter(p[:, 1], torch.tensor(1.0)), p[:, 1])
        return p

    monkeypatch.setattr(wk, "warp_params", one_ulp_off)
    card = probe_warp_parity8.side(x, vals, flip, CPU)
    diffs = probe_warp_parity8.differences(cpu, card)
    assert diffs["cpu vs card, params"] > 0 and diffs["cpu vs card, whole batch"] > 0
    assert (diffs["cpu-batched vs card-batched"] > 0) == sample
    assert (diffs["cpu-batched vs card-iso4"] > 0) == sample
    assert diffs["card-batched vs card-iso4"] == 0.0
    where = ", ".join(f"\\({r}, 1\\)" for r in planted_rows)
    with pytest.raises(AssertionError, match=rf"\(row, column\) \[{where}\]"):
        probe_warp_parity8.check(diffs, cpu, card)


@pytest.mark.parametrize("tool", [probe_ns_mixed, probe_warp_kernel, probe_warp_parity8],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tools_run_on_the_card_by_default(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main()

