"""The port's tools (`basd_tpu_torch.tools`) run on the CPU at micro
sizes through the plain versions of their kernels: each prints its
sections and returns rows; without CUDA the default device raises, and the
timing tools, which read device time only, refuse to run."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from basd_tpu_torch.ops.attn_probe import VARIANTS
from basd_tpu_torch.tools import (
    probe_attn_internals,
    probe_jacobi_sweeps,
    time_attn_probe,
    time_jacobi,
    time_warp,
    tune_spectral,
)

torch.set_num_threads(1)

MICRO = dict(teacher="vit_mini_patch4", student="vit_micro_patch4",
             img_size=16, batch=8, num_points=2)


def test_tune_spectral_micro(capsys):
    """vit_mini teacher (6 layers, D=96), vit_micro student (D=64) at
    16 px, batch 8, k=16: the MP ranks of K5's plain version equal LAPACK's
    once converged, the d^2 error of K3's plain version sits at the fp32
    floor, and the top-k grid errors fall as the iterations grow. The
    tool turns TF32 off for its own run only."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = tune_spectral.main(device="cpu", k=16, k5_sweeps=(3, 9),
                                 k3_sweeps=(4, 9), topk_grid=((3, 6), (6, 14)),
                                 **MICRO)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    text = capsys.readouterr().out
    for section in ("exact MP ranks", "jacobi eigenvalues kernel",
                    "jacobi eigh kernel", "topk_basis"):
        assert section in text
    assert "not measured (cpu)" in text
    assert out["cov_shape"] == (6, 64, 64)
    k5 = {r["sweeps"]: r for r in out["k5"]}
    assert k5[9]["ranks_equal"] and k5[9]["relerr"] < 1e-4
    assert all(r["ms"] is None for r in out["k5"] + out["k3"] + out["topk"])
    k3 = {r["sweeps"]: r for r in out["k3"]}
    assert k3[9]["d2_err"] < 1e-5 and k3[9]["d2_err"] <= k3[4]["d2_err"]
    t3, t6 = out["topk"]
    assert t6["weighted_sin2_err"] < t3["weighted_sin2_err"]


def test_probe_jacobi_sweeps_smoke(capsys):
    """SMOKE: (6, 16) at sweeps 2 and 3 on both spectrum families; one
    more sweep cuts the uniform family's error."""
    rows = probe_jacobi_sweeps.main(device="cpu", **probe_jacobi_sweeps.SMOKE)
    text = capsys.readouterr().out
    assert [(r["sweeps"], r["family"]) for r in rows] == [
        (2, "uniform"), (2, "angles"), (3, "uniform"), (3, "angles")]
    assert text.count("eig_err") == 4
    assert rows[2]["eig_err"] < rows[0]["eig_err"]


def test_probe_jacobi_sweeps_cases_match_the_jax_tool():
    """The spectrum families are the JAX tool's, draw for draw."""
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_jacobi_sweeps.py"
    spec = importlib.util.spec_from_file_location("probe_jacobi_sweeps_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = mod.make_cases(3, 12, np.random.default_rng(0))
    got = probe_jacobi_sweeps.make_cases(3, 12, np.random.default_rng(0))
    assert sorted(got) == sorted(want) == ["angles", "uniform"]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_probe_attn_internals_micro(capsys):
    out = probe_attn_internals.main(device="cpu", batch=16, heads=2, seq=17,
                                    head_dim=16)
    text = capsys.readouterr().out
    assert list(out["variants"]) == list(VARIANTS)
    for variant in VARIANTS:
        assert variant in text
    assert "K1 fwd" in text and out["attention_fwd"] is None


@pytest.mark.parametrize("tool", [tune_spectral, probe_jacobi_sweeps,
                                  probe_attn_internals])
def test_tools_default_to_cuda_and_refuse_without_it(tool):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main()


@pytest.mark.parametrize("tool", [time_jacobi, time_warp, time_attn_probe])
def test_timing_tools_refuse_without_cuda(tool):
    """The A/B timing tools read the card's device time and nothing else:
    without CUDA they raise before making any input."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main()
