"""The port's bench (`basd_tpu_torch.bench`) and its whole-step cost count
(`utils.profiling.step_cost_analysis`) on the CPU:

  * the count's FLOPs and transcendentals equal XLA's `cost_analysis` of
    the same function, exactly, through the JAX package's
    `step_cost_analysis`;
  * each kernel wrapper (K1, K2, K3, K5, K4), launched against a stand-in
    library, reports the FLOPs and transcendentals that the count reads
    from its plain version at the same shape, exactly;
  * `python -m basd_tpu_torch.bench --smoke` on the CPU prints the JAX
    bench's JSON line (`tests/test_bench_contract.py`), with the port's
    `launches` and `device`;
  * the Table-1, ViT-L/14 and Table-2 arms stage the student that the JAX
    package's `create_student` builds for `bench.py`'s arm;
  * the watchdog prints its error JSON first and exits with 3.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.losses import extraction_points as jax_extraction_points
from basd_tpu.models import create_student as jax_create_student
from basd_tpu.utils.profiling import step_cost_analysis as jax_step_cost_analysis
from basd_tpu_torch import bench, kernels
from basd_tpu_torch.losses import selector as selector_mod
from basd_tpu_torch.ops import attention as tattn
from basd_tpu_torch.ops import warp_kernel as twarp
from basd_tpu_torch.spectral import jacobi, jacobi_kernel
from basd_tpu_torch.utils.profiling import step_cost_analysis

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMOKE_S = 300  # a subprocess's limit, ten times a CPU smoke run


# ---- the cost count against XLA's ----------------------------------------

CHAINS = {
    # the product-and-transcendental chain: XLA reads 2 * 2 * 64 * 128 * 128
    # FLOPs and 64 * 128 tanh
    "tanh_chain": (
        lambda a, b: jnp.tanh(a @ b) @ b,
        lambda a, b: torch.tanh(a @ b) @ b,
        ((64, 128), (128, 128)),
    ),
    "batched_chain": (
        lambda x, w: jnp.exp(jnp.einsum("bij,bjk->bik", x, w)) @ jnp.swapaxes(w, -1, -2),
        lambda x, w: torch.exp(x @ w) @ w.transpose(-1, -2),
        ((3, 16, 32), (3, 32, 24)),
    ),
    "sqrt_rsqrt_chain": (
        lambda x, w: jax.lax.rsqrt(1.0 + jnp.sqrt(jnp.abs(x @ w))) @ jnp.swapaxes(w, -1, -2),
        lambda x, w: torch.rsqrt(1.0 + torch.sqrt(torch.abs(x @ w))) @ w.transpose(-1, -2),
        ((4, 8, 16), (4, 16, 8)),
    ),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_cost_count_equals_xla_cost_analysis(name):
    """FLOPs and transcendentals exactly equal (tolerance 0); the chains
    hold no elementwise arithmetic outside products and transcendentals
    that XLA would count as FLOPs, except the sqrt chain's abs and add,
    which XLA counts and the port does not: there the port reads exactly
    the products."""
    jax_fn, torch_fn, shapes = CHAINS[name]
    rng = np.random.default_rng(0)
    args = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = jax_step_cost_analysis(jax.jit(jax_fn), *args)
    got = step_cost_analysis(torch_fn, *map(torch.from_numpy, args))
    assert got["transcendentals"] == want["transcendentals"]
    products = 2 * 2 * int(np.prod(shapes[0])) * shapes[1][-1]
    assert got["flops"] == products
    if name != "sqrt_rsqrt_chain":
        assert got["flops"] == want["flops"]
    else:
        assert want["flops"] > products  # XLA's count has the elementwise ops
    assert got["bytes_accessed"] >= want["bytes_accessed"] > 0  # the unfused sum


def test_cost_count_takes_the_backward_and_nothing_after():
    """A function that runs a backward is counted with it (3 products of a
    linear layer instead of 1); a finished count sees no later work."""
    w = torch.randn(32, 16, requires_grad=True)
    x = torch.randn(8, 32)
    fwd = step_cost_analysis(lambda: (x @ w).sum())
    both = step_cost_analysis(lambda: torch.autograd.grad((x @ w).sum(), w))
    assert fwd["flops"] == 2 * 8 * 32 * 16
    assert both["flops"] == 2 * fwd["flops"]  # dW = x^T g; no dx for a leaf input
    assert kernels.COST_TALLIES == []


# ---- each kernel wrapper's report against its plain version --------------

class _StandIn:
    """A kernel library whose entry points launch nothing and succeed."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(kernels, "library", lambda name: _StandIn())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(jacobi_kernel, "_stream", lambda a: 0)
    monkeypatch.setattr(twarp, "_stream", lambda x: 0)
    for name in kernels.LAUNCHES:
        monkeypatch.setitem(kernels.LAUNCHES, name, 0)


def _no_bytes(cost):
    return {k: v for k, v in cost.items() if k != "bytes_accessed"}


def _attention_inputs(b=2, n=17, d=48, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, n, d), generator=g).to(torch.bfloat16) for _ in range(4)]


def test_attention_forward_reports_its_plain_version_cost(stand_in):
    """K1 at (2, 17, 48) H=3: the wrapper's report equals the count of the
    plain version (2 products, one exp a score), exactly."""
    q, k, v, _ = _attention_inputs()
    want = step_cost_analysis(tattn.attention_forward_plain, q, k, v, 16)
    got = step_cost_analysis(tattn._attention_forward_cuda, q, k, v, 16)
    assert _no_bytes(got) == _no_bytes(want)
    assert want["flops"] == 4 * 2 * 17 * 17 * 48 and want["transcendentals"] == 2 * 3 * 17 * 17
    assert kernels.LAUNCHES["attention_fwd"] == 1
    # inputs read once, outputs written once
    assert got["bytes_accessed"] == 4 * (2 * 17 * 48) * 2 + 2 * (2 * 17 * 3) * 4


def test_attention_backward_reports_its_plain_version_cost(stand_in):
    """K2 at (2, 17, 48) H=3: 5 products and one exp a score, as the plain
    version."""
    q, k, v, do = _attention_inputs()
    _, m, denom = tattn.attention_forward_plain(q, k, v, 16)
    dd = torch.randn((2, 17, 3))
    want = step_cost_analysis(tattn.attention_backward_plain, q, k, v, do, m, denom, dd, 16)
    got = step_cost_analysis(tattn._attention_backward_cuda, q, k, v, do, m, denom, dd, 16)
    assert _no_bytes(got) == _no_bytes(want)
    assert want["flops"] == 10 * 2 * 17 * 17 * 48
    assert kernels.LAUNCHES["attention_bwd"] == 1


@pytest.mark.parametrize("n", [6, 7, 48, 120])
def test_jacobi_kernels_report_their_plain_version_cost(stand_in, n):
    """K3 (eigh, both routes: n = 120 is packed_log) and K5 (eigenvalues)
    at sweeps 2: no products and two square roots a rotation, as the plain
    versions; an odd n counts its padded size on both sides."""
    g = torch.Generator().manual_seed(n)
    x = torch.randn((3, n, n), generator=g)
    a = x @ x.transpose(-1, -2)
    padded, _ = jacobi.symmetrize_pad(a)
    want = step_cost_analysis(lambda: jacobi.jacobi_eigh(a, sweeps=2))
    got = step_cost_analysis(lambda: jacobi_kernel._jacobi_raw_cuda(padded, 2))
    assert _no_bytes(got) == _no_bytes(want)
    m = n + n % 2
    assert want["transcendentals"] == 3 * m * (m - 1) * 2 and want["flops"] == 0
    want5 = step_cost_analysis(lambda: jacobi.jacobi_eigvals(a, sweeps=2))
    got5 = step_cost_analysis(lambda: jacobi_kernel._jacobi_eigvals_raw_cuda(padded, 2))
    assert _no_bytes(got5) == _no_bytes(want5)
    assert kernels.LAUNCHES["jacobi_eigh"] == kernels.LAUNCHES["jacobi_eigvals"] == 1


def test_warp_reports_its_plain_version_cost(stand_in):
    """K4 at (2, 16, 16, 3): the plain version's taps are elementwise, so
    both read no FLOPs and no transcendentals; the kernel moves its images
    in and out once."""
    g = torch.Generator().manual_seed(0)
    images = torch.rand((2, 16, 16, 3), generator=g)
    params = twarp.warp_params(*(torch.rand(2, generator=g) for _ in range(5)))
    want = step_cost_analysis(twarp.geometric_warp_plain, images, params)
    got = step_cost_analysis(twarp._warp_cuda, images, params)
    assert _no_bytes(got) == _no_bytes(want) == {"flops": 0.0, "transcendentals": 0.0}
    assert got["bytes_accessed"] == 2 * images.numel() * 4 + params.numel() * 4
    assert kernels.LAUNCHES["warp"] == 1


# ---- the bench --------------------------------------------------------------

ARCH_KEYS = ("img_size", "patch_size", "embed_dim", "depth", "num_heads",
             "num_tokens", "params_m", "remat")


def test_bench_smoke_json_contract():
    """`bench.main(["--smoke"], device="cpu")` in a process of its own:
    one JSON line last, the JAX bench's keys (tests/test_bench_contract.py)
    and the port's three additions."""
    code = ("from basd_tpu_torch import bench\n"
            "bench.main(['--smoke'], device='cpu')\n")
    env = dict(os.environ, BASD_BENCH_WATCHDOG_S="0")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=SMOKE_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metric"] == "vit_tiny_basd_distill_throughput_smoke"
    assert out["unit"] == "images/sec/chip"
    assert out["value"] > 0 and out["vs_baseline"] is None
    d = out["detail"]
    assert d["smoke"] is True and d["teacher"] == "dinov2_vitb14"
    assert d["student"] == "vit_tiny_patch16_img32" and d["raw_input_px"] == 40
    assert all(key in d["student_arch"] for key in ARCH_KEYS)
    assert d["student_arch"]["patch_size"] == 4 and d["student_arch"]["num_tokens"] == 65
    assert np.isfinite(d["loss"])
    assert 0 < d["mfu_vs_bf16_peak"] < 1
    assert d["kernel_fallbacks"] == []
    assert d["launches"] == dict.fromkeys(kernels.LAUNCHES, 0)  # the CPU launches none
    assert d["device"] == "cpu" and d["step_route"] == "eager"
    assert set(d) == {"step_time_ms", "batch", "chips", "teacher", "student",
                      "student_arch", "raw_input_px", "loss", "smoke",
                      "mfu_vs_bf16_peak", "kernel_fallbacks", "launches",
                      "step_route", "device"}


# bench.py's arms (bench.py:147-201), as --smoke shrinks them: the JAX
# package's student for each, computed here without running bench.py
JAX_ARMS = {
    "table1": (["--imagenet"], "vit_small_patch16", None, 1000,
               "vit_small_imagenet_basd_distill_throughput_smoke", "dinov2_vitb14"),
    "table1_vitl14": (["--imagenet", "--teacher", "dinov2_vitl14"], "vit_small_patch16",
                      None, 1000, "vit_small_imagenet_basd_distill_throughput"
                      "_teacher_dinov2_vitl14_smoke", "dinov2_vitl14"),
    "table2": (["--cross-arch"], "vit_tiny_patch16", None, 1000,
               "vit_tiny_cross_arch_basd_distill_throughput_smoke", "convnextv2_tiny"),
}


@pytest.mark.parametrize("arm", sorted(JAX_ARMS))
def test_bench_arm_stages_the_jax_bench_student(arm, monkeypatch, capsys):
    """In process through `main(argv, device="cpu")`: the metric, teacher,
    `student_arch` and `raw_input_px` are what bench.py's arm gives with the
    JAX package's `create_student` at --smoke's 64 px. The staging and the
    JSON are under test here, not the timing, the calibration or the
    selector's ranks (the subprocess test runs them all, and
    tests/test_torch_losses.py holds the selector): batch 2 (`--batch`,
    which adds its suffix), one warm-up step, K = 16 in place of the
    calibrated 383 of these few tokens, and MP ranks held at K (the
    sequential Householder takes about 10 s a CPU step on ViT-L/14's 24
    layers)."""
    argv, preset, overrides, classes, metric, teacher = JAX_ARMS[arm]
    monkeypatch.setattr(bench, "WARMUP_STEPS", 1)
    monkeypatch.setattr(bench, "calibrate_subspace_k", lambda *a, **k: 16)
    monkeypatch.setattr(selector_mod, "marchenko_pastur_rank_gram",
                        lambda g, m: torch.full(g.shape[:1], 16, device=g.device))
    monkeypatch.setenv("BASD_BENCH_WATCHDOG_S", "0")
    out = bench.main([*argv, "--smoke", "--batch", "2"], device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    img = 64
    student, cfg = jax_create_student(
        preset, num_classes=classes, drop_path_rate=0.05, img_size=img,
        arch_overrides=overrides, capture_layers=jax_extraction_points(12, 4),
        dtype=jnp.bfloat16, remat=False)
    shapes = jax.eval_shape(lambda: student.init(
        jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), train=False))["params"]
    params = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes))
    d = out["detail"]
    assert out["metric"] == f"{metric}_b2" and d["teacher"] == teacher
    assert d["student_arch"] == {
        "img_size": cfg.img_size, "patch_size": cfg.patch_size,
        "embed_dim": cfg.embed_dim, "depth": cfg.depth, "num_heads": cfg.num_heads,
        "num_tokens": cfg.num_patches + 1, "params_m": round(params / 1e6, 3),
        "remat": False,
    }
    assert d["raw_input_px"] == img + 2 * cfg.patch_size
    assert d["batch"] == 2 and np.isfinite(d["loss"]) and d["mfu_vs_bf16_peak"] > 0


def test_bench_refuses_the_cpu_unless_asked(monkeypatch):
    """The default device is the card; without one the bench raises before
    staging anything."""
    monkeypatch.setenv("BASD_BENCH_WATCHDOG_S", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--smoke"])


def test_bench_watchdog_emits_error_json():
    """A hung run prints the error JSON as its first line and exits 3
    (the JAX bench's contract, tests/test_bench_contract.py)."""
    env = dict(os.environ, BASD_BENCH_WATCHDOG_S="1", BASD_BENCH_TEST_HANG="1")
    proc = subprocess.run([sys.executable, "-m", "basd_tpu_torch.bench"], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3, (proc.returncode, proc.stdout[-500:], proc.stderr[-500:])
    out = json.loads(proc.stdout.strip().splitlines()[0])
    assert out["value"] == 0.0 and out["unit"] == "images/sec/chip"
    assert "watchdog" in out["error"]


def test_arm_config_follows_the_jax_bench():
    """Step counts, batches and metric suffixes of every arm."""
    cfg = lambda *a: bench.arm_config(bench.parse_args(list(a)))
    assert (cfg()["n1"], cfg()["n2"], cfg()["batch"]) == (10, 110, 128)
    t1 = cfg("--imagenet", "--teacher", "dinov2_vitl14", "--batch", "64")
    assert (t1["n1"], t1["n2"], t1["batch"], t1["img_size"]) == (4, 24, 64, 224)
    assert t1["metric"] == "vit_small_imagenet_basd_distill_throughput_teacher_dinov2_vitl14_b64"
    assert cfg("--cross-arch", "--smoke")["img_size"] == 64
    with pytest.raises(SystemExit):
        cfg("--imagenet", "--cross-arch")
