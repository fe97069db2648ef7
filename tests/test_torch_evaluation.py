"""The port's evaluation (M7) against the JAX package's: `evaluate_model`
on weights carried with `carry_vit` in fp32 gives equal top-1/top-5
counts and a loss within rtol 1e-5, with and without class-subset
masking, a short tail batch included; the top-5 tie rule is
`jax.lax.top_k`'s; the FLOP count equals an analytic count of the ViT's
matrix products; `run_eval_suite` gives the JAX package's metrics.json
schema and primary numbers."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.config import compose_config as jax_compose_config
from basd_tpu.evaluation import metrics as jmetrics
from basd_tpu.models import create_student as jax_create_student
from basd_tpu_torch.config import compose_config
from basd_tpu_torch.evaluation import metrics as tmetrics
from basd_tpu_torch.models import create_student
from test_torch_helpers import CPU, carry_vit

torch.set_num_threads(1)

RTOL_LOSS = 1e-5
IMG, RAW, C = 16, 24, 10
KW = dict(img_size=IMG, crop_ratio=IMG / RAW, mean=(0.5, 0.45, 0.4),
          std=(0.25, 0.2, 0.3), batch_size=8)


@pytest.fixture(scope="module")
def models():
    js, _ = jax_create_student("vit_micro_patch4", num_classes=C, drop_path_rate=0.0,
                               img_size=IMG, dtype=jnp.float32, remat=False)
    params = js.init(jax.random.PRNGKey(3), jnp.zeros((1, IMG, IMG, 3)),
                     train=False)["params"]
    ts, _ = create_student("vit_micro_patch4", num_classes=C, drop_path_rate=0.0,
                           img_size=IMG, dtype=torch.float32, remat=False, device=CPU)
    carry_vit(params, ts)
    return js, params, ts


def _split(n=29, classes=C, seed=0):
    rng = np.random.default_rng(seed)
    images = (rng.random((n, RAW, RAW, 3)) * 255).astype(np.uint8)
    return images, rng.integers(0, classes, n).astype(np.int32)


@pytest.mark.parametrize("subset", [None, (7, 2, 9, 4), (3, 1, 8, 0, 5, 6)])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_evaluate_model_matches_the_jax_package(models, subset, smoothing):
    """29 images at batch 8: three full batches and a tail of 5. (The JAX
    package pads a tail with `zeros_like(tail[:pad])`, which is short of
    `pad` rows when the tail is under half a batch; the port runs the tail
    at its own size.)"""
    js, params, ts = models
    images, labels = _split(classes=len(subset) if subset else C)
    want = jmetrics.evaluate_model(js.apply, params, images, labels,
                                   valid_indices=subset, label_smoothing=smoothing,
                                   model=js, **KW)
    got = tmetrics.evaluate_model(ts, None, images, labels, valid_indices=subset,
                                  label_smoothing=smoothing, **KW)
    # equal counts give equal percentages: both compute 100 * count / n
    assert got["val_acc"] == want["val_acc"]
    assert got["val_acc_top5"] == want["val_acc_top5"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL_LOSS)
    if subset and len(subset) <= 5:
        assert got["val_acc_top5"] == 100.0


@pytest.mark.parametrize("n", [27, 25])
def test_a_short_tail_batch_gives_the_one_batch_sums(models, n):
    """Tails of 3 and 1 at batch 8 (which the JAX package cannot pad) give
    the counts of one batch of all n images, and its loss within 1e-6."""
    _, _, ts = models
    images, labels = _split(n=n)
    got = tmetrics.evaluate_model(ts, None, images, labels, **KW)
    one = tmetrics.evaluate_model(ts, None, images, labels, **{**KW, "batch_size": n})
    assert (got["val_acc"], got["val_acc_top5"]) == (one["val_acc"], one["val_acc_top5"])
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)


def test_evaluate_model_at_other_params_leaves_the_model_untouched(models):
    _, _, ts = models
    images, labels = _split()
    before = {k: v.clone() for k, v in ts.state_dict().items()}
    other = {k: v * 0.5 for k, v in ts.named_parameters()}
    at_other = tmetrics.evaluate_model(ts, other, images, labels, **KW)
    assert all(torch.equal(before[k], v) for k, v in ts.state_dict().items())
    own = tmetrics.evaluate_model(ts, None, images, labels, **KW)
    assert own["loss"] != at_other["loss"]
    same = tmetrics.evaluate_model(ts, dict(ts.named_parameters()), images, labels, **KW)
    assert same == own


def _jax_hits(logits, labels, k):
    _, top = jax.lax.top_k(jnp.asarray(logits), k)
    return np.asarray(jnp.any(top == jnp.asarray(labels)[:, None], axis=-1))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_breaks_ties_as_jax_lax_top_k(k):
    """Logits drawn from three values: every row is full of ties, and a
    label inside a tied group is a hit only when few enough of its group
    sit at lower indices."""
    rng = np.random.default_rng(k)
    logits = rng.integers(0, 3, (64, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 64)
    got = tmetrics.topk_hits(torch.from_numpy(logits), torch.from_numpy(labels), k)
    want = _jax_hits(logits, labels, k)
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(want)
    # torch.topk's own choice may differ on ties; the rule is the index order
    row = np.zeros((1, 10), np.float32)
    for label in range(10):
        hit = tmetrics.topk_hits(torch.from_numpy(row), torch.tensor([label]), k)
        assert bool(hit) == (label < k)


def _analytic_vit_flops(d, depth, heads, mlp_ratio, img, patch, classes):
    """2 flops per multiply-add of the ViT's matrix products at batch 1."""
    p = (img // patch) ** 2
    n = p + 1
    hidden = int(d * mlp_ratio)
    block = (2 * n * d * 3 * d + 2 * n * n * d * 2 + 2 * n * d * d
             + 2 * n * d * hidden * 2)
    return 2 * p * d * 3 * patch * patch + depth * block + 2 * d * classes


@pytest.mark.parametrize("preset,img,overrides,dtype", [
    ("vit_micro_patch4", 16, {}, torch.float32),
    ("vit_tiny_patch16", 32, {"patch_size": 4}, torch.bfloat16),
    ("vit_micro_patch4", 24, {"embed_dim": 96, "num_heads": 3, "depth": 2}, torch.float32),
])
def test_flop_count_is_the_vits_matrix_products(preset, img, overrides, dtype):
    model, cfg = create_student(preset, num_classes=100, drop_path_rate=0.0, img_size=img,
                                arch_overrides=overrides, dtype=dtype, device=CPU)
    want = _analytic_vit_flops(cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.mlp_ratio,
                               img, cfg.patch_size, 100)
    assert tmetrics.count_flops(model, img) == want


def test_measure_efficiency_counts_the_jax_packages_params(models):
    js, params, ts = models
    got = tmetrics.measure_efficiency(ts, None, image_size=IMG, batch_size=4,
                                      num_warmup=1, num_batches=2)
    want_count = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))
    assert got["param_count"] == want_count
    assert got["param_count_m"] == want_count / 1e6
    assert got["gflops"] == tmetrics.count_flops(ts, IMG) / 1e9
    assert got["throughput_img_per_sec"] > 0


def test_run_eval_suite_gives_the_jax_packages_schema_and_numbers(models, tmp_path):
    """basd_smoke's primary split (128 images at batch 16) at carried
    weights; the efficiency numbers are the port's own."""
    js, params, ts = models
    ov = ["experiment=basd_smoke", "evaluation.efficiency_batches=2"]
    want = jmetrics.run_eval_suite(js.apply, params, jax_compose_config(ov),
                                   config_path="c.yaml", model=js)
    got = tmetrics.run_eval_suite(ts, None, compose_config(ov), config_path="c.yaml")

    def schema(tree):
        return {k: schema(v) for k, v in tree.items()} if isinstance(tree, dict) else None

    assert schema(got) == schema(want)
    assert got["run"] == want["run"]
    for key in ("dataset", "val_acc", "val_acc_top5"):
        assert got["primary"][key] == want["primary"][key]
    np.testing.assert_allclose(got["primary"]["loss"], want["primary"]["loss"],
                               rtol=RTOL_LOSS)
    assert got["efficiency"]["param_count"] == want["efficiency"]["param_count"]
    path = tmetrics.save_metrics(got, tmp_path)
    assert json.loads(path.read_text()) == got


def test_profiling_and_debug_utilities(models, tmp_path):
    """`step_cost_analysis` counts as `count_flops`; `StepTimer` times every
    call; `profile_trace` writes a Chrome trace; `configure_debug` turns on
    anomaly detection and deterministic algorithms."""
    from basd_tpu_torch.utils.debug import configure_debug
    from basd_tpu_torch.utils.profiling import StepTimer, profile_trace, step_cost_analysis

    _, _, ts = models
    assert step_cost_analysis(ts, IMG) == {"flops": float(tmetrics.count_flops(ts, IMG))}
    timer = StepTimer()
    x = torch.zeros((2, IMG, IMG, 3))
    timer.time_fn(lambda: ts(x), iters=3, warmup=1)
    summary = timer.summary()
    assert summary["steps"] == 3 and 0 < summary["min_ms"] <= summary["p50_ms"]
    with profile_trace(tmp_path / "trace"):
        ts(x)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    was_anomaly = torch.is_anomaly_enabled()
    was_det = torch.are_deterministic_algorithms_enabled()
    try:
        configure_debug(nan_checks=True, deterministic=True)
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was_anomaly)
        torch.use_deterministic_algorithms(was_det)
