"""The port's ViT without a CLS token, remat, `derive_student_arch` and
`estimate_intrinsic_dim`, held against the JAX package where it has the
same function (fp32 on the CPU, weights carried across by the port's own
converter), and remat against the port without it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.models.factory import derive_student_arch as jax_derive_student_arch
from basd_tpu.models.specs import _VIT_PRESETS as _JAX_VIT_PRESETS
from basd_tpu.models.specs import resolve_preset as jax_resolve_preset
from basd_tpu.models.teacher import estimate_intrinsic_dim as jax_estimate_intrinsic_dim
from basd_tpu.models.teacher import load_teacher as jax_load_teacher
from basd_tpu.models.vit import VisionTransformer as JaxViT
from basd_tpu.models.vit import ViTConfig as JaxViTConfig
from basd_tpu_torch import kernels
from basd_tpu_torch.losses import extraction_points, init_selector
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.models.factory import derive_student_arch
from basd_tpu_torch.models.specs import _VIT_PRESETS, resolve_preset
from basd_tpu_torch.models.teacher import estimate_intrinsic_dim
from basd_tpu_torch.models.vit import VisionTransformer, ViTConfig
from basd_tpu_torch.training.train_step import make_train_step
from test_torch_helpers import (
    CPU,
    assert_close,
    carry_vit,
    flax_params_np,
    grads_as_state_dict,
    t32,
)

torch.set_num_threads(1)

IMG = 16
NO_CLS = dict(img_size=IMG, patch_size=4, embed_dim=64, depth=2, num_heads=2,
              num_classes=10, has_cls_token=False)


def _no_cls_pair():
    jmod = JaxViT(JaxViTConfig(**NO_CLS, dtype=jnp.float32), capture_layers=(0, 1))
    params = jmod.init(jax.random.PRNGKey(4), jnp.zeros((1, IMG, IMG, 3)),
                       train=False)["params"]
    tmod = VisionTransformer(ViTConfig(**NO_CLS, dtype=torch.float32),
                             capture_layers=(0, 1))
    carry_vit(params, tmod)
    return jmod, params, tmod


def test_no_cls_vit_forward_and_input_gradient_parity(monkeypatch):
    """A ViT without a CLS token: logits (mean-pooled), all 16 tokens per
    layer and the importance (normalized attention averaged over heads and
    queries, summing to 1 per sample) within 1e-5 of scale; the gradient
    of a scalar of all three outputs with respect to the images within
    1e-4 of scale. The fused attention kernel never runs on this path."""
    from basd_tpu_torch.models import vit

    def forbidden(*a, **k):
        raise AssertionError("the no-CLS path reached the fused attention")

    monkeypatch.setattr(vit, "fused_attention", forbidden)
    jmod, params, tmod = _no_cls_pair()
    assert "cls_token" not in params and "cls_token" not in tmod.state_dict()
    x = np.random.default_rng(0).standard_normal((3, IMG, IMG, 3)).astype(np.float32)
    out0 = jmod.apply({"params": params}, jnp.asarray(x), train=False)
    r = [np.random.default_rng(i).standard_normal(np.shape(a)).astype(np.float32)
         for i, a in enumerate(out0)]

    def jloss(xx):
        o = jmod.apply({"params": params}, xx, train=False)
        return sum(jnp.sum(a * b) for a, b in zip(o, r)), o

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = t32(x).requires_grad_(True)
    got = tmod(xt, train=False)
    assert got.tokens.shape == (2, 3, 16, 64) and got.importance.shape == (2, 3, 16)
    np.testing.assert_allclose(got.importance.detach().sum(-1).numpy(), 1.0, atol=1e-6)
    for name in ("logits", "tokens", "importance"):
        assert_close(getattr(got, name), getattr(want, name), 1e-5, name)
    sum((a * t32(b)).sum() for a, b in zip(got, r)).backward()
    assert_close(xt.grad, jgrad, 1e-4, "input gradient")


def test_no_cls_vit_parameter_gradients_match_jax():
    """The same scalar's gradient to every parameter, train mode at
    drop_path 0, within 1e-4 of each gradient's scale."""
    jmod, params, tmod = _no_cls_pair()
    x = np.random.default_rng(1).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    out0 = jmod.apply({"params": params}, jnp.asarray(x), train=True)
    r = [np.random.default_rng(10 + i).standard_normal(np.shape(a)).astype(np.float32)
         for i, a in enumerate(out0)]

    def jloss(p):
        o = jmod.apply({"params": p}, jnp.asarray(x), train=True)
        return sum(jnp.sum(a * b) for a, b in zip(o, r))

    want = grads_as_state_dict(jax.grad(jloss)(params))
    got = tmod(t32(x), train=True)
    sum((a * t32(b)).sum() for a, b in zip(got, r)).backward()
    named = dict(tmod.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert_close(p.grad, want[name], 1e-4, name)


def _student(remat: bool, drop_path: float = 0.1):
    return create_student(
        "vit_micro_patch4", num_classes=10, drop_path_rate=drop_path, img_size=IMG,
        capture_layers=extraction_points(4, 2), dtype=torch.float32, remat=remat,
        device=CPU, seed=5,
    )[0]


def _attention_calls(model):
    calls = []
    for blk in model.blocks:
        blk.attn.register_forward_hook(lambda *a: calls.append(1))
    return calls


def test_remat_gives_the_same_gradients_and_draws():
    """drop_path 0.1: with remat every block's attention runs twice
    (forward, then its recomputation in the backward) and the outputs, every parameter
    gradient and the generator's state afterwards are bit for bit those
    without remat (the drop-path masks are drawn once, before the
    checkpointed call)."""
    x = t32(np.random.default_rng(2).standard_normal((4, IMG, IMG, 3)))
    results = {}
    for remat in (False, True):
        model = _student(remat)
        calls = _attention_calls(model)
        gen = torch.Generator().manual_seed(11)
        out = model(x, train=True, generator=gen)
        r = [torch.from_numpy(np.random.default_rng(20 + i).standard_normal(
            tuple(a.shape)).astype(np.float32)) for i, a in enumerate(out)]
        sum((a * b).sum() for a, b in zip(out, r)).backward()
        results[remat] = (out, {n: p.grad for n, p in model.named_parameters()},
                          gen.get_state(), len(calls))
    (out0, g0, s0, c0), (out1, g1, s1, c1) = results[False], results[True]
    assert (c0, c1) == (4, 8)
    for a, b in zip(out0, out1):
        assert torch.equal(a, b)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert torch.equal(s0, s1)
    # the masks dropped something: drop_path 0 gives other gradients
    model = _student(False, drop_path=0.0)
    out = model(x, train=True, generator=torch.Generator().manual_seed(11))
    assert not torch.equal(out.logits, out0.logits)


def test_remat_train_step_is_bit_for_bit():
    """One augmented train step (micro teacher and student, drop_path 0.1)
    with and without remat: the same loss bit for bit, the same updated
    parameters and the same generator state after the step."""
    rng = np.random.default_rng(3)
    images = torch.from_numpy((rng.random((8, 20, 20, 3)) * 255).astype(np.uint8))
    labels = torch.from_numpy(rng.integers(0, 10, 8, dtype=np.int64))
    teacher = load_teacher("vit_mini_patch4", img_size=IMG, dtype=torch.float32,
                           device=CPU)
    kw = dict(learning_rate=1e-3, weight_decay=0.05, warmup_steps=5,
              label_smoothing=0.1, img_size=IMG, crop_ratio=IMG / 20,
              teacher_stats=((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
              dataset_stats=((0.507, 0.487, 0.441), (0.267, 0.256, 0.276)),
              num_classes=10)
    runs = {}
    for remat in (False, True):
        student = _student(remat)
        sel = init_selector(1, 2, 64, 96, device=CPU)
        init_fn, step_fn = make_train_step(student, teacher, **kw)
        state = init_fn(0, sel)
        state, met = step_fn(state, images, labels)
        runs[remat] = (met["loss"], [p.detach().clone() for p in student.parameters()],
                       state.generator.get_state())
    assert torch.equal(runs[False][0], runs[True][0])
    for a, b in zip(runs[False][1], runs[True][1]):
        assert torch.equal(a, b)
    assert torch.equal(runs[False][2], runs[True][2])


def test_create_student_remat_defaults_to_the_jax_packages():
    """The JAX package's create_student recomputes blocks by default; so
    does the port's, and remat=False turns it off."""
    assert _student(True).config.remat and not _student(False).config.remat
    model, cfg = create_student("vit_micro_patch4", num_classes=10, drop_path_rate=0.0,
                                img_size=IMG, dtype=torch.float32, device=CPU)
    assert cfg.remat and model.config.remat


@pytest.mark.parametrize("name", sorted(n for n in _VIT_PRESETS if n in _JAX_VIT_PRESETS))
def test_derive_student_arch_matches_jax(name):
    """Every ViT teacher preset, intrinsic dims 1..1100: the same dict."""
    spec, jspec = resolve_preset(name), jax_resolve_preset(name)
    for dim in [*range(1, 130), *range(130, 1100, 7)]:
        assert derive_student_arch(spec, dim) == jax_derive_student_arch(jspec, dim), dim


@pytest.mark.parametrize("name", ["dinov2_micro_patch4", "vit_mini_patch4"])
def test_estimate_intrinsic_dim_matches_jax(name):
    """The MP rank of the last layer's tokens on ceil(10 D / 16) calibration
    images (as the JAX trainer sizes them), weights carried across: the
    same int."""
    jt = jax_load_teacher(name, img_size=IMG, dtype=jnp.float32)
    tt = load_teacher(name, img_size=IMG, dtype=torch.float32, device=CPU)
    carry_vit(flax_params_np(jt.variables["params"]), tt.module)
    n = -(-10 * jt.spec.embed_dim // 16)
    x = np.random.default_rng(7).standard_normal((n, IMG, IMG, 3)).astype(np.float32)
    want = jax_estimate_intrinsic_dim(jt, jnp.asarray(x))
    got = estimate_intrinsic_dim(tt, t32(x))
    assert isinstance(got, int) and got == want
    assert 1 <= got <= jt.spec.embed_dim


def test_launch_counters_untouched_on_the_cpu():
    """The CPU path takes the plain versions: no kernel counter moves."""
    kernels.reset_launches()
    _, _, tmod = _no_cls_pair()
    with torch.no_grad():
        tmod(torch.zeros((2, IMG, IMG, 3)))
    assert all(v == 0 for v in kernels.LAUNCHES.values())
