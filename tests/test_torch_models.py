"""The port's ViT (`basd_tpu_torch/models/vit.py`) held against the flax
ViT of the JAX package, with the JAX weights carried across by the port's
own `vit_state_dict_from_jax`: eval forward (logits, tokens, importance)
and the train-mode forward and backward, fp32 on the CPU; and the
published students' configs and parameter counts against the JAX
package's `create_student`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.losses import extraction_points as jax_extraction_points
from basd_tpu.models import create_student as jax_create_student
from basd_tpu.models import load_teacher as jax_load_teacher
from basd_tpu.models.convert import torch_vit_to_flax
from basd_tpu_torch.losses import extraction_points
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.models.convert import vit_state_dict_from_jax
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


def _images(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal((b, IMG, IMG, 3)).astype(np.float32)


def _student_pair(points=(0, 3)):
    jmod, cfg = jax_create_student(
        "vit_micro_patch4", num_classes=10, drop_path_rate=0.0, img_size=IMG,
        capture_layers=points, dtype=jnp.float32, remat=False,
    )
    params = jmod.init(jax.random.PRNGKey(3), jnp.zeros((1, IMG, IMG, 3)),
                       train=False)["params"]
    tmod, tcfg = create_student(
        "vit_micro_patch4", num_classes=10, drop_path_rate=0.0, img_size=IMG,
        capture_layers=points, dtype=torch.float32, device=CPU,
    )
    carry_vit(params, tmod)
    return jmod, params, tmod


def _check_outputs(got, want, what):
    # fp32, same math in another summation order: 1e-5 of each output's scale
    assert_close(got.logits, want.logits, 1e-5, f"{what} logits")
    assert_close(got.tokens, want.tokens, 1e-5, f"{what} tokens")
    assert_close(got.importance, want.importance, 1e-5, f"{what} importance")


def test_student_forward_parity():
    jmod, params, tmod = _student_pair()
    x = _images()
    want = jmod.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tmod(t32(x), train=False)
    assert got.tokens.shape == (2, 2, 16, 64) and got.importance.shape == (2, 2, 16)
    _check_outputs(got, want, "student")


def test_dinov2_teacher_forward_parity():
    """LayerScale path, headless (num_classes=0), every layer captured."""
    jt = jax_load_teacher("dinov2_micro_patch4", img_size=IMG, dtype=jnp.float32)
    tt = load_teacher("dinov2_micro_patch4", img_size=IMG, dtype=torch.float32,
                      device=CPU)
    carry_vit(jt.variables["params"], tt.module)
    assert "blocks.0.ls1.gamma" in tt.module.state_dict()
    x = _images(seed=1)
    want = jt.module.apply(jt.variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tt.module(t32(x), train=False)
    assert got.tokens.shape == (4, 2, 16, 64)
    _check_outputs(got, want, "teacher")


def test_train_mode_forward_and_backward_parity():
    """drop_path 0: the train-mode forward and the gradient of a scalar of
    all three outputs to every parameter, against jax.grad (gradients
    carried through the same converter); 1e-4 of each gradient's scale."""
    jmod, params, tmod = _student_pair()
    x = _images(seed=2)
    rng = np.random.default_rng(5)
    out0 = jmod.apply({"params": params}, jnp.asarray(x), train=True)
    r = [rng.standard_normal(np.shape(a)).astype(np.float32) for a in out0]

    def jloss(p):
        o = jmod.apply({"params": p}, jnp.asarray(x), train=True,
                       rngs={"droppath": jax.random.PRNGKey(0)})
        return sum(jnp.sum(a * b) for a, b in zip(o, r)), o

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    got = tmod(t32(x), train=True)
    _check_outputs(got, want, "train")
    sum((a * t32(b)).sum() for a, b in zip(got, r)).backward()
    want_g = grads_as_state_dict(jgrads)
    named = dict(tmod.named_parameters())
    assert set(named) == set(want_g)
    for name, p in named.items():
        assert_close(p.grad, want_g[name], 1e-4, name)


@pytest.mark.parametrize("preset", ["vit_micro_patch4", "dinov2_micro_patch4"])
def test_converter_is_inverse_of_jax_converter(preset):
    """vit_state_dict_from_jax followed by the JAX package's
    torch_vit_to_flax gives back the flax tree exactly."""
    if preset.startswith("dinov2"):
        params = jax_load_teacher(preset, img_size=IMG, dtype=jnp.float32).variables["params"]
        depth = 4
    else:
        _, params, _ = _student_pair()
        depth = 4
    flat = flax_params_np(params)
    sd = {k: v.numpy() for k, v in vit_state_dict_from_jax(flat).items()}
    back = torch_vit_to_flax(sd, depth)
    leaves_a = jax.tree_util.tree_leaves_with_path(back)
    leaves_b = dict(jax.tree_util.tree_leaves_with_path(flat))
    assert len(leaves_a) == len(leaves_b)
    for path, leaf in leaves_a:
        np.testing.assert_array_equal(leaf, leaves_b[path])


# the students the paper's tables train: Table-3's DeiT-Tiny at patch 4 on
# 32 px CIFAR-100, Table-1's ViT-S/16 and Table-2's DeiT-Tiny/16 on
# ImageNet's 1000 classes, the last two at 64 px in place of 224 (the image
# size changes only their patch grid and position embeddings)
STUDENTS = {
    "vit_tiny_patch16_img32": ("vit_tiny_patch16", {"patch_size": 4}, 32, 100),
    "vit_small_patch16_img64": ("vit_small_patch16", None, 64, 1000),
    "vit_tiny_patch16_img64": ("vit_tiny_patch16", None, 64, 1000),
}
CONFIG_FIELDS = ("img_size", "patch_size", "embed_dim", "depth", "num_heads",
                 "mlp_ratio", "num_classes", "drop_path_rate", "has_cls_token",
                 "layer_scale_init", "remat", "num_patches")


@pytest.mark.parametrize("name", sorted(STUDENTS))
def test_create_student_matches_the_jax_package_at_the_published_students(name):
    """The port's `create_student` gives the JAX package's config and
    parameter count (its params by `jax.eval_shape`, nothing run) for the
    same preset, overrides, image size, classes and extraction points."""
    preset, overrides, img, classes = STUDENTS[name]
    kw = dict(num_classes=classes, drop_path_rate=0.05, img_size=img,
              arch_overrides=overrides, remat=False)
    jmod, jcfg = jax_create_student(preset, capture_layers=jax_extraction_points(12, 4),
                                    dtype=jnp.bfloat16, **kw)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), train=False))["params"]
    want = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes))
    tmod, tcfg = create_student(preset, capture_layers=extraction_points(12, 4),
                                dtype=torch.bfloat16, device=CPU, **kw)
    assert {f: getattr(tcfg, f) for f in CONFIG_FIELDS} == \
        {f: getattr(jcfg, f) for f in CONFIG_FIELDS}
    assert sum(p.numel() for p in tmod.parameters()) == want
