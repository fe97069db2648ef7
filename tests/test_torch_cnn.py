"""The port's CNN teachers (`basd_tpu_torch/models/cnn.py`) held against
the flax CNNs of the JAX package: the same numpy images through both, the
JAX weights carried across by the port's own converters, fp32 on the CPU.
Every parameter and BatchNorm statistic is perturbed away from its
initial value first, so the zero-initialized GRN, the unit BatchNorm
statistics and the ConvNeXt-V1 layer scale all take part."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.models.cnn import ConvNeXt as JaxConvNeXt
from basd_tpu.models.cnn import ConvNeXtConfig as JaxConvNeXtConfig
from basd_tpu.models.cnn import ResNet as JaxResNet
from basd_tpu.models.cnn import ResNetConfig as JaxResNetConfig
from basd_tpu.models.convert import torch_convnext_to_flax, torch_resnet_to_flax
from basd_tpu.models.specs import resolve_preset as jax_resolve_preset
from basd_tpu.models.teacher import build_teacher_module as jax_build_teacher_module
from basd_tpu.models.teacher import load_teacher as jax_load_teacher
from basd_tpu_torch.models import cnn, load_teacher
from basd_tpu_torch.models.convert import (
    convnext_state_dict_from_jax,
    resnet_state_dict_from_jax,
)
from basd_tpu_torch.models.specs import resolve_preset
from basd_tpu_torch.models.teacher import build_teacher_module
from test_torch_helpers import CPU, assert_close, flax_params_np, t32

torch.set_num_threads(1)

MICRO_CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))


def _perturbed(variables, seed: int):
    """Every leaf of a flax variable tree moved off its initial value: the
    BatchNorm variances drawn in [0.5, 2], the rest shifted by 0.2 N(0, 1)
    (kernels keep their random init and get the shift too)."""
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        x = np.asarray(tree, np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        return (x + 0.2 * rng.standard_normal(x.shape)).astype(np.float32)

    return walk(flax_params_np(variables))


def _models(kind: str, num_classes: int = 0, seed: int = 0):
    """(flax module, perturbed variables, port module with them loaded)."""
    if kind == "resnet_micro":
        jcfg = JaxResNetConfig(width=8, num_classes=num_classes, dtype=jnp.float32)
        jmod = JaxResNet(jcfg)
        tmod = cnn.ResNet(cnn.ResNetConfig(width=8, num_classes=num_classes,
                                           dtype=torch.float32))
        convert = resnet_state_dict_from_jax
    else:
        grn = kind == "convnextv2_micro"
        jmod = JaxConvNeXt(JaxConvNeXtConfig(**MICRO_CONVNEXT, use_grn=grn,
                                             num_classes=num_classes, dtype=jnp.float32))
        tmod = cnn.ConvNeXt(cnn.ConvNeXtConfig(**MICRO_CONVNEXT, use_grn=grn,
                                               num_classes=num_classes,
                                               dtype=torch.float32))
        convert = convnext_state_dict_from_jax
    variables = jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))
    variables = _perturbed(variables, seed + 1)
    tmod.load_state_dict(convert(variables), strict=True)
    return jmod, variables, tmod


@pytest.mark.parametrize("kind,img,num_classes", [
    # 64 px: every stride-2 SAME pad is asymmetric, the 7x7/2 stem's (2, 3),
    # the max-pool's and the stages' first 3x3/2 convs' (0, 1); at 65 px
    # each is symmetric
    ("resnet_micro", 64, 0),
    ("resnet_micro", 65, 0),
    ("resnet_micro", 64, 10),
    ("convnextv2_micro", 64, 0),
    # 65 px: the 4x4/4 stem pads (1, 2), the 2x2/2 downsamples (0, 1)
    ("convnextv2_micro", 65, 0),
    ("convnext_v1_micro", 64, 0),
    ("convnext_v1_micro", 64, 10),
])
def test_cnn_forward_parity(kind, img, num_classes):
    """Tokens (1, B, N, D), uniform importance and logits (or pooled
    features) within 1e-5 of each output's scale: the same fp32 math in
    other summation orders."""
    jmod, variables, tmod = _models(kind, num_classes)
    x = np.random.default_rng(img).standard_normal((2, img, img, 3)).astype(np.float32)
    want = jmod.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tmod(t32(x))
    side = -(-img // 32)
    assert got.tokens.shape == (1, 2, side * side, 64)
    assert got.tokens.dtype == torch.float32 and got.importance.dtype == torch.float32
    assert_close(got.tokens, want.tokens, 1e-5, f"{kind} tokens")
    assert_close(got.importance, want.importance, 1e-6, f"{kind} importance")
    assert_close(got.logits, want.logits, 1e-5, f"{kind} logits")


@pytest.mark.parametrize("kind", ["resnet_micro", "convnextv2_micro", "convnext_v1_micro"])
def test_converter_is_inverse_of_jax_converter(kind):
    """The port's converter followed by the JAX package's torch_*_to_flax
    gives back the flax variables exactly (heads are not read by the JAX
    ConvNeXt converter, so these trees have none)."""
    jmod, variables, tmod = _models(kind)
    sd = {k: v.numpy() for k, v in tmod.state_dict().items()}
    if kind == "resnet_micro":
        back = torch_resnet_to_flax(sd, (2, 2, 2, 2))
    else:
        back = torch_convnext_to_flax(sd, MICRO_CONVNEXT["depths"])
    leaves_a = jax.tree_util.tree_leaves_with_path(back)
    leaves_b = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(leaves_a) == len(leaves_b) > 0
    for path, leaf in leaves_a:
        np.testing.assert_array_equal(leaf, leaves_b[path])


def _jax_shapes(spec_name: str, img: int):
    """Token-stack shape and the parameter (+ batch statistics) count of the
    JAX package's teacher, by abstract evaluation (nothing computed)."""
    module = jax_build_teacher_module(jax_resolve_preset(spec_name), img, dtype=jnp.float32)
    out, variables = jax.eval_shape(
        lambda: module.init_with_output(jax.random.PRNGKey(0),
                                        jnp.zeros((1, img, img, 3)), train=False))
    count = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(variables))
    return out.tokens.shape, count


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "convnext_tiny",
                                  "convnextv2_tiny", "convnextv2_tiny.fcmae"])
def test_full_size_cnn_presets_match_the_jax_architecture(name):
    """At 224 px each full-size CNN preset gives the JAX package's token
    stack (1, 1, 49, D) and has as many parameters and BatchNorm statistics;
    the port's module runs on the meta device (shapes only)."""
    want_shape, want_count = _jax_shapes(name, 224)
    with torch.device("meta"):
        module = build_teacher_module(resolve_preset(name), 224, dtype=torch.float32)
        out = module(torch.zeros((1, 224, 224, 3)))
    assert tuple(out.tokens.shape) == tuple(want_shape) == (1, 1, 49, resolve_preset(name).embed_dim)
    count = sum(t.numel() for t in [*module.parameters(), *module.buffers()])
    assert count == want_count


@pytest.mark.parametrize("name", ["resnet_micro", "convnextv2_micro"])
def test_load_teacher_num_tokens(name, capsys):
    """load_teacher on the CPU: the JAX package's num_tokens at 224 px
    (from one forward), uniform importance, frozen weights, and the JAX
    package's load line fields."""
    want = jax_load_teacher(name, img_size=224, dtype=jnp.float32)
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    t = load_teacher(name, img_size=224, dtype=torch.float32, device=CPU)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert t.num_tokens == want.num_tokens == 49
    assert line.startswith(jax_line + " device=")
    assert not any(p.requires_grad for p in t.module.parameters())
    with torch.no_grad():
        out = t.module(torch.zeros((2, 64, 64, 3)))
    assert out.tokens.shape[:3] == (1, 2, 4)
    np.testing.assert_array_equal(out.importance.numpy(), np.full((1, 2, 4), 0.25, np.float32))


def test_cnn_entry_point_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_teacher("convnextv2_micro", img_size=64)
