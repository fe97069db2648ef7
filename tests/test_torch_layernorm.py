"""The LayerNorm of the port (`ops/layernorm.py`, `models/vit.py:_layer_norm`)
on the CPU: the plain version against flax's nn.LayerNorm and against the
composite it replaces; the route (a call that autograd does not need takes
`ops.layernorm.layer_norm`, the kernel's route on the card, and a call it
needs the composite, whose gradients are unchanged); the kernel wrapper's
refusals, its launch against a recording stand-in library and its routes."""

import ctypes
from types import SimpleNamespace

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from basd_tpu_torch import kernels
from basd_tpu_torch.losses import extraction_points
from basd_tpu_torch.models import cnn, create_student, load_teacher, vit
from basd_tpu_torch.models.teacher import extract_intermediates
from basd_tpu_torch.ops import layernorm
from test_torch_helpers import CPU

torch.set_num_threads(1)

DTYPES = [torch.bfloat16, torch.float32]


def _operands(rows, d, dtype=torch.float32, seed=0):
    """Rows of mean 0.5 and scale 2, a weight near 1 and a small bias."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((rows, d)) + 0.5).astype(np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(w), torch.from_numpy(b)


def _composite(x, w, b, eps):
    """The port's LayerNorm before the kernel (`vit._layer_norm`'s body)."""
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("d", [96, 192, 768, 4096])
def test_plain_against_flax_layernorm(d, eps):
    """fp32, the JAX package's nn.LayerNorm (`basd_tpu/models/vit.py`'s
    norm1, norm2 and norm) with the same scale and bias. flax takes the
    variance as E[x^2] - E[x]^2 and torch by Welford: the two round apart by
    a few fp32 ulps of the outputs' scale (|y| reaches about 5 here), so
    each value is held within 4e-6 absolute and relative."""
    x, w, b = _operands(8, d, seed=d)
    got = layernorm.layer_norm_plain(x, w, b, eps)
    ln = fnn.LayerNorm(epsilon=eps, dtype=jnp.float32)
    want = ln.apply({"params": {"scale": jnp.asarray(w.numpy()), "bias": jnp.asarray(b.numpy())}},
                    jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=4e-6, atol=4e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_is_the_composite_bit_for_bit(dtype):
    """`layer_norm_plain`, `layer_norm` on the CPU and `_layer_norm` without
    a gradient all give the composite's bits, and launch nothing."""
    before = dict(kernels.LAUNCHES)
    x, w, b = _operands(6, 96, dtype, seed=1)
    want = _composite(x, w, b, 1e-6)
    assert want.dtype == dtype
    assert torch.equal(layernorm.layer_norm_plain(x, w, b, 1e-6), want)
    assert torch.equal(layernorm.layer_norm(x, w, b, 1e-6), want)
    norm = torch.nn.LayerNorm(96, eps=1e-6)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
        assert torch.equal(vit._layer_norm(x, norm), want)
    assert kernels.LAUNCHES == before


@pytest.fixture
def recorded(monkeypatch):
    """`vit.layer_norm` (the grad-free route, which ConvNeXt's calls share)
    replaced by a recorder of its calls that returns the plain version."""
    calls = []

    def record(x, weight, bias, eps):
        calls.append((tuple(x.shape), eps))
        return layernorm.layer_norm_plain(x, weight, bias, eps)

    monkeypatch.setattr(vit, "layer_norm", record)
    return calls


@pytest.mark.parametrize("dtype", DTYPES)
def test_route_by_what_autograd_needs(dtype, recorded):
    """A call under no_grad and a call on operands that require no gradient
    take the grad-free route; a call that autograd needs (x or the weight
    requires a gradient) takes the composite and back-propagates as it
    did: the same output and gradients as the composite, bit for bit."""
    x, w, b = _operands(5, 64, dtype, seed=2)
    norm = torch.nn.LayerNorm(64, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    want = _composite(x, w, b, 1e-5)
    xg = x.clone().requires_grad_(True)
    with torch.no_grad():
        assert torch.equal(vit._layer_norm(xg, norm), want)
    assert len(recorded) == 1
    frozen = torch.nn.LayerNorm(64, eps=1e-5).requires_grad_(False)
    with torch.no_grad():
        frozen.weight.copy_(w)
        frozen.bias.copy_(b)
    assert torch.equal(vit._layer_norm(x, frozen), want)
    assert len(recorded) == 2
    dy = _operands(5, 64, dtype, seed=3)[0]
    for inp, layer in ((xg, norm), (xg, frozen), (x, norm)):
        for p in norm.parameters():
            p.grad = None
        y = vit._layer_norm(inp, layer)
        assert torch.equal(y, want) and y.requires_grad
        y.backward(dy)
        ref_x = inp.detach().clone().requires_grad_(inp.requires_grad)
        ref_w = layer.weight.detach().clone().requires_grad_(layer.weight.requires_grad)
        ref_b = layer.bias.detach().clone().requires_grad_(layer.bias.requires_grad)
        _composite(ref_x, ref_w, ref_b, 1e-5).backward(dy)
        if inp.requires_grad:
            assert torch.equal(inp.grad, ref_x.grad)
            inp.grad = None
        if layer.weight.requires_grad:
            assert torch.equal(layer.weight.grad, ref_w.grad)
            assert torch.equal(layer.bias.grad, ref_b.grad)
    assert len(recorded) == 2


@pytest.mark.parametrize("remat", [False, True])
def test_student_training_takes_no_grad_free_call(remat, recorded):
    """The micro student's training forward and backward, with and without
    remat (whose recomputation runs under autograd): every LayerNorm takes
    the composite, so the kernel's counter would read 0; its eval forward
    takes the grad-free route 2 depth + 1 times."""
    model, cfg = create_student("vit_micro_patch4", num_classes=10, drop_path_rate=0.1,
                                img_size=16, capture_layers=extraction_points(4, 2),
                                dtype=torch.bfloat16, remat=remat, device=CPU, seed=5)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 16, 16, 3))
                         .astype(np.float32))
    out = model(x, train=True, generator=torch.Generator().manual_seed(1))
    sum(a.float().sum() for a in out).backward()
    assert recorded == []
    with torch.no_grad():
        model(x)
    assert len(recorded) == 2 * cfg.depth + 1


@pytest.mark.parametrize("name", ["dinov2_micro_patch4", "dinov3_micro_patch4",
                                  "convnextv2_micro"])
def test_frozen_teacher_takes_the_grad_free_route(name, recorded):
    """A teacher's forward (`extract_intermediates`, under no_grad): every
    LayerNorm module once on the grad-free route, with the model's eps; a
    ViT's are its blocks' norm1 and norm2 and the final norm, 2 depth + 1
    over the whole residual stream; a ConvNeXt's the stem's, each
    downsample's and each block's."""
    tch = load_teacher(name, img_size=32, dtype=torch.bfloat16, device=CPU)
    norms = sum(isinstance(m, torch.nn.LayerNorm) for m in tch.module.modules())
    x = torch.from_numpy(np.random.default_rng(6).random((2, 32, 32, 3)).astype(np.float32))
    recorded.clear()  # a CNN's load runs one forward to count its tokens
    extract_intermediates(tch, x)
    assert len(recorded) == norms
    if isinstance(tch.module, vit.VisionTransformer):
        cfg = tch.module.config
        rows = (2, cfg.num_patches + cfg.num_prefix, cfg.embed_dim)
        assert norms == 2 * cfg.depth + 1
        assert recorded == [(rows, cfg.ln_eps)] * norms
    else:
        stages = tch.module.config.depths
        assert isinstance(tch.module, cnn.ConvNeXt) and norms == 1 + 3 + sum(stages)


def test_kernel_wrapper_refuses_before_any_library_loads(monkeypatch):
    monkeypatch.setattr(kernels, "library", lambda name: pytest.fail("loaded"))
    x, w, b = _operands(4, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        layernorm.layer_norm_cuda(x.half(), w, b, 1e-6)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        layernorm.layer_norm_cuda(x.double(), w, b, 1e-6)
    with pytest.raises(ValueError, match="fp32 weight"):
        layernorm.layer_norm_cuda(x, w.bfloat16(), b, 1e-6)
    with pytest.raises(ValueError, match="fp32 bias"):
        layernorm.layer_norm_cuda(x, w, b[:8], 1e-6)
    with pytest.raises(ValueError, match=r"of shape \(8,\)"):
        layernorm.layer_norm_cuda(x[:, :8], w, b, 1e-6)
    with pytest.raises(ValueError, match="one CUDA device"):
        layernorm.layer_norm_cuda(x, w, b, 1e-6)
    with pytest.raises(ValueError, match="one CUDA device"):
        layernorm.layer_norm_cuda(x.to("meta"), w, b, 1e-6)
    assert "layernorm" not in kernels._LOADED


class _StandIn:
    """The library's entry point over CPU memory: it records its arguments
    and writes the plain version's values through y's pointer, so the
    launch's plumbing runs end to end."""

    def __init__(self, x, w, b):
        self.by_ptr = {t.data_ptr(): t for t in (x, w, b)}
        self.calls = []

    def basd_layernorm_fwd(self, x, w, b, y, rows, d, eps, is_bf16, stream):
        self.calls.append((x, w, b, y, rows, d, eps, is_bf16, stream))
        src = self.by_ptr[x]
        out = layernorm.layer_norm_plain(src, self.by_ptr[w], self.by_ptr[b], eps)
        ctypes.memmove(y, out.data_ptr(), out.numel() * out.element_size())
        return 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_launch_once_and_count(dtype, monkeypatch):
    x, w, b = _operands(12, 40, dtype, seed=7)
    x = x.reshape(3, 4, 40)
    lib = _StandIn(x, w, b)
    monkeypatch.setattr(kernels, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(
        cuda_stream=7))
    monkeypatch.setitem(kernels.LAUNCHES, "layernorm", 0)
    y = layernorm._launch(x, w, b, 1e-5)
    assert y.shape == x.shape and y.dtype == dtype
    assert torch.equal(y, _composite(x, w, b, 1e-5))
    assert lib.calls == [(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), 12, 40, 1e-5,
                          int(dtype == torch.bfloat16), 7)]
    assert kernels.LAUNCHES["layernorm"] == 1
    # an empty x launches nothing
    assert layernorm._launch(x[:0], w, b, 1e-5).shape == (0, 4, 40)
    assert len(lib.calls) == 1 and kernels.LAUNCHES["layernorm"] == 1


def test_launch_makes_a_strided_input_contiguous(monkeypatch):
    """A transposed view reaches the kernel as contiguous rows of its last
    axis."""
    x, w, b = _operands(40, 24, seed=8)
    view = x.reshape(24, 40).t()  # (40, 24), not contiguous
    seen = []

    class Lib:
        def basd_layernorm_fwd(self, xp, wp, bp, yp, rows, d, eps, is_bf16, stream):
            seen.append((rows, d))
            return 0

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(
        cuda_stream=0))
    monkeypatch.setitem(kernels.LAUNCHES, "layernorm", 0)
    assert layernorm._launch(view, w, b, 1e-6).is_contiguous()
    assert seen == [(40, 24)]


def test_route_is_the_library_s(monkeypatch):
    """`layernorm_route` names the route the library reports for these
    operands (its codes 0, 1, 2), passing the pointers, D and the dtype."""
    x, w, b = _operands(4, 40, torch.bfloat16, seed=9)
    y = torch.empty_like(x)
    seen = []

    class Lib:
        def basd_layernorm_route(self, xp, wp, bp, yp, d, is_bf16):
            seen.append((xp, wp, bp, yp, d, is_bf16))
            return len(seen) - 1

    monkeypatch.setattr(kernels, "library", lambda name: Lib())
    got = [layernorm.layernorm_route(x, y, w, b) for _ in range(3)]
    assert got == ["warp", "cta", "scalar"]
    assert seen == [(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), 40, 1)] * 3
