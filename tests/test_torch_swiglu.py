"""DINOv2's ViT-g on the port: the SwiGLU gate's plain version, the
`SwiGLU` MLP in a micro teacher against the plain float32 reference
(`basd_tpu_torch/reference/vit_swiglu.py`), the `dinov2_vitg14` preset's
widths and parameter count, its experiment file, and what the kernel's
wrapper refuses, on the CPU."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from basd_tpu_torch import config as tconfig
from basd_tpu_torch import kernels
from basd_tpu_torch.models import load_teacher
from basd_tpu_torch.models.specs import resolve_preset
from basd_tpu_torch.models.teacher import build_teacher_module
from basd_tpu_torch.models.vit import Block, SwiGLU, ViTConfig
from basd_tpu_torch.ops import activations
from basd_tpu_torch.reference import vit_swiglu
from test_torch_helpers import CPU, assert_close

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

MICRO = "dinov2_swiglu_micro_patch4"
IMG, B = 16, 6


def _gate_want(x: torch.Tensor) -> torch.Tensor:
    """silu(a) * b in float64 from the stored operands, rounded once."""
    g = x.shape[-1] // 2
    a, b = x[..., :g].double(), x[..., g:].double()
    return (a / (1.0 + torch.exp(-a)) * b).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [24, 85, 170])
def test_gate_plain_version_rounds_once(g, dtype):
    """Against float64 math rounded once to the dtype: bf16 equal wherever
    fp32's own error (a few ulps of fp32) cannot cross a bf16 rounding
    boundary, so within one bf16 ulp everywhere; fp32 within 4 ulps (the
    exp, the division and the product each round once). The counter stays
    where it was: the CPU launches nothing."""
    before = dict(kernels.LAUNCHES)
    x = (3.0 * torch.randn((7, 2 * g), generator=torch.Generator().manual_seed(g))).to(dtype)
    got = activations.swiglu_gate(x)
    assert got.dtype == dtype and got.shape == (7, g)
    assert torch.equal(got, activations.swiglu_gate_plain(x))
    want = _gate_want(x)
    ulp = {torch.bfloat16: 2.0**-7, torch.float32: 4 * 2.0**-23}[dtype]
    gap = (got.double() - want.double()).abs()
    assert bool((gap <= ulp * want.double().abs() + 1e-30).all()), float(gap.max())
    if dtype == torch.bfloat16:
        # one rounding from fp32: the fp32 result rounded is the result
        fp32 = F.silu(x[:, :g].float()) * x[:, g:].float()
        assert torch.equal(got, fp32.to(dtype))
    assert kernels.LAUNCHES == before


def test_gate_cost_and_routes():
    """The kernel's route: 16-byte vectors where g is a whole number of
    them and both pointers are aligned."""
    x = torch.zeros((4, 48), dtype=torch.bfloat16)
    assert activations.gate_route(x, torch.zeros((4, 24), dtype=torch.bfloat16)) == "vec"
    assert activations.gate_route(x[:, :40], torch.zeros((4, 20), dtype=torch.bfloat16)) \
        == "scalar"
    f = torch.zeros((4, 16), dtype=torch.float32)
    assert activations.gate_route(f, torch.zeros((4, 8))) == "vec"
    assert activations.gate_route(f[:, :12], torch.zeros((4, 6))) == "scalar"
    offset = torch.zeros(200, dtype=torch.bfloat16)[1:97].view(2, 48)
    assert activations.gate_route(offset, torch.zeros((2, 24), dtype=torch.bfloat16)) \
        == "scalar"


def test_gate_kernel_wrapper_refuses_before_any_library_loads():
    x = torch.zeros((4, 16), dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        activations.swiglu_gate_cuda(x)
    with pytest.raises(ValueError, match="contiguous"):
        activations.swiglu_gate_cuda(torch.zeros((16, 4)).t())
    with pytest.raises(ValueError, match="contiguous"):
        activations.swiglu_gate_cuda(torch.zeros((4, 15)))
    with pytest.raises(ValueError, match="no backward"):
        activations.swiglu_gate_cuda(torch.zeros((4, 16), requires_grad=True))
    assert "swiglu" not in kernels._LOADED


def test_vitg14_preset_widths_and_parameter_count():
    """DINOv2's `dinov2_vitg14` (vit_giant2): width 1536, 40 blocks, 24
    heads of 64, patch 14, LayerScale, SwiGLU with fc1 (8192, 1536) and
    fc2 (1536, 4096): 28,336,640 parameters a block, 1,134,769,664 at
    224 px (16 x 16 patches and CLS, no head)."""
    spec = resolve_preset("dinov2_vitg14")
    assert (spec.embed_dim, spec.depth, spec.num_heads, spec.patch_size) == (1536, 40, 24, 14)
    assert spec.ffn == "swiglu" and spec.layer_scale_init == 1e-5
    assert spec.mlp_ratio == 5.33334 and int(spec.embed_dim * spec.mlp_ratio) == 8192
    assert spec.heads_per_layer() == [24] * 40 and spec.num_tokens(224) == 256
    with torch.device("meta"):
        module = build_teacher_module(spec, 224)
    shapes = {n: tuple(p.shape) for n, p in module.blocks[0].named_parameters()}
    assert shapes["mlp.fc1.weight"] == (8192, 1536) and shapes["mlp.fc1.bias"] == (8192,)
    assert shapes["mlp.fc2.weight"] == (1536, 4096) and shapes["mlp.fc2.bias"] == (1536,)
    assert sum(p.numel() for p in module.blocks[0].parameters()) == 28_336_640
    assert sum(p.numel() for p in module.parameters()) == 1_134_769_664
    assert module.config.ffn == "swiglu" and len(module.capture_layers) == 40


@pytest.mark.parametrize("name", ["vit_small_patch16", "dinov2_vitl14", "dinov2_micro_patch4"])
def test_every_other_vit_preset_keeps_the_gelu_mlp(name):
    spec = resolve_preset(name)
    assert spec.ffn == "gelu" and spec.mlp_ratio == 4.0


def test_experiment_resolves_to_the_swiglu_teacher():
    """`experiment=basd_imagenet_dinov2_vitg14` is the Table-1 experiment
    with the ViT-g teacher: every other key as basd_imagenet_deit_small."""
    cfg = tconfig.compose_config(["experiment=basd_imagenet_dinov2_vitg14"])
    base = tconfig.compose_config(["experiment=basd_imagenet_deit_small"])
    assert cfg.basd.teacher_model_name == "dinov2_vitg14"
    assert cfg.run.name == "basd_imagenet_dinov2_vitg14"
    for section in ("data", "model", "training", "hardware"):
        assert getattr(cfg, section) == getattr(base, section), section
    assert cfg.basd.subspace_k == base.basd.subspace_k
    assert resolve_preset(cfg.basd.teacher_model_name).ffn == "swiglu"


def test_swiglu_block_refuses_tensor_parallelism():
    cfg = ViTConfig(embed_dim=64, depth=1, num_heads=2, patch_size=4, img_size=16,
                    mlp_ratio=5.3125, ffn="swiglu", dtype=torch.float32)
    with pytest.raises(ValueError, match="tensor parallelism"):
        Block(cfg, 0.0, SimpleNamespace(data=1, model=2))
    with pytest.raises(ValueError, match="tensor parallelism"):
        SwiGLU(64, 340, SimpleNamespace(data=2, model=2))
    assert isinstance(Block(cfg, 0.0, SimpleNamespace(data=2, model=1)).mlp, SwiGLU)
    with pytest.raises(ValueError, match="unknown ffn"):
        Block(ViTConfig(ffn="geglu"), 0.0)


def _micro_teacher(dtype):
    """The micro SwiGLU teacher (D 64, 4 blocks, 2 heads, patch 4, packed
    width 340) on seeded weights, LayerScale gammas moved off their 1e-5
    init so that every block changes the tokens."""
    tch = load_teacher(MICRO, IMG, seed=3, dtype=dtype, device=CPU)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for blk in tch.module.blocks:
            blk.ls1.gamma.copy_(0.5 + torch.rand(64, generator=g))
            blk.ls2.gamma.copy_(0.5 + torch.rand(64, generator=g))
    return tch


def _images():
    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def reference():
    tch = _micro_teacher(torch.float32)
    with torch.no_grad():
        return tch.module.state_dict(), vit_swiglu.forward(
            tch.module.state_dict(), _images(), patch_size=4, depth=4, heads=2)


def test_micro_teacher_shapes(reference):
    tch = _micro_teacher(torch.float32)
    blk = tch.module.blocks[0]
    assert isinstance(blk.mlp, SwiGLU)
    assert tuple(blk.mlp.fc1.weight.shape) == (340, 64)
    assert tuple(blk.mlp.fc2.weight.shape) == (64, 170)
    tokens, importance = reference[1]
    assert tuple(tokens.shape) == (4, B, 16, 64) and tuple(importance.shape) == (4, B, 16)


def test_micro_teacher_fp32_matches_reference(reference):
    """Every block's tokens and CLS importance in float32 within 1e-5 of
    their scale: the same math in another order (the port splits qkv and
    computes the importance from q and k apart from the attention)."""
    weights, (want_tok, want_imp) = reference
    tch = _micro_teacher(torch.float32)
    assert all(torch.equal(weights[n], p) for n, p in tch.module.state_dict().items())
    with torch.no_grad():
        out = tch.module(_images())
    for layer in range(4):
        assert_close(out.tokens[layer], want_tok[layer], 1e-5, f"tokens {layer}")
        assert_close(out.importance[layer], want_imp[layer], 1e-5, f"importance {layer}")


def test_micro_teacher_bf16_matches_reference(reference):
    """In bf16 (the main path's dtype): each block's tokens within 4e-2 of
    their scale and the importance within 5e-2 absolute. bf16 keeps 8 bits
    (2^-8 relative); each block rounds the residual stream, every product's
    operands and output and the gate's output, so over four blocks the
    gaps reach a few times 2^-8 of the largest token (1.9e-2 read here).
    The importance is a softmax of q k over the CLS row from bf16 q and k:
    logits of a few units carry errors of a few hundredths, which move a
    weight of 0.45 by as much (2.5e-2 read here)."""
    _, (want_tok, want_imp) = reference
    tch = _micro_teacher(torch.bfloat16)
    with torch.no_grad():
        out = tch.module(_images())
    assert out.tokens.dtype == torch.bfloat16
    for layer in range(4):
        assert_close(out.tokens[layer].float(), want_tok[layer], 4e-2, f"tokens {layer}")
        assert float((out.importance[layer] - want_imp[layer]).abs().max()) <= 5e-2
    # and not within the float32 bound: the bf16 path is a lower precision
    worst = max(float((out.tokens[i].float() - want_tok[i]).abs().max()
                      / want_tok[i].abs().max()) for i in range(4))
    assert worst > 1e-3


def test_reference_is_plain_torch():
    """The reference loads no module of the port beyond its own package
    and nothing of JAX (a fresh interpreter, then its modules)."""
    probe = ("import json, sys; import basd_tpu_torch.reference.vit_swiglu; "
             "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    port = {m for m in mods if m.startswith("basd_tpu_torch")}
    assert port == {"basd_tpu_torch", "basd_tpu_torch.reference",
                    "basd_tpu_torch.reference.vit_swiglu"}, port
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "basd_tpu")]
