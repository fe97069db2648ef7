"""DINOv3's ViT-7B/16 on the port, on the CPU: the RoPE rotation's plain
version against the formula, its table's layout, the wrapper's refusals;
the micro DINOv3 teacher (RoPE, 4 register tokens, LayerNorm eps 1e-5,
SwiGLU) against the plain float32 reference
(`basd_tpu_torch/reference/vit_rope.py`), and both against `transformers`'
`DINOv3ViTModel` with the same weights (the published layer code, no
download); each comparison also run with RoPE left out, the registers left
in the tokens and eps 1e-6, which it must catch; the `dinov3_vit7b16`
preset and its experiment file; and the learned-position presets' forward
bit for bit as it stood before positions and registers became options."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from basd_tpu_torch import config as tconfig
from basd_tpu_torch import kernels
from basd_tpu_torch.models import load_teacher
from basd_tpu_torch.models import vit as tvit
from basd_tpu_torch.models.specs import resolve_preset
from basd_tpu_torch.models.teacher import build_teacher_module
from basd_tpu_torch.ops import rope
from basd_tpu_torch.ops.activations import swiglu_gate
from basd_tpu_torch.ops.attention import fused_attention, supports_fused, xla_attention_ref
from basd_tpu_torch.reference import vit_rope
from test_torch_helpers import CPU, assert_close

torch.set_num_threads(1)

MICRO = "dinov3_micro_patch4"
IMG, B, DEPTH, HEADS, D = 16, 5, 4, 2, 64
PREFIX = 5  # CLS and 4 register tokens
# float32, the same math in another order (the port splits the packed qkv,
# rotates q and k in their (B, N, D) layout and computes the importance
# from q and k apart from the attention): 1e-5 of each layer's largest
# value; the clean readings are near 1e-6
FP32_RTOL = 1e-5


# ---- the rotation and its table ----

def _formula(qkv64: torch.Tensor, heads: int, prefix: int, scale: float):
    """q and k of a float64 packed qkv rotated by `transformers`' formula
    (q cos + rotate_half(q) sin over the tiled angles), q scaled, float64."""
    b, n, three_d = qkv64.shape
    d = three_d // 3
    hd = d // heads
    cos, sin = (t.double() for t in vit_rope.rope_cos_sin(int(round((n - prefix) ** 0.5)), hd))
    split = lambda t: t.reshape(b, n, heads, hd).transpose(1, 2)
    out = []
    for t in (split(qkv64[..., :d]), split(qkv64[..., d:2 * d])):
        rot = t[:, :, prefix:] * cos + vit_rope.rotate_half(t[:, :, prefix:]) * sin
        out.append(torch.cat([t[:, :, :prefix], rot], dim=2).transpose(1, 2).reshape(b, n, d))
    return out[0] * scale, out[1]


def test_rope_table_layout():
    """(2, patches, hd / 2): cos and sin of 2 pi coord inv_freq, the patch
    centres of a row-major grid in [-1, 1], y's hd / 4 frequencies then
    x's, inv_freq = 100^-(4 j / hd)."""
    grid, hd = 3, 16
    table = rope.rope_table(grid, grid, hd)
    assert table.dtype == torch.float32 and tuple(table.shape) == (2, grid * grid, hd // 2)
    inv = 100.0 ** -(4 * np.arange(hd // 4) / hd)
    centres = (2 * (np.arange(grid) + 0.5) / grid) - 1
    for p in range(grid * grid):
        y, x = centres[p // grid], centres[p % grid]
        angles = np.concatenate([2 * np.pi * y * inv, 2 * np.pi * x * inv])
        np.testing.assert_allclose(table[0, p].numpy(), np.cos(angles), atol=2e-6)
        np.testing.assert_allclose(table[1, p].numpy(), np.sin(angles), atol=2e-6)
    # the published tiling: one half's angles serve both halves
    cos, sin = vit_rope.rope_cos_sin(grid, hd)
    assert torch.equal(cos, table[0].tile(2)) and torch.equal(sin, table[1].tile(2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [12, 32, 128])
def test_rope_plain_version_against_the_formula(hd, dtype):
    """Against the published formula in float64, rounded once: fp32 within
    4 ulps of each value's head scale (two products, a sum and the scale
    round once each), bf16 within one bf16 ulp of each value, as one
    rounding of an fp32 result that is off by a few fp32 ulps can be. The
    prefix rows: q scaled, k passed bit for bit. The CPU launches nothing."""
    heads, prefix, grid = 2, PREFIX, 3
    n = prefix + grid * grid
    g = torch.Generator().manual_seed(hd)
    qkv = (2.0 * torch.randn((3, n, 3 * heads * hd), generator=g)).to(dtype)
    table = rope.rope_table(grid, grid, hd)
    before = dict(kernels.LAUNCHES)
    q, k = rope.rope_qk(qkv, table, heads, prefix, hd ** -0.5)
    assert kernels.LAUNCHES == before
    assert q.dtype == k.dtype == dtype and q.shape == k.shape == (3, n, heads * hd)
    want_q, want_k = _formula(qkv.double(), heads, prefix, hd ** -0.5)
    for got, want in ((q, want_q), (k, want_k)):
        gap = (got.double() - want).abs()
        if dtype == torch.float32:
            assert float(gap.max()) <= 4 * 2.0**-23 * float(want.abs().max())
        else:
            assert bool((gap <= 2.0**-8 * want.abs() + 1e-30).all()), float(gap.max())
    d = heads * hd
    assert torch.equal(k[:, :prefix], qkv[:, :prefix, d:2 * d])
    assert torch.equal(q[:, :prefix], (qkv[:, :prefix, :d].float() * hd ** -0.5).to(dtype))
    # and the rotation does something on the patch rows
    assert not torch.equal(k[:, prefix:], qkv[:, prefix:, d:2 * d])


def test_rope_route_and_wrapper_refusals():
    """The kernel's route by shape and alignment; the wrapper refuses what
    the kernel does not take before any library loads."""
    bf = torch.zeros((2, 9, 3 * 2 * 16), dtype=torch.bfloat16)
    assert rope.rope_route(bf, 2) == "vec"
    assert rope.rope_route(torch.zeros((2, 9, 3 * 2 * 12)), 2) == "scalar"  # fp32, h2 = 6
    assert rope.rope_route(torch.zeros((2, 9, 3 * 2 * 16)), 2) == "vec"  # fp32, h2 = 8
    table = rope.rope_table(2, 2, 16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        rope.rope_qk_cuda(bf.half(), table, 2, 5, 0.25)
    with pytest.raises(ValueError, match="contiguous packed"):
        rope.rope_qk_cuda(bf.transpose(0, 1), table, 2, 5, 0.25)
    with pytest.raises(ValueError, match="prefix"):
        rope.rope_qk_cuda(bf, table, 2, 9, 0.25)
    with pytest.raises(ValueError, match="table"):
        rope.rope_qk_cuda(bf, table[:, :3], 2, 5, 0.25)
    with pytest.raises(ValueError, match="packed qkv"):
        rope.rope_qk_cuda(bf[..., :-3], table, 2, 5, 0.25)
    with pytest.raises(ValueError, match="no backward"):
        rope.rope_qk_cuda(bf.float().requires_grad_(True), table, 2, 5, 0.25)
    with pytest.raises(ValueError, match="divisible by 4"):
        rope.rope_table(2, 2, 18)


# ---- the preset and its experiment ----

def test_dinov3_vit7b16_preset_widths_and_parameter_count():
    spec = resolve_preset("dinov3_vit7b16")
    assert (spec.embed_dim, spec.depth, spec.num_heads, spec.patch_size) == (4096, 40, 32, 16)
    assert (spec.ffn, spec.positions, spec.num_register_tokens, spec.ln_eps) == (
        "swiglu", "rope", 4, 1e-5)
    assert spec.num_tokens(224) == 196
    with torch.device("meta"):
        module = build_teacher_module(spec, 224)
    sd = module.state_dict()
    assert "pos_embed" not in sd and tuple(sd["register_tokens"].shape) == (1, 4, 4096)
    assert tuple(sd["blocks.0.mlp.fc1.weight"].shape) == (16384, 4096)  # gate | up
    assert tuple(sd["blocks.0.mlp.fc2.weight"].shape) == (4096, 8192)
    assert module.blocks[0].norm1.eps == module.norm.eps == 1e-5
    assert sum(p.numel() for p in module.parameters()) == 6_716_522_496
    # K1 takes the teacher's attention: 201 rows, width 4096, heads of 128
    assert module.config.num_prefix == PREFIX and supports_fused(201, 4096, 128)


def test_experiment_resolves_to_the_dinov3_teacher():
    """`experiment=basd_imagenet_dinov3_vit7b16` is the Table-1 experiment
    with the DINOv3 teacher: every other key as basd_imagenet_deit_small."""
    cfg = tconfig.compose_config(["experiment=basd_imagenet_dinov3_vit7b16"])
    base = tconfig.compose_config(["experiment=basd_imagenet_deit_small"])
    assert cfg.basd.teacher_model_name == "dinov3_vit7b16"
    assert cfg.run.name == "basd_imagenet_dinov3_vit7b16"
    for section in ("data", "model", "training", "hardware"):
        assert getattr(cfg, section) == getattr(base, section), section
    assert cfg.basd.subspace_k == base.basd.subspace_k
    assert resolve_preset(cfg.basd.teacher_model_name).positions == "rope"


def test_rope_needs_known_positions_and_a_cls_token_for_registers():
    with pytest.raises(ValueError, match="unknown positions"):
        tvit.VisionTransformer(tvit.ViTConfig(embed_dim=64, num_heads=2, positions="alibi"))
    with pytest.raises(ValueError, match="CLS"):
        tvit.VisionTransformer(tvit.ViTConfig(embed_dim=64, num_heads=2, has_cls_token=False,
                                              num_register_tokens=4))


# ---- the micro teacher against the reference and against transformers ----

def _micro_teacher(dtype, ln_eps=None):
    """The micro DINOv3 teacher on seeded weights: LayerScale gammas moved
    off their init so every block changes the tokens, the q/k/v bias drawn
    so its layout is held too."""
    tch = load_teacher(MICRO, IMG, seed=3, dtype=dtype, device=CPU)
    if ln_eps is not None:
        spec = dataclasses.replace(tch.spec, ln_eps=ln_eps)
        with torch.device("meta"):
            module = build_teacher_module(spec, IMG, dtype=dtype)
        module.load_state_dict(tch.module.state_dict(), assign=True)
        tch = tch._replace(spec=spec, module=module.eval())
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for blk in tch.module.blocks:
            blk.ls1.gamma.copy_(0.5 + torch.rand(D, generator=g))
            blk.ls2.gamma.copy_(0.5 + torch.rand(D, generator=g))
            blk.attn.qkv.bias.copy_(0.1 * torch.randn(3 * D, generator=g))
    return tch


def _images():
    """Images of small values: the first LayerNorm sees token variances near
    1e-4, where eps 1e-5 and 1e-6 part visibly."""
    rng = np.random.default_rng(11)
    return torch.from_numpy(0.05 * rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32))


FAULTS = ("none", "no_rope", "registers_kept", "eps_1e-6")


def _port(dtype, fault, monkeypatch):
    """The port's weights, tokens and importance of the micro teacher, with
    `fault` planted in the port (tokens and importance None where the
    fault stops the forward: the registers left in the rotated rows)."""
    if fault == "no_rope":
        monkeypatch.setattr(tvit.VisionTransformer, "rope_table",
                            lambda self, device: torch.stack([torch.ones(16, 16),
                                                              torch.zeros(16, 16)]))
    if fault == "registers_kept":
        monkeypatch.setattr(tvit.ViTConfig, "num_prefix",
                            property(lambda self: int(self.has_cls_token)))
    tch = _micro_teacher(dtype, 1e-6 if fault == "eps_1e-6" else None)
    with torch.no_grad():
        try:
            out = tch.module(_images())
        except RuntimeError:
            if fault == "none":
                raise
            return tch.module.state_dict(), None, None
    return tch.module.state_dict(), out.tokens, out.importance


def _gaps(tokens, importance, want_tok, want_imp) -> float:
    """The largest of each layer's token gap over that layer's largest
    reference value and the importance's absolute gap; inf where the shapes
    differ or the forward stopped (the registers left in the tokens)."""
    if tokens is None or tokens.shape != want_tok.shape or importance.shape != want_imp.shape:
        return float("inf")
    tok = max(float((tokens[i].float() - want_tok[i]).abs().max() / want_tok[i].abs().max())
              for i in range(DEPTH))
    return max(tok, float((importance - want_imp).abs().max()))


@pytest.fixture(scope="module")
def reference():
    """The micro teacher's weights and the reference's readings."""
    weights = _micro_teacher(torch.float32).module.state_dict()
    with torch.no_grad():
        return weights, vit_rope.forward(weights, _images(), patch_size=4, depth=DEPTH,
                                         heads=HEADS)


def test_micro_teacher_shapes(reference):
    tch = _micro_teacher(torch.float32)
    assert tch.module.config.num_prefix == PREFIX and tch.num_tokens == 16
    assert "pos_embed" not in reference[0]
    tokens, importance = reference[1]
    assert tuple(tokens.shape) == (DEPTH, B, 16, D) and tuple(importance.shape) == (DEPTH, B, 16)


@pytest.mark.parametrize("fault", FAULTS)
def test_micro_teacher_fp32_against_reference(reference, fault, monkeypatch):
    """Every block's patch tokens and CLS importance in float32 within
    FP32_RTOL of the reference; with a fault planted in the port the gap is
    far above it."""
    weights, (want_tok, want_imp) = reference
    got_w, tokens, importance = _port(torch.float32, fault, monkeypatch)
    assert all(torch.equal(weights[n], p) for n, p in got_w.items())
    gap = _gaps(tokens, importance, want_tok, want_imp)
    if fault == "none":
        assert gap <= FP32_RTOL, gap
    else:
        assert gap > 100 * FP32_RTOL, gap


def test_micro_teacher_bf16_against_reference(reference):
    """In bf16 (the main path's dtype): each block's tokens within 5e-2 of
    their scale and the importance within 5e-2 absolute. bf16 keeps 8 bits
    (2^-8 relative); each block rounds the residual stream, every product's
    operands and output, the rotated q and k and the gate's output, so over
    four blocks the gaps reach several times 2^-8 of the largest token
    (3.4e-2 read here, the small images' LayerNorms amplifying the first
    block's rounding). The importance is a softmax over the CLS row of bf16
    q and k: logits of a few units carry errors of a few hundredths, which
    move a weight as much (3.9e-2 read here)."""
    _, (want_tok, want_imp) = reference
    tch = _micro_teacher(torch.bfloat16)
    with torch.no_grad():
        out = tch.module(_images())
    assert out.tokens.dtype == torch.bfloat16
    for layer in range(DEPTH):
        assert_close(out.tokens[layer].float(), want_tok[layer], 5e-2, f"tokens {layer}")
        assert float((out.importance[layer] - want_imp[layer]).abs().max()) <= 5e-2
    worst = max(float((out.tokens[i].float() - want_tok[i]).abs().max()
                      / want_tok[i].abs().max()) for i in range(DEPTH))
    assert worst > 1e-4  # a lower precision than the float32 bound


@pytest.fixture(scope="module")
def published():
    """`transformers`' DINOv3ViTModel at the micro size (eager attention,
    q/k/v biases on so the drawn ones carry over), the micro teacher's
    weights copied in: its per-layer patch tokens and CLS importance."""
    for var in ("USE_TF", "USE_FLAX", "USE_JAX"):
        os.environ.setdefault(var, "0")
    transformers = pytest.importorskip("transformers")
    weights = _micro_teacher(torch.float32).module.state_dict()
    g = D * 2  # the gate's width: fc1 packs gate | up
    cfg = transformers.DINOv3ViTConfig(
        patch_size=4, hidden_size=D, intermediate_size=g, num_hidden_layers=DEPTH,
        num_attention_heads=HEADS, hidden_act="silu", layer_norm_eps=1e-5, rope_theta=100.0,
        image_size=IMG, query_bias=True, key_bias=True, value_bias=True, proj_bias=True,
        mlp_bias=True, layerscale_value=1.0, use_gated_mlp=True, num_register_tokens=4,
        attn_implementation="eager")
    model = transformers.DINOv3ViTModel(cfg).eval()
    sd = {"embeddings.cls_token": weights["cls_token"],
          "embeddings.mask_token": torch.zeros(1, 1, D),
          "embeddings.register_tokens": weights["register_tokens"],
          "embeddings.patch_embeddings.weight": weights["patch_embed.proj.weight"],
          "embeddings.patch_embeddings.bias": weights["patch_embed.proj.bias"],
          "norm.weight": weights["norm.weight"], "norm.bias": weights["norm.bias"]}
    for i in range(DEPTH):
        p, q = f"blocks.{i}.", f"layer.{i}."
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            sd[q + f"attention.{name}.weight"] = weights[p + "attn.qkv.weight"][j * D:(j + 1) * D]
            sd[q + f"attention.{name}.bias"] = weights[p + "attn.qkv.bias"][j * D:(j + 1) * D]
        sd[q + "attention.o_proj.weight"] = weights[p + "attn.proj.weight"]
        sd[q + "attention.o_proj.bias"] = weights[p + "attn.proj.bias"]
        for a, b in (("norm1", "norm1"), ("norm2", "norm2")):
            sd[q + a + ".weight"], sd[q + a + ".bias"] = (weights[p + b + ".weight"],
                                                          weights[p + b + ".bias"])
        sd[q + "layer_scale1.lambda1"] = weights[p + "ls1.gamma"]
        sd[q + "layer_scale2.lambda1"] = weights[p + "ls2.gamma"]
        fc1w, fc1b = weights[p + "mlp.fc1.weight"], weights[p + "mlp.fc1.bias"]
        sd[q + "mlp.gate_proj.weight"], sd[q + "mlp.gate_proj.bias"] = fc1w[:g], fc1b[:g]
        sd[q + "mlp.up_proj.weight"], sd[q + "mlp.up_proj.bias"] = fc1w[g:], fc1b[g:]
        sd[q + "mlp.down_proj.weight"] = weights[p + "mlp.fc2.weight"]
        sd[q + "mlp.down_proj.bias"] = weights[p + "mlp.fc2.bias"]
    model.load_state_dict(sd, strict=True)
    pixels = _images().permute(0, 3, 1, 2)
    with torch.no_grad():
        out = model(pixels, output_hidden_states=True, output_attentions=True)
    hidden = out.hidden_states[-DEPTH:]  # each layer's output, before the final norm
    tokens = torch.stack([h[:, PREFIX:] for h in hidden])
    importance = torch.stack([a[:, :, 0, PREFIX:].mean(dim=1) for a in out.attentions])
    assert len(out.attentions) == DEPTH
    return tokens, importance


@pytest.mark.parametrize("fault", FAULTS)
def test_micro_teacher_fp32_against_transformers(published, fault, monkeypatch):
    """The port against the published layer code at FP32_RTOL: the RoPE
    layout, the registers' place and their leaving the tokens, eps; a fault
    planted in the port is caught."""
    want_tok, want_imp = published
    _, tokens, importance = _port(torch.float32, fault, monkeypatch)
    gap = _gaps(tokens, importance, want_tok, want_imp)
    if fault == "none":
        assert gap <= FP32_RTOL, gap
    else:
        assert gap > 100 * FP32_RTOL, gap


@pytest.mark.parametrize("fault", ["none", "no_rope", "registers_dropped", "eps_1e-6"])
def test_reference_against_transformers(published, fault):
    """The plain reference against the published layer code at FP32_RTOL;
    faults planted in the reference are caught: RoPE left out, the register
    tokens left out of the sequence, eps 1e-6."""
    want_tok, want_imp = published
    weights = _micro_teacher(torch.float32).module.state_dict()
    kw = dict(patch_size=4, depth=DEPTH, heads=HEADS)
    with torch.no_grad():
        if fault == "no_rope":
            flat = lambda grid, hd: (torch.ones(grid * grid, hd), torch.zeros(grid * grid, hd))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(vit_rope, "rope_cos_sin", flat)
                tokens, importance = vit_rope.forward(weights, _images(), **kw)
        elif fault == "registers_dropped":
            tokens, importance = vit_rope.forward(
                {**weights, "register_tokens": weights["register_tokens"][:, :0]}, _images(),
                **kw)
        else:
            tokens, importance = vit_rope.forward(
                weights, _images(), eps=1e-6 if fault == "eps_1e-6" else vit_rope.LN_EPS, **kw)
    gap = _gaps(tokens, importance, want_tok, want_imp)
    if fault == "none":
        assert gap <= FP32_RTOL, gap
    else:
        assert gap > 100 * FP32_RTOL, gap


def test_reference_is_plain_torch():
    """The reference loads no module of the port beyond its own package
    and nothing of JAX (a fresh interpreter, then its modules)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    probe = ("import json, sys; import basd_tpu_torch.reference.vit_rope; "
             "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    port = {m for m in mods if m.startswith("basd_tpu_torch")}
    assert port == {"basd_tpu_torch", "basd_tpu_torch.reference",
                    "basd_tpu_torch.reference.vit_rope"}, port
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "basd_tpu")]


# ---- the learned-position presets, bit for bit as before ----

def _parent_layer_norm(x, layer):
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias,
                        1e-6).to(x.dtype)


def _parent_linear(x, layer, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _parent_attention(attn, x, dtype):
    """`Attention.forward` of a learned-position ViT as it stood: q scaled
    through fp32, the CLS importance's columns from 1 on."""
    b, n, _ = x.shape
    hd = attn.dim // attn.num_heads
    scale = hd ** -0.5
    d = attn.proj.in_features
    qkv = _parent_linear(x, attn.qkv, dtype)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    q_scaled = (q.float() * scale).to(dtype)
    out = fused_attention(q_scaled, k, v, hd) if supports_fused(n, d, hd) else \
        xla_attention_ref(q_scaled, k, v, hd)
    logits = (k.float() * q[:, :1].float()).reshape(b, n, attn.num_heads, -1).sum(-1)
    importance = torch.softmax(logits.transpose(1, 2) * scale, dim=-1)[:, :, 1:].mean(dim=1)
    return _parent_linear(out, attn.proj, dtype), importance


def _parent_forward(model, x):
    """`VisionTransformer.forward` (eval, CLS token) as it stood: CLS, then
    the position table, blocks, tokens x[:, 1:], the head on CLS."""
    cfg, dt, b = model.config, model.config.dtype, x.shape[0]
    conv = model.patch_embed.proj
    h = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt), conv.bias.to(dt),
                 stride=cfg.patch_size).flatten(2).transpose(1, 2)
    h = torch.cat([model.cls_token.to(dt).expand(b, 1, -1), h], dim=1) + model.pos_embed.to(dt)
    tokens, imps = [], []
    for i, blk in enumerate(model.blocks):
        y, importance = _parent_attention(blk.attn, _parent_layer_norm(h, blk.norm1), dt)
        h = h + blk.ls1(y)
        mlp = blk.mlp
        ln = _parent_layer_norm(h, blk.norm2)
        if isinstance(mlp, tvit.SwiGLU):
            y = _parent_linear(swiglu_gate(_parent_linear(ln, mlp.fc1, dt)), mlp.fc2, dt)
        else:
            y = _parent_linear(F.gelu(_parent_linear(ln, mlp.fc1, dt).float()).to(dt),
                               mlp.fc2, dt)
        h = h + blk.ls2(y)
        if i in model.capture_layers:
            tokens.append(h[:, 1:])
            imps.append(importance)
    h = _parent_layer_norm(h, model.norm)
    logits = F.linear(h[:, 0].float(), model.head.weight, model.head.bias) \
        if cfg.num_classes > 0 else h[:, 0].float()
    return logits, torch.stack(tokens), torch.stack(imps)


LEARNED = ["dinov2_micro_patch4", "dinov2_swiglu_micro_patch4", "vit_micro_patch4"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", LEARNED)
def test_learned_position_presets_bit_for_bit_as_before(name, dtype):
    """Every preset without RoPE or registers: its state-dict keys in their
    order and its logits, tokens and importance equal, bit for bit, to the
    forward before positions, registers and eps became options."""
    spec = resolve_preset(name)
    assert (spec.positions, spec.num_register_tokens, spec.ln_eps) == ("learned", 0, 1e-6)
    cfg = tvit.ViTConfig(img_size=IMG, patch_size=spec.patch_size, embed_dim=spec.embed_dim,
                         depth=spec.depth, num_heads=spec.num_heads, mlp_ratio=spec.mlp_ratio,
                         num_classes=10, layer_scale_init=spec.layer_scale_init, ffn=spec.ffn,
                         dtype=dtype)
    model = tvit.VisionTransformer(cfg, capture_layers=(0, 2, 3)).eval()
    model.init_weights(5)
    keys = list(model.state_dict())
    assert keys[:3] == ["cls_token", "pos_embed", "patch_embed.proj.weight"]
    assert keys[-4:] == ["norm.weight", "norm.bias", "head.weight", "head.bias"]
    with torch.no_grad():
        for blk in model.blocks:
            if spec.layer_scale_init is not None:
                blk.ls1.gamma.fill_(0.8)
                blk.ls2.gamma.fill_(1.1)
        x = torch.from_numpy(np.random.default_rng(2).random((3, IMG, IMG, 3)).astype(np.float32))
        out = model(x)
        logits, tokens, importance = _parent_forward(model, x)
    assert torch.equal(out.logits, logits)
    assert torch.equal(out.tokens, tokens)
    assert torch.equal(out.importance, importance)
