"""Vision Transformer (DeiT / DINOv2 family) that returns its
intermediates: the port of `basd_tpu/models/vit.py`.

The forward returns (logits, per-layer patch tokens, per-layer CLS
attention importance) so no hooks are needed. Parameters are fp32 with
timm/DINOv2 state-dict keys; every layer casts its inputs and weights to
`ViTConfig.dtype` (bf16 on the main path) as flax's `dtype=` does, while
LayerNorm statistics, GELU, the softmax and the CLS importance run in fp32
and the classifier head in fp32. A LayerNorm that autograd does not need
(the frozen teacher's, an eval forward's) is the one-pass kernel of
`ops.layernorm.layer_norm` on the card. Images are (B, H, W, 3), as in the JAX
package. Attention of a ViT with a CLS token inside the kernel gate goes
through `ops.attention.fused_attention` (the hand-written kernels on the
card); a ViT without one takes the einsum chain, whose normalized attention
its importance needs. A block's MLP is `ViTConfig.ffn`'s: the GELU `Mlp`
(its erf GELU the kernels of `ops.activations.gelu` on the card, forward and
backward), or `SwiGLU` (DINOv2's ViT-g; its gate `silu(a) * b` is the hand-written
kernel of `ops.activations.swiglu_gate` on the card). Positions are
`ViTConfig.positions`: a learned table added to CLS and patches, or
DINOv3's axial RoPE (`ops.rope.rope_qk`, the hand-written kernel on the
card), which rotates the patch rows' q and k in each block and has no
table. `ViTConfig.num_register_tokens` register tokens follow the CLS token;
the prefix (CLS and registers) is left out of the captured tokens and of
the CLS importance's columns. `ViTConfig.remat`
recomputes each block in the backward (`torch.utils.checkpoint`), with the
block's drop-path draws made before the checkpointed call so the
recomputation sees the same masks.

Tensor parallelism (a `parallel.mesh.Mesh` with a model axis, built by
`parallel.sharding_rules.shard_module`): each block's qkv and fc1 are
column-parallel and its proj and fc2 row-parallel (Megatron), the row
products summed over the model group in fp32 before the bias; K1/K2 run
on the rank's H/tp heads in its (B, N, D/tp) layout, and the CLS
importance sums the heads over the model group. Where tp does not divide
the heads (DeiT-Tiny's 3 at tp = 2) the attention stays whole on every
rank and only the MLP splits: the same function, with K1/K2 on all heads
(the JAX package drops to its XLA chain there, `basd_tpu/ops/attention.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from basd_tpu_torch.ops.activations import gelu, swiglu_gate
from basd_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain
from basd_tpu_torch.ops.rope import rope_qk, rope_table
from basd_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model
from basd_tpu_torch.parallel.sharding_rules import attention_split
from basd_tpu_torch.ops.attention import (
    attention_mean_importance,
    fused_attention,
    supports_fused,
    xla_attention_ref,
)

# flax's truncated_normal samples a standard normal cut at +-2 and rescales
# it to the requested stddev; torch's trunc_normal_ cuts N(0, std) instead
_TRUNC_STD = 0.87962566103423978
_LN_EPS = 1e-6  # flax LayerNorm default
_POSITIONS = ("learned", "rope")


@dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 192
    depth: int = 12
    num_heads: int = 3
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    drop_path_rate: float = 0.0
    has_cls_token: bool = True
    # DINOv2 LayerScale gamma init (1e-5); None = plain ViT
    layer_scale_init: float | None = None
    # the blocks' MLP: "gelu" (`Mlp`) or "swiglu" (`SwiGLU`)
    ffn: str = "gelu"
    # "learned" (pos_embed) or "rope" (DINOv3's axial RoPE, no table)
    positions: str = "learned"
    # register tokens after the CLS token (DINOv3: 4)
    num_register_tokens: int = 0
    # every LayerNorm's eps (DINOv2 1e-6, DINOv3 1e-5)
    ln_eps: float = _LN_EPS
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def num_prefix(self) -> int:
        """The rows before the patches: CLS and the register tokens."""
        return int(self.has_cls_token) + self.num_register_tokens


class ViTOutput(NamedTuple):
    logits: torch.Tensor  # (B, num_classes) fp32
    tokens: torch.Tensor  # (P, B, N, D) post-block tokens, CLS stripped
    importance: torch.Tensor  # (P, B, N) fp32 attention importance


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _row_linear(x: torch.Tensor, layer: nn.Linear, dtype, mesh) -> torch.Tensor:
    """A row-parallel linear: this rank's partial product, summed over the
    model group in fp32, plus the whole bias."""
    part = F.linear(x.to(dtype), layer.weight.to(dtype))
    return (reduce_from_model(part, mesh) + layer.bias.float()).to(dtype)


def _layer_norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    """A call that autograd needs (the student's forward, its remat
    recomputation) takes the fp32 composite under autograd; any other (a
    frozen teacher under no_grad, an eval forward) `ops.layernorm.layer_norm`,
    the one-pass kernel on the card."""
    if torch.is_grad_enabled() and (
        x.requires_grad or layer.weight.requires_grad or layer.bias.requires_grad
    ):
        return layer_norm_plain(x, layer.weight, layer.bias, layer.eps)
    return layer_norm(x, layer.weight, layer.bias, layer.eps)


def _trunc_normal_(w: torch.Tensor, std: float, g: torch.Generator) -> None:
    s = std / _TRUNC_STD
    nn.init.trunc_normal_(w, std=s, a=-2.0 * s, b=2.0 * s, generator=g)


class DropPath(nn.Module):
    """Per-sample stochastic depth on the residual branch: `draw` makes the
    per-sample uniform draw (None where every sample is kept) and `forward`
    applies it."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def draw(self, x, train: bool, generator: torch.Generator | None, rows=None):
        """`rows` = (lo, total): x holds rows lo.. of a global batch of
        `total`, whose draws are made whole and sliced."""
        if not train or self.rate == 0.0:
            return None
        if rows is None:
            return torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), device=x.device,
                              generator=generator)
        lo, total = rows
        u = torch.rand((total,) + (1,) * (x.ndim - 1), device=x.device,
                       generator=generator)
        return u[lo:lo + x.shape[0]]

    def forward(self, x, u: torch.Tensor | None):
        if u is None:
            return x
        keep = 1.0 - self.rate
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class Attention(nn.Module):
    """Multi-head self-attention returning (tokens, CLS importance)."""

    def __init__(self, dim: int, num_heads: int, has_cls_token: bool, mesh=None,
                 num_prefix: int | None = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.has_cls_token = has_cls_token
        # CLS and register rows: left out of the importance's columns and
        # of the rotation
        self.num_prefix = int(has_cls_token) if num_prefix is None else num_prefix
        # split by whole heads over the model group, or whole on every rank
        self.mesh = mesh if mesh is not None and attention_split(
            num_heads, mesh.model) else None
        if self.mesh is not None and not has_cls_token:
            raise ValueError("a tensor-parallel attention needs a CLS token")
        tp = 1 if self.mesh is None else mesh.model
        self.qkv = nn.Linear(dim, 3 * dim // tp)
        self.proj = nn.Linear(dim // tp, dim)

    def _cls_importance(self, q, k, scale):
        """CLS-row attention over patch keys, mean over heads, in fp32 from
        the unscaled (B, N, D) q and k (k rotated where the model has RoPE;
        the CLS row's q never is)."""
        b, n, d = k.shape
        heads = self.num_heads if self.mesh is None else self.num_heads // self.mesh.model
        prod = k.float() * q[:, :1].float()  # (B, N, D)
        cls_logits = prod.reshape(b, n, heads, -1).sum(-1)
        cls_logits = cls_logits.transpose(1, 2) * scale  # (B, H, N)
        if self.mesh is None:
            return torch.softmax(cls_logits, dim=-1)[:, :, self.num_prefix:].mean(dim=1)
        part = torch.softmax(cls_logits, dim=-1)[:, :, self.num_prefix:].sum(dim=1)
        return reduce_from_model(part, self.mesh) / self.num_heads

    def forward(self, x, dtype, rope: torch.Tensor | None = None):
        """`rope`: the (2, patches, hd / 2) cos and sin table of a model
        with RoPE (`ops.rope.rope_table`), else None."""
        b, n, _ = x.shape
        hd = self.dim // self.num_heads
        scale = hd**-0.5
        if self.mesh is not None:
            x = copy_to_model(x, self.mesh)
        d = self.proj.in_features  # D, or D/tp under tensor parallelism
        qkv = _linear(x, self.qkv, dtype)  # (B, N, 3D)
        q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
        if rope is None:
            q_scaled = (q.float() * scale).to(dtype)
        else:
            q_scaled, k = rope_qk(qkv, rope, d // hd, self.num_prefix, scale)
        if not self.has_cls_token:
            # the importance averages the normalized attention over heads
            # and queries, which the kernel never forms: never K1 here
            out, importance = attention_mean_importance(q_scaled, k, v, hd)
            return self._proj(out, dtype), importance
        if supports_fused(n, d, hd):
            out = fused_attention(q_scaled, k, v, hd)
        else:
            out = xla_attention_ref(q_scaled, k, v, hd)
        return self._proj(out, dtype), self._cls_importance(q, k, scale)

    def _proj(self, out, dtype):
        if self.mesh is None:
            return _linear(out, self.proj, dtype)
        return _row_linear(out, self.proj, dtype, self.mesh)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, mesh=None):
        super().__init__()
        self.mesh = mesh if mesh is not None and mesh.model > 1 else None
        tp = 1 if self.mesh is None else mesh.model
        if hidden % tp:
            raise ValueError(f"MLP width {hidden} not divisible by model={tp}")
        self.fc1 = nn.Linear(dim, hidden // tp)
        self.fc2 = nn.Linear(hidden // tp, dim)

    def forward(self, x, dtype):
        if self.mesh is None:
            return _linear(gelu(_linear(x, self.fc1, dtype)), self.fc2, dtype)
        h = gelu(_linear(copy_to_model(x, self.mesh), self.fc1, dtype))
        return _row_linear(h, self.fc2, dtype, self.mesh)


class SwiGLU(nn.Module):
    """The SwiGLU MLP of DINOv2's ViT-g under timm's `SwiGLUPacked` keys:
    fc1 (2g, D) packs both halves, fc2 (D, g); fc2(silu(a) * b) of fc1's
    output a | b, g = packed_hidden // 2 (`ops.activations.swiglu_gate`,
    the kernel on the card). Not split under tensor parallelism."""

    def __init__(self, dim: int, packed_hidden: int, mesh=None):
        super().__init__()
        if mesh is not None and mesh.model > 1:
            raise ValueError(f"a SwiGLU MLP does not split over model={mesh.model}: "
                             "tensor parallelism takes GELU MLPs only")
        g = packed_hidden // 2
        self.fc1 = nn.Linear(dim, 2 * g)
        self.fc2 = nn.Linear(g, dim)

    def forward(self, x, dtype):
        return _linear(swiglu_gate(_linear(x, self.fc1, dtype)), self.fc2, dtype)


_FFN = {"gelu": Mlp, "swiglu": SwiGLU}


class LayerScale(nn.Module):
    """DINOv2 naming: module `ls1`/`ls2`, parameter `gamma`."""

    def __init__(self, dim: int, init: float):
        super().__init__()
        self.init = init
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, drop_path: float, mesh=None):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.attn = Attention(d, cfg.num_heads, cfg.has_cls_token, mesh, cfg.num_prefix)
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps)
        if cfg.ffn not in _FFN:
            raise ValueError(f"unknown ffn {cfg.ffn!r}; known: {sorted(_FFN)}")
        self.mlp = _FFN[cfg.ffn](d, int(d * cfg.mlp_ratio), mesh)
        if cfg.layer_scale_init is not None:
            self.ls1 = LayerScale(d, cfg.layer_scale_init)
            self.ls2 = LayerScale(d, cfg.layer_scale_init)
        else:
            self.ls1 = self.ls2 = nn.Identity()
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def draw(self, x, train, generator, rows=None):
        """The block's two drop-path draws, in the order the paths apply."""
        return (self.drop_path1.draw(x, train, generator, rows),
                self.drop_path2.draw(x, train, generator, rows))

    def forward(self, x, dtype, u1, u2, rope=None):
        y, importance = self.attn(_layer_norm(x, self.norm1), dtype, rope)
        x = x + self.drop_path1(self.ls1(y), u1)
        y = self.mlp(_layer_norm(x, self.norm2), dtype)
        x = x + self.drop_path2(self.ls2(y), u2)
        return x, importance


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)


class VisionTransformer(nn.Module):
    """DeiT-style ViT. `capture_layers` selects the blocks whose post-block
    tokens (CLS stripped) and importance vectors are returned. Call
    `init_weights(seed)` (the entry points do) for the JAX package's
    initialization. With a `mesh` that has a model axis the blocks hold
    this rank's tensor-parallel shards (`sharding_rules.shard_module` builds
    one from a full student)."""

    def __init__(self, config: ViTConfig, capture_layers: tuple[int, ...] = (),
                 mesh=None):
        super().__init__()
        cfg = self.config = config
        if cfg.positions not in _POSITIONS:
            raise ValueError(f"unknown positions {cfg.positions!r}; known: {_POSITIONS}")
        if cfg.num_register_tokens and not cfg.has_cls_token:
            raise ValueError("register tokens follow a CLS token")
        self.capture_layers = tuple(capture_layers)
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, d)
        if cfg.has_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, d))
        if cfg.positions == "learned":
            n_tok = cfg.num_patches + int(cfg.has_cls_token)
            self.pos_embed = nn.Parameter(torch.zeros(1, n_tok, d))
        # the RoPE table by device, made at the first forward on it
        self._rope: dict[torch.device, torch.Tensor] = {}
        self.blocks = nn.ModuleList(
            Block(
                cfg,
                cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
                if cfg.drop_path_rate > 0 else 0.0,
                mesh,
            )
            for i in range(cfg.depth)
        )
        self.norm = nn.LayerNorm(d, eps=cfg.ln_eps)
        if cfg.num_classes > 0:
            self.head = nn.Linear(d, cfg.num_classes)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """The JAX package's initializers, drawn from a CPU generator seeded
        with `seed` (the same weights on every device): fan-in truncated
        normal for linear kernels, fan-out normal for the patch conv,
        truncated normal(0.02) for cls, registers and pos, zero biases."""
        g = torch.Generator().manual_seed(seed)

        def draw(p, fill):
            cpu = torch.empty(p.shape, dtype=p.dtype)
            fill(cpu)
            p.copy_(cpu)

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                std = math.sqrt(2.0 / mod.in_features)
                draw(mod.weight, lambda w: _trunc_normal_(w, std, g))
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                kh, kw = mod.kernel_size
                std = math.sqrt(2.0 / (kh * kw * mod.out_channels))
                draw(mod.weight, lambda w: w.normal_(0.0, std, generator=g))
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, LayerScale):
                mod.gamma.fill_(mod.init)
        if self.config.has_cls_token:
            draw(self.cls_token, lambda w: _trunc_normal_(w, 0.02, g))
        if self.config.num_register_tokens:
            draw(self.register_tokens, lambda w: _trunc_normal_(w, 0.02, g))
        if self.config.positions == "learned":
            draw(self.pos_embed, lambda w: _trunc_normal_(w, 0.02, g))

    def rope_table(self, device) -> torch.Tensor | None:
        """The (2, patches, head_dim / 2) fp32 cos and sin of the patch
        grid's angles on `device` (`ops.rope.rope_table`), made once a
        device; None for learned positions."""
        cfg = self.config
        if cfg.positions != "rope":
            return None
        device = torch.device(device)
        if device not in self._rope:
            grid = cfg.img_size // cfg.patch_size
            self._rope[device] = rope_table(
                grid, grid, cfg.embed_dim // cfg.num_heads).to(device)
        return self._rope[device]

    def forward(
        self,
        x: torch.Tensor,  # (B, H, W, 3) float
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
        batch_rows: tuple[int, int] | None = None,
    ) -> ViTOutput:
        """`batch_rows` = (lo, total) when x holds rows lo.. of a global
        batch of `total` (a data-parallel rank's slice): the drop-path draws
        are made for the global batch and sliced, so every rank draws what
        one process would."""
        cfg = self.config
        dt = cfg.dtype
        b = x.shape[0]
        conv = self.patch_embed.proj
        x = F.conv2d(
            x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt), conv.bias.to(dt),
            stride=cfg.patch_size,
        )
        x = x.flatten(2).transpose(1, 2)  # (B, N, D), row-major patches
        n = x.shape[1]
        if cfg.has_cls_token:
            x = torch.cat([self.cls_token.to(dt).expand(b, 1, -1), x], dim=1)
        if cfg.positions == "learned":
            x = x + self.pos_embed.to(dt)
        if cfg.num_register_tokens:
            reg = self.register_tokens.to(dt).expand(b, -1, -1)
            x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
        rope = self.rope_table(x.device)
        prefix = cfg.num_prefix

        remat = cfg.remat and torch.is_grad_enabled()
        tokens, imps = [], []
        # without a gradient (a frozen teacher) each captured layer is
        # written into one stack as its block ends, so no block's whole
        # residual stream outlives the next block (40 streams of DINOv3's
        # ViT-7B at batch 256 are 15.7 GiB beside a 15.3 GiB stack)
        captured = [i for i in range(cfg.depth) if i in self.capture_layers]
        stack = None
        if captured and not torch.is_grad_enabled():
            stack = x.new_empty((len(captured), b, x.shape[1] - prefix, cfg.embed_dim))
        for i, blk in enumerate(self.blocks):
            draws = blk.draw(x, train, generator, batch_rows)
            if remat:
                # the body draws nothing from any generator, so no RNG
                # state needs to be kept for the recomputation
                x, importance = checkpoint(blk, x, dt, *draws, rope, use_reentrant=False,
                                           preserve_rng_state=False)
            else:
                x, importance = blk(x, dt, *draws, rope)
            if i in self.capture_layers:
                if stack is None:
                    tokens.append(x[:, prefix:] if prefix else x)
                else:
                    stack[len(imps)].copy_(x[:, prefix:])
                imps.append(importance)

        x = _layer_norm(x, self.norm)
        pooled = x[:, 0] if cfg.has_cls_token else x.mean(dim=1)
        if cfg.num_classes > 0:
            logits = F.linear(pooled.float(), self.head.weight, self.head.bias)
        else:
            logits = pooled.float()
        if imps:
            tok = stack if stack is not None else torch.stack(tokens)
            imp = torch.stack(imps)
        else:
            tok = x.new_zeros((0, b, n, cfg.embed_dim))
            imp = x.new_zeros((0, b, n), dtype=torch.float32)
        return ViTOutput(logits=logits, tokens=tok, importance=imp)
