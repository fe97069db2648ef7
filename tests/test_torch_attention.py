"""Attention K1/K2 plain versions (`basd_tpu_torch/ops/attention.py`) held
against the JAX package's Pallas kernels in interpret mode and its
`xla_attention_ref` on a small batch: at the main path's head layouts
(student D=192 H=3, teacher D=768 H=12, head_dim 64), the Table-1 ones
(N=197 D=384 H=6, N=257 D=768 H=12), head_dim 32 and 128, and ragged N
(1, 17, 129): the shapes whose tiling (16-row warp tiles, 64-row chunks,
padded keys) the CUDA kernels have to get right. The kernel wrappers'
launches against a recording stand-in library: the arguments each passes
to its C entry point and the one launch it counts."""

import ctypes
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.ops import attention as jattn
from basd_tpu_torch import kernels
from basd_tpu_torch.ops import attention as tattn
from test_torch_helpers import assert_close, t32

torch.set_num_threads(1)

SHAPES = [
    (2, 65, 192, 3), (2, 5, 768, 12),  # Table-3 student and teacher
    (2, 197, 384, 6), (2, 257, 768, 12),  # Table-1 student and teacher
    (2, 33, 96, 3), (2, 40, 256, 2),  # head_dim 32 and 128
    (2, 1, 192, 3), (2, 17, 192, 3), (2, 129, 192, 3),  # ragged N
]


def _inputs(b, n, d, h, seed=0):
    rng = np.random.default_rng(seed)
    hd = d // h
    q = rng.standard_normal((b, n, d)).astype(np.float32) * hd**-0.5
    k = rng.standard_normal((b, n, d)).astype(np.float32)
    v = rng.standard_normal((b, n, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,n,d,h", SHAPES)
def test_forward_matches_pallas_interpret_and_stats(b, n, d, h):
    """fp32: o, m and denom agree with `_fwd_call(interpret=True)` and o
    with `xla_attention_ref` to 1e-5 of scale (fp32 sums in another order)."""
    hd = d // h
    q, k, v = _inputs(b, n, d, h)
    o, m, denom = tattn.attention_forward(t32(q), t32(k), t32(v), hd)
    jo, jm, jd = jattn._fwd_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), hd, interpret=True
    )
    assert_close(o, jo, 1e-5, "o vs interpret kernel")
    assert_close(m, jm, 1e-5, "rowmax")
    assert_close(denom, jd, 1e-5, "denom")
    ref = jattn.xla_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), hd)
    assert_close(o, ref, 1e-5, "o vs xla_attention_ref")
    fused = jattn.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), hd, True)
    assert_close(tattn.fused_attention(t32(q), t32(k), t32(v), hd), fused, 1e-5,
                 "fused_attention")


@pytest.mark.parametrize("b,n,d,h", SHAPES)
def test_gradients_match_jax_vjp(b, n, d, h):
    """Gradients to all of q, k, v through the port's autograd.Function
    (plain K2 on the CPU) against jax.vjp of the interpret-mode kernel:
    1e-5 of scale in fp32. At N=1 the softmax over one key is constant, so
    dq and dk are 0 in exact arithmetic and both sides return the rounding
    noise of dO.v - dd: there both stay below 1e-5 of dv's scale."""
    hd = d // h
    q, k, v = _inputs(b, n, d, h, seed=1)
    do = np.random.default_rng(2).standard_normal((b, n, d)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, bb, c: jattn.fused_attention(a, bb, c, hd, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (t32(x).requires_grad_(True) for x in (q, k, v))
    out = tattn.fused_attention(tq, tk, tv, hd)
    out.backward(t32(do))
    scale = float(np.abs(np.asarray(jgrads[2])).max())
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        if n == 1 and name != "v":
            assert float(got.abs().max()) <= 1e-5 * scale, f"d{name}"
            assert float(np.abs(np.asarray(want)).max()) <= 1e-5 * scale, f"d{name}"
        else:
            assert_close(got, want, 1e-5, f"d{name}")


def test_bf16_rounds_e_before_denom():
    """bf16: the plain K1 follows the Pallas kernel (denom sums the
    bf16-ROUNDED e), within 2e-3 of the interpret kernel's denom (a few bf16
    roundings of e may flip where fp32 scores differ in their last bit), and
    o within 2e-2 of scale (bf16 output)."""
    b, n, d, h = SHAPES[0]
    hd = d // h
    q, k, v = _inputs(b, n, d, h, seed=3)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jo, jm, jd = jattn._fwd_call(qb, kb, vb, hd, interpret=True)
    tb = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    o, m, denom = tattn.attention_forward(tb(qb), tb(kb), tb(vb), hd)
    assert o.dtype == torch.bfloat16
    assert_close(denom, jd, 2e-3, "bf16 denom")
    assert_close(m, jm, 1e-5, "bf16 rowmax")
    assert_close(o, np.asarray(jo.astype(jnp.float32)), 2e-2, "bf16 o")


def test_backward_plain_formula_matches_autograd_of_softmax():
    """The stats-based backward equals autograd through a plain fp32
    softmax(q k^T) v (1e-5 of scale), independent of the JAX package."""
    b, n, d, h = 2, 17, 64, 2
    hd = d // h
    q, k, v = (t32(x) for x in _inputs(b, n, d, h, seed=4))
    do = t32(np.random.default_rng(5).standard_normal((b, n, d)))
    o, m, denom = tattn.attention_forward_plain(q, k, v, hd)
    dd = (do * o).reshape(b, n, h, hd).sum(-1).contiguous()
    got = tattn.attention_backward_plain(q, k, v, do, m, denom, dd, hd)
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    split = lambda x: x.reshape(b, n, h, hd).transpose(1, 2)
    p = torch.softmax(split(qs) @ split(ks).transpose(-1, -2), dim=-1)
    ref = (p @ split(vs)).transpose(1, 2).reshape(b, n, d)
    want = torch.autograd.grad(ref, (qs, ks, vs), do)
    for g, w, name in zip(got, want, "qkv"):
        assert_close(g, w, 1e-5, f"d{name}")


def test_supports_fused_gate_matches_jax():
    """The JAX package's gate up to its width cap of 2048 (a Pallas block
    holds the whole (N, D) slab in VMEM); above it the port's kernels, one
    head a CTA, take any width: DINOv3's ViT-7B teacher at D = 4096."""
    for n, d, hd in [(65, 192, 64), (5, 768, 64), (513, 192, 64),
                     (65, 192, 24), (512, 2048, 128)]:
        assert tattn.supports_fused(n, d, hd) == jattn.supports_fused(n, d, hd)
    for n, d, hd in [(65, 4096, 128), (201, 4096, 128)]:
        assert tattn.supports_fused(n, d, hd) and not jattn.supports_fused(n, d, hd)
    assert not tattn.supports_fused(513, 4096, 128)


class _StandIn:
    """The library's two entry points over CPU memory: each records its
    arguments and writes its plain version's values through the output
    pointers, so the wrappers' marshalling runs end to end."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.calls = []

    def _write(self, ptrs, values):
        for ptr, value in zip(ptrs, values):
            value = value.contiguous()
            ctypes.memmove(ptr, value.data_ptr(), value.numel() * value.element_size())

    def basd_attention_fwd(self, *args):
        self.calls.append(("fwd", args))
        self._write(args[3:6], tattn.attention_forward_plain(
            *(self.by_ptr[p] for p in args[:3]), args[9]))
        return 0

    def basd_attention_bwd(self, *args):
        self.calls.append(("bwd", args))
        self._write(args[7:10], tattn.attention_backward_plain(
            *(self.by_ptr[p] for p in args[:7]), args[13]))
        return 0


def _packed_qkv(b=2, n=17, d=48, seed=0):
    """bf16 q, k, v as the column blocks of one (B, N, 3D) projection:
    strided views, each 16-byte aligned, with row stride 3D."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, n, 3 * d), generator=g).to(torch.bfloat16)
    return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]


@pytest.fixture
def stand_in(monkeypatch):
    holder = {}
    monkeypatch.setattr(kernels, "library", lambda name: holder["lib"])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setitem(kernels.LAUNCHES, "attention_fwd", 0)
    monkeypatch.setitem(kernels.LAUNCHES, "attention_bwd", 0)

    def make(*tensors):
        holder["lib"] = _StandIn(tensors)
        return holder["lib"]
    return make


def test_forward_wrapper_passes_pointers_strides_and_stream(stand_in):
    """K1 at (2, 17, 48) H=3 bf16 on strided q, k, v: the pointers of the
    three inputs and of o, m and denom, (B, N, H, hd), each input's batch
    and row strides in elements, the bf16 flag and the current stream;
    one launch counted, and the outputs the stand-in wrote come back."""
    q, k, v = _packed_qkv()
    lib = stand_in(q, k, v)
    o, m, denom = tattn._attention_forward_cuda(q, k, v, 16)
    assert (o.shape, m.shape, denom.shape) == ((2, 17, 48), (2, 17, 3), (2, 17, 3))
    assert o.dtype == torch.bfloat16 and m.dtype == denom.dtype == torch.float32
    strides = (17 * 144, 144) * 3
    assert lib.calls == [("fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  m.data_ptr(), denom.data_ptr(), 2, 17, 3, 16,
                                  *strides, 1, 7))]
    for got, want in zip((o, m, denom), tattn.attention_forward_plain(q, k, v, 16)):
        assert torch.equal(got, want)
    assert (kernels.LAUNCHES["attention_fwd"], kernels.LAUNCHES["attention_bwd"]) == (1, 0)


def test_backward_wrapper_passes_pointers_strides_and_stream(stand_in):
    """K2 at (2, 17, 48) H=3 bf16, strided q, k, v and a contiguous dO:
    the seven inputs' and three outputs' pointers, (B, N, H, hd), q, k, v
    and dO's batch and row strides, the bf16 flag and the stream; one
    launch counted, and dq, dk, dv the stand-in wrote come back."""
    q, k, v = _packed_qkv()
    do = torch.randn((2, 17, 48), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    _, m, denom = tattn.attention_forward_plain(q, k, v, 16)
    dd = torch.randn((2, 17, 3), generator=torch.Generator().manual_seed(2))
    lib = stand_in(q, k, v, do, m, denom, dd)
    dq, dk, dv = tattn._attention_backward_cuda(q, k, v, do, m, denom, dd, 16)
    ptrs = tuple(t.data_ptr() for t in (q, k, v, do, m, denom, dd, dq, dk, dv))
    strides = (17 * 144, 144) * 3 + (17 * 48, 48)
    assert lib.calls == [("bwd", (*ptrs, 2, 17, 3, 16, *strides, 1, 7))]
    want = tattn.attention_backward_plain(q, k, v, do, m, denom, dd, 16)
    for got, w in zip((dq, dk, dv), want):
        assert got.shape == (2, 17, 48) and torch.equal(got, w)
    assert (kernels.LAUNCHES["attention_fwd"], kernels.LAUNCHES["attention_bwd"]) == (0, 1)
