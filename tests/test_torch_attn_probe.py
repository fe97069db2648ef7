"""The attention probe's plain version (`basd_tpu_torch.ops.attn_probe`,
K6's plain version) held against the JAX tool's Pallas `kernel`
(`tools/probe_attn_internals.py`, loaded by file path and run by this test
through `pl.pallas_call(..., interpret=True)` on the tool's own grid and
block specs), for all six variants, on the CPU."""

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from basd_tpu_torch.ops import attn_probe as tprobe

torch.set_num_threads(1)

_TOOL = Path(__file__).resolve().parents[1] / "tools" / "probe_attn_internals.py"
B, H, HD, G = 16, 2, 16, 8  # two groups of 8 sequences


def _jax_kernel():
    spec = importlib.util.spec_from_file_location("probe_attn_internals", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel


def _jax_probe(q, k, v, variant):
    b, h, n, hd = q.shape
    block = pl.BlockSpec((G, 1, n, hd), lambda i, j: (i, j, 0, 0))
    call = pl.pallas_call(
        partial(_jax_kernel(), variant=variant), grid=(b // G, h),
        in_specs=[block] * 3, out_specs=block,
        out_shape=jax.ShapeDtypeStruct((b, h, n, hd), jnp.bfloat16),
        interpret=True,
    )
    return np.asarray(call(q, k, v).astype(jnp.float32))


def _inputs(n, seed):
    """The same bf16 q, k, v on both sides, from numpy normal * 0.1 as the
    tool makes them."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.normal(size=(B, H, n, HD)).astype(np.float32) * 0.1,
                      jnp.bfloat16) for _ in range(3)]
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
          for x in jx]
    return jx, tx


def _bf16_ulp(x):
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("variant", tprobe.VARIANTS)
@pytest.mark.parametrize("n", [9, 17])
def test_plain_probe_matches_the_pallas_kernel(n, variant):
    """Each output element within one bf16 ulp of the Pallas kernel's (the
    fp32 sums may round to neighbouring bf16 values where the two sum in
    another order; at these shapes they agree bit for bit)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(n, seed=n)
    want = _jax_probe(jq, jk, jv, variant)
    got = tprobe.probe_attention(tq, tk, tv, variant=variant, group=G)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, n, HD)
    diff = np.abs(got.float().numpy() - want)
    assert np.all(diff <= _bf16_ulp(want)), (variant, diff.max())


def test_tilemax_shares_one_max_per_group_of_sequences():
    """tilemax subtracts one max per (group, head) tile: raising the scores
    of one sequence changes the outputs of the other sequences of its group
    and of no other group; full (a per-row max) changes none of them."""
    _, (q, k, v) = _inputs(9, seed=1)
    q2 = q.clone()
    q2[0] = q2[0] * 8
    for variant, others_change in (("tilemax", True), ("full", False)):
        o1 = tprobe.probe_attention_plain(q, k, v, variant=variant, group=G)
        o2 = tprobe.probe_attention_plain(q2, k, v, variant=variant, group=G)
        changed = not torch.equal(o1[1:G], o2[1:G])
        assert changed == others_change, variant
        assert torch.equal(o1[G:], o2[G:])


def test_variants_differ_and_flops():
    _, (q, k, v) = _inputs(17, seed=2)
    outs = {var: tprobe.probe_attention(q, k, v, variant=var)
            for var in tprobe.VARIANTS}
    assert not torch.equal(outs["full"], outs["nomax"])
    assert not torch.equal(outs["full"], outs["tilemax"])
    assert not torch.equal(outs["noexp"], outs["full"])
    assert torch.equal(outs["noexp"], outs["mxonly"])  # same math on the CPU
    assert tprobe.probe_flops(256, 12, 257, 64) == 4 * 256 * 12 * 257 * 257 * 64
    with pytest.raises(ValueError, match="variant"):
        tprobe.probe_attention(q, k, v, variant="softmax")
    with pytest.raises(ValueError, match="group"):
        tprobe.probe_attention(q[:12], k[:12], v[:12], variant="tilemax")


class _RecordingLibrary:
    """Stands in for the attention probe's kernel library: records each
    call of its entry point and the arguments, and returns success."""

    def __init__(self):
        self.calls = []

    def basd_attn_probe(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("variant", tprobe.VARIANTS)
@pytest.mark.parametrize("n", [1, 17, 257, 272, 273, 1024])
def test_launch_passes_the_shape_and_variant_code(n, variant, monkeypatch):
    """`_probe_cuda` calls `basd_attn_probe` with (B, H, N, hd, group,
    variant code) at every N it takes, from one query row to 1024; tilemax
    first launches the tile maxima (code 6) into a (B, H, ceil(N / 64))
    fp32 scratch that its second launch reads; one count per launch."""
    lib = _RecordingLibrary()
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(empty(*a, **k)) or made[-1])
    monkeypatch.setattr(tprobe.kernels, "library", lambda name: lib)
    monkeypatch.setattr(tprobe, "_stream", lambda q: 0)
    monkeypatch.setitem(tprobe.kernels.LAUNCHES, "attn_probe", 0)
    q, k, v = (torch.zeros((8, 2, n, 64), dtype=torch.bfloat16) for _ in range(3))
    o = tprobe._probe_cuda(q, k, v, variant, 8)
    codes = ([6] if variant == "tilemax" else []) + [tprobe.VARIANTS.index(variant)]
    assert len(lib.calls) == len(codes)
    for args, code in zip(lib.calls, codes):
        assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        assert args[5:11] == (8, 2, n, 64, 8, code)
    if variant == "tilemax":
        [tile_max] = [t for t in made if t.data_ptr() == lib.calls[0][4]]
        assert tile_max.shape == (8, 2, -(-n // 64)) and tile_max.dtype == torch.float32
        assert lib.calls[1][4] == tile_max.data_ptr()
    else:
        assert lib.calls[0][4] is None
    assert tprobe.kernels.LAUNCHES["attn_probe"] == len(codes)


def test_wrapper_checks():
    """The wrapper refuses, before any library loads, an N outside 1..1024
    and an operand that is not 16-byte aligned."""
    for bad in (0, 1025):
        q = torch.zeros((8, 2, bad, 64), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="1 <= N <= 1024"):
            tprobe._probe_cuda(q, q, q, "full", 8)
    q = torch.zeros((8, 2, 9, 64), dtype=torch.bfloat16)
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tprobe._probe_cuda(q, q, shifted, "full", 8)
