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
