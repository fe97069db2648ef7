"""The port's entry check (`basd_tpu_torch.entry`) against the JAX
package's `__graft_entry__.py`, on the CPU: `entry()`'s forward on the JAX
entry's own weights, and `dryrun_multichip` over 4 gloo ranks started by
`torch.distributed.run` against the port's one-process step on the same
global batch."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from basd_tpu_torch import entry
from basd_tpu_torch.models.convert import vit_state_dict_from_jax
from test_torch_helpers import flax_params_np

torch.set_num_threads(1)

# Both forwards compute in bf16 (2^-8 = 3.9e-3 relative spacing); XLA fuses
# elementwise chains without the intermediate bf16 roundings of torch's
# eager ops, so twelve blocks drift by a few bf16 ulps of each output's
# scale (1.3e-2 to 1.9e-2 measured at the maximum, 0.7e-2 to 1.5e-2 on
# average): bound 8 ulps (3.125e-2) at the maximum and 2e-2 on average.
BF16_MAX = 8 * 2.0**-8
BF16_MEAN = 2e-2


@pytest.mark.parametrize("images", ["zeros", "seeded"])
def test_entry_forward_matches_the_jax_entry(images):
    """The ViT-Tiny student (patch 4 at 32 px, bf16, captures at
    extraction_points(12, 4)) on the JAX entry's weights, carried by
    `vit_state_dict_from_jax`: the entry's own zero batch and a seeded one."""
    jforward, (jparams, jimages) = graft.entry()
    forward, (params, zeros) = entry.entry(device="cpu")
    assert zeros.shape == jimages.shape == (8, 32, 32, 3) and not zeros.any()
    sd = vit_state_dict_from_jax(flax_params_np(jparams))
    assert set(sd) == set(params)
    x = (np.zeros(zeros.shape, np.float32) if images == "zeros"
         else np.random.default_rng(0).random(zeros.shape).astype(np.float32))
    want = jax.jit(jforward)(jparams, jnp.asarray(x))
    got = forward(sd, torch.from_numpy(x))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16
    for g, w, what in zip(got, want, ("logits", "tokens")):
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape, what
        err = np.abs(g - w)
        assert err.max() <= BF16_MAX * np.abs(w).max(), (what, err.max())
        assert err.mean() <= BF16_MEAN * np.abs(w).mean(), (what, err.mean())


def test_entry_forward_reads_the_params_it_is_given():
    forward, (params, images) = entry.entry(device="cpu")
    logits, tokens = forward(params, images)
    assert logits.shape == (8, 100) and tokens.shape == (4, 8, 64, 192)
    doubled = {k: v * 2 if k == "head.weight" else v for k, v in params.items()}
    logits2, _ = forward(doubled, images)
    torch.testing.assert_close(logits2 - params["head.bias"], 2 * (logits - params["head.bias"]))


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_follows_the_jax_entry(n):
    src = Path(graft.__file__).read_text()
    assert "model_par = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1" in src
    model = 2 if n % 2 == 0 and n >= 4 else 1
    assert entry.mesh_shape(n) == (n // model, model)


def test_dryrun_multichip_on_four_gloo_ranks(capsys):
    """4 CPU ranks (2 x 2) under torchrun: a finite loss, and a loss,
    gradient and update equal to the one-process step's on the same global
    batch within `DRYRUN_BOUNDS` (the loss at 1e-5, tighter than
    tests/test_torch_parallel.py's 2e-4), the loss printed in the JAX
    entry's format."""
    result = entry.dryrun_multichip(4, device="cpu")
    text = capsys.readouterr().out
    line = re.search(r"^dryrun_multichip ok devices=4 mesh=\(2x2\) loss=(\d+\.\d{4})$",
                     text, re.M)
    assert line, text[-2000:]
    src = Path(graft.__file__).read_text()
    assert 'f"dryrun_multichip ok devices={n_devices} "' in src
    assert 'f"mesh=({n_devices // model_par}x{model_par}) loss={loss:.4f}"' in src
    assert result["mesh"] == [2, 2] and result["backend"] == "gloo"
    assert np.isfinite(result["loss"]) and float(line.group(1)) == round(result["loss"], 4)
    one = entry.dryrun_step(4, None, device="cpu")
    dist = entry.dryrun_distances(result, one)
    assert all(dist[k] <= bound for k, bound in entry.DRYRUN_BOUNDS.items()), dist
    assert not any(one["launches"].values()) and not any(result["launches"].values())
    assert "dryrun_multichip detail" not in text


def test_sketch_distance_is_the_tensors_relative_distance():
    """Within 4 standard errors (1/sqrt(2 SKETCH_ROWS) each) of the true
    ||a - b|| / ||b|| over a dict of tensors, whatever their order."""
    g = torch.Generator().manual_seed(1)
    b = {"w": torch.randn(64, 48, generator=g), "a": torch.randn(300, generator=g)}
    a = {k: v + 0.05 * torch.randn(v.shape, generator=g) for k, v in reversed(b.items())}
    true = float(torch.cat([(a[k] - b[k]).reshape(-1) for k in b]).norm()
                 / torch.cat([b[k].reshape(-1) for k in b]).norm())
    est = entry.sketch_distance(entry.sketch(a), entry.sketch(b))
    assert abs(est / true - 1) <= 4 / (2 * entry.SKETCH_ROWS) ** 0.5
    assert entry.sketch(b) == entry.sketch(dict(reversed(b.items())))
    assert entry.sketch_distance(entry.sketch(b), entry.sketch(b)) == 0.0


def test_dryrun_multichip_raises_with_the_ranks_tail(monkeypatch):
    monkeypatch.setattr(entry, "DETAIL", "no such line ")
    with pytest.raises(RuntimeError, match="dryrun_multichip subprocess failed rc=0"):
        entry.dryrun_multichip(1, device="cpu")


def test_main_runs_the_entry_then_the_eight_rank_dryrun(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(entry, "dryrun_multichip", lambda n, device: calls.append((n, device)))
    assert entry.main(["--device", "cpu"]) == 0
    assert calls == [(8, "cpu")]
    assert "entry ok: ((8, 100), (4, 8, 64, 192))" in capsys.readouterr().out


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    """Without CUDA the default device raises before anything is built or
    started."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry.entry, lambda: entry.dryrun_multichip(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
