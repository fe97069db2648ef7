"""The selector's fp32 copies of the teacher token stack taken in slices
(`losses/selector.py:F32_COPY_BYTES`), as DINOv2 ViT-g's 40-layer stack
takes them on the card: forced here by a small budget, against the one
product that smaller stacks take. On the CPU, in fp32 and from bf16
tokens."""

import pytest
import torch

from basd_tpu_torch.losses import selector as sel

torch.set_num_threads(1)

L, B, N, D_T, D_S, P = 6, 4, 9, 40, 24, 3


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randn((L, B, N, D_T), generator=g).to(torch.bfloat16)
    student = torch.randn((P, B, N, D_S), generator=g, requires_grad=True)
    importance = torch.rand((L, B, N), generator=g)
    return tokens, student, importance


def test_slices_cover_the_rows_within_the_budget(monkeypatch):
    monkeypatch.setattr(sel, "F32_COPY_BYTES", 1000)
    for n, row in ((6, 400), (7, 333), (10, 100), (5, 1000), (3, 1)):
        parts = sel._slices(n, row)
        assert [i for s in parts for i in range(s.start, s.stop)] == list(range(n))
        assert all((s.stop - s.start) * row <= 1000 for s in parts) or row > 1000
    assert sel._slices(10, 100) == [slice(0, 10)]
    # the default budget: the ViT-g stack (40 x 65,536 x 1,536 fp32) in two
    # slices, the ViT-L one (24 x 65,536 x 1,024) in one
    monkeypatch.undo()
    assert len(sel._slices(40, 4 * 65536 * 1536)) == 2
    assert len(sel._slices(24, 4 * 65536 * 1024)) == 1
    assert len(sel._slices(256 * 256 * 1536, 4 * 40)) == 2


@pytest.mark.parametrize("budget", [4 * B * N * D_T * 2, 4 * B * N * D_T + 7, 4 * L * 30])
def test_sliced_projection_and_mix_equal_the_one_product(monkeypatch, budget):
    """The projection slice by slice of layers is the one product bit for
    bit (each layer's product is the same); the mix's values too (each
    column's sum over layers is the same), and its gradient to the
    weights, summed over column slices, within 1e-6 of the one product's."""
    tokens, _, _ = _inputs()
    proj = torch.randn((D_S, D_T), generator=torch.Generator().manual_seed(1))
    w = torch.softmax(torch.randn((P, L)), dim=-1).requires_grad_(True)
    flat = tokens.reshape(L, -1)
    whole_z = sel._project(tokens.reshape(L, B * N, D_T), proj)
    whole_m = sel._mix(w, flat)
    (whole_g,) = torch.autograd.grad(whole_m.square().sum(), w)
    monkeypatch.setattr(sel, "F32_COPY_BYTES", budget)
    assert len(sel._slices(L, 4 * B * N * D_T)) > 1 or len(sel._slices(flat.shape[1], 4 * L)) > 1
    z = sel._project(tokens.reshape(L, B * N, D_T), proj)
    m = sel._mix(w, flat)
    (g,) = torch.autograd.grad(m.square().sum(), w)
    assert torch.equal(z, whole_z)
    assert torch.equal(m, whole_m)
    assert float((g - whole_g).abs().max() / whole_g.abs().max()) <= 1e-6


def test_select_and_mix_in_slices(monkeypatch):
    """The whole selector with the stack in slices: the same mixed tokens,
    ranks and distances, and gradients to the student tokens and the
    temperatures within 1e-5 of the one product's."""
    tokens, student, importance = _inputs(2)
    state = sel.init_selector(3, P, D_S, D_T, device="cpu")

    def run():
        mixed, mixed_imp, aux = sel.select_and_mix(state, student, tokens, importance,
                                                   subspace_k=8)
        loss = mixed.float().square().mean() + aux["grassmann_d2"].sum()
        grads = torch.autograd.grad(loss, (student, state.log_temperatures))
        return mixed, aux, grads

    mixed, aux, grads = run()
    monkeypatch.setattr(sel, "F32_COPY_BYTES", 4 * B * N * D_T * 2)
    mixed2, aux2, grads2 = run()
    assert torch.equal(mixed2, mixed)
    assert torch.equal(aux2["mp_ranks"], aux["mp_ranks"])
    assert torch.equal(aux2["grassmann_d2"], aux["grassmann_d2"])
    for a, b in zip(grads2, grads):
        assert float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)) <= 1e-5
