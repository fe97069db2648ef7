"""The selector's fp32 copies of the teacher token stack taken in slices
(`losses/selector.py:F32_COPY_BYTES`), forced here by a small budget,
against the one product that smaller stacks take; and the projection's
route (`tensor_core_projection`): bf16 tokens on a CUDA device take one
tensor-core product with an fp32 output, every other input the fp32 form.
On the CPU, in fp32 and from bf16 tokens."""

import types

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


@pytest.mark.parametrize("dtype, device, tensor_cores", [
    (torch.bfloat16, "cuda", True), (torch.bfloat16, "cuda:1", True),
    (torch.float32, "cuda", False), (torch.float16, "cuda", False),
    (torch.bfloat16, "cpu", False), (torch.float32, "cpu", False),
    (torch.bfloat16, "meta", False)])
def test_projection_route_by_dtype_and_device(dtype, device, tensor_cores):
    """The tensor-core route is taken by bf16 tokens on a CUDA device alone
    (a CUDA-typed stand-in: the predicate reads only dtype and device)."""
    tokens = types.SimpleNamespace(dtype=dtype, device=torch.device(device))
    assert sel.tensor_core_projection(tokens) is tensor_cores


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_projection_is_the_fp32_form(monkeypatch, dtype):
    """On the CPU `_project` is the fp32 product of the operands rounded to
    the tokens' dtype, bit for bit, and counts no tensor-core projection."""
    monkeypatch.setattr(sel, "TENSOR_CORE_PROJECTIONS", 0)
    g = torch.Generator().manual_seed(4)
    tokens = torch.randn((L, B * N, D_T), generator=g).to(dtype)
    proj = torch.randn((D_S, D_T), generator=g)
    want = tokens.float() @ proj.to(dtype).float().T
    assert torch.equal(sel._project(tokens, proj), want)
    assert torch.equal(sel._project_f32(tokens, proj), want)
    assert sel.TENSOR_CORE_PROJECTIONS == 0


def test_tensor_core_projection_is_one_bf16_product_with_an_fp32_output(monkeypatch):
    """The route's one call: the flattened (L M, D_t) bf16 stack times the
    bf16 proj_t^T, out_dtype fp32, no fp32 copy of the stack; its output
    reshaped to (L, M, D_s) and counted once. A stand-in for aten::mm.dtype
    (not on the CPU) sums the exact products in float64."""
    calls = []

    def mm(a, b, *, out_dtype):
        calls.append((a.shape, a.dtype, a.is_contiguous(), b.shape, b.dtype, out_dtype))
        return (a.double() @ b.double()).to(out_dtype)

    monkeypatch.setattr(sel, "TENSOR_CORE_PROJECTIONS", 0)
    monkeypatch.setattr(sel, "tensor_core_projection", lambda tokens: True)
    monkeypatch.setattr(torch, "mm", mm)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randn((L, B * N, D_T), generator=g).to(torch.bfloat16)
    proj = torch.randn((D_S, D_T), generator=g)
    z = sel._project(tokens, proj)
    assert calls == [((L * B * N, D_T), torch.bfloat16, True, (D_T, D_S), torch.bfloat16,
                      torch.float32)]
    assert z.shape == (L, B * N, D_S) and z.dtype == torch.float32
    want = (tokens.double() @ proj.to(torch.bfloat16).double().T).float()
    assert torch.equal(z, want)
    assert sel.TENSOR_CORE_PROJECTIONS == 1
    # the fp32 form sums the same exact products in another order
    assert torch.allclose(sel._project_f32(tokens, proj), z, rtol=1e-5, atol=1e-5)


def test_select_and_mix_on_the_cpu_counts_no_tensor_core_projection(monkeypatch):
    """A CPU `select_and_mix` on bf16 tokens takes the fp32 form: the
    counter reads 0 after it."""
    monkeypatch.setattr(sel, "TENSOR_CORE_PROJECTIONS", 0)
    tokens, student, importance = _inputs(6)
    state = sel.init_selector(3, P, D_S, D_T, device="cpu")
    sel.select_and_mix(state, student, tokens, importance, subspace_k=8)
    assert sel.TENSOR_CORE_PROJECTIONS == 0
