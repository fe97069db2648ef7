"""The erf GELU (`ops/activations.py`): the plain route against the
composite F.gelu(x.float()).to(dtype), forward and backward; the autograd
Function `Gelu` (the route the kernels of `csrc/gelu.cu` take on the card)
against the composite's autograd, under remat too; the kernel wrappers'
refusals, their launches against a recording stand-in library and their
route, on the CPU."""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from basd_tpu_torch import kernels
from basd_tpu_torch.losses import extraction_points
from basd_tpu_torch.models import create_student, vit
from basd_tpu_torch.ops import activations
from test_torch_helpers import CPU

torch.set_num_threads(1)

DTYPES = [torch.bfloat16, torch.float32]
SHAPES = [(1,), (7,), (8,), (9,), (3, 5, 11), (4, 96)]


def _x(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (3.0 * torch.randn(shape, generator=g)).to(dtype)


def _composite(x):
    return F.gelu(x.float()).to(x.dtype)


def _grad(fn, x, dy):
    x = x.clone().requires_grad_(True)
    fn(x).backward(dy)
    return x.grad


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_route_is_the_composite_forward_and_backward(shape, dtype):
    """On the CPU `gelu` is the composite, and `gelu_backward_plain` is its
    autograd's gradient bit for bit; the CPU launches nothing."""
    before = dict(kernels.LAUNCHES)
    x, dy = _x(shape, dtype), _x(shape, dtype, seed=1)
    got = activations.gelu(x)
    assert got.dtype == dtype and torch.equal(got, _composite(x))
    assert torch.equal(activations.gelu_plain(x), _composite(x))
    want = _grad(_composite, x, dy)
    assert want.dtype == dtype
    assert torch.equal(_grad(activations.gelu, x, dy), want)
    assert torch.equal(activations.gelu_backward_plain(dy, x), want)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_function_matches_the_composites_autograd(shape, dtype):
    """`Gelu` gives the composite's output and gradient bit for bit, and
    saves x itself, in its own dtype: no fp32 copy."""
    x, dy = _x(shape, dtype, seed=2), _x(shape, dtype, seed=3)
    xg = x.clone().requires_grad_(True)
    y = activations.Gelu.apply(xg)
    assert torch.equal(y, _composite(x))
    (saved,) = y.grad_fn.saved_tensors
    assert saved.dtype == dtype and saved.data_ptr() == xg.data_ptr()
    y.backward(dy)
    assert torch.equal(xg.grad, _grad(_composite, x, dy))


def test_backward_rounds_once_from_fp32():
    """bf16: the gradient is the fp32 gradient of the widened operands,
    rounded once (no bf16 intermediate)."""
    x, dy = _x((4096,), torch.bfloat16, seed=4), _x((4096,), torch.bfloat16, seed=5)
    fp32 = _grad(lambda t: F.gelu(t), x.float(), dy.float())
    assert torch.equal(activations.gelu_backward_plain(dy, x), fp32.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", DTYPES)
def test_function_under_checkpoint_gives_the_gradients_without_it(dtype):
    """fc2(Gelu(fc1 x)) with and without `checkpoint(use_reentrant=False)`:
    the same output and gradients bit for bit."""
    fc1, fc2 = torch.nn.Linear(24, 96).to(dtype), torch.nn.Linear(96, 24).to(dtype)
    x = _x((5, 24), dtype, seed=6)
    mlp = lambda t: fc2(activations.Gelu.apply(fc1(t)))
    runs = {}
    for remat in (False, True):
        for p in (*fc1.parameters(), *fc2.parameters()):
            p.grad = None
        xg = x.clone().requires_grad_(True)
        out = checkpoint(mlp, xg, use_reentrant=False) if remat else mlp(xg)
        out.sum().backward()
        runs[remat] = [out, xg.grad] + [p.grad for p in (*fc1.parameters(),
                                                         *fc2.parameters())]
    for a, b in zip(runs[False], runs[True]):
        assert torch.equal(a, b)


def _student(remat: bool, dtype):
    return create_student(
        "vit_micro_patch4", num_classes=10, drop_path_rate=0.1, img_size=16,
        capture_layers=extraction_points(4, 2), dtype=dtype, remat=remat,
        device=CPU, seed=5)[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_student_with_the_function_under_remat(dtype, monkeypatch):
    """The micro student (depth 4) with its MLPs' GELU through `Gelu`, as
    on the card: remat and no remat give the same outputs and gradients
    bit for bit, and the composite's; the GELU forward runs twice a block
    under remat (forward and recomputation) and the backward once, as the
    card's counters count them (Table-1's 12-block student: 24 and 12)."""
    calls = {"fwd": 0, "bwd": 0}
    plain_fwd, plain_bwd = activations.gelu_plain, activations.gelu_backward_plain

    def fwd(x):
        calls["fwd"] += 1
        return plain_fwd(x)

    def bwd(dy, x):
        calls["bwd"] += 1
        return plain_bwd(dy, x)

    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 16, 16, 3))
                         .astype(np.float32))
    results = {}
    for route, remat in (("composite", False), ("function", False), ("function", True)):
        if route == "function":
            monkeypatch.setattr(vit, "gelu", activations.Gelu.apply)
            monkeypatch.setattr(activations, "gelu_plain", fwd)
            monkeypatch.setattr(activations, "gelu_backward_plain", bwd)
        calls.update(fwd=0, bwd=0)
        model = _student(remat, dtype)
        out = model(x, train=True, generator=torch.Generator().manual_seed(11))
        sum(a.float().sum() for a in out).backward()
        results[(route, remat)] = ([*out], {n: p.grad for n, p in model.named_parameters()},
                                   dict(calls))
    assert results[("function", False)][2] == {"fwd": 4, "bwd": 4}
    assert results[("function", True)][2] == {"fwd": 8, "bwd": 4}
    base_out, base_grads, _ = results[("composite", False)]
    for key in (("function", False), ("function", True)):
        out, grads, _ = results[key]
        for a, b in zip(base_out, out):
            assert torch.equal(a, b), key
        for name in base_grads:
            assert torch.equal(base_grads[name], grads[name]), (key, name)


def test_kernel_wrappers_refuse_before_any_library_loads(monkeypatch):
    monkeypatch.setattr(kernels, "library", lambda name: pytest.fail("loaded"))
    with pytest.raises(ValueError, match="bf16 or fp32"):
        activations.gelu_cuda(torch.zeros((4, 16), dtype=torch.float16))
    with pytest.raises(ValueError, match="bf16 or fp32"):
        activations.gelu_cuda(torch.zeros((4, 16), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        activations.gelu_cuda(torch.zeros((16, 4)).t())
    with pytest.raises(ValueError, match="contiguous"):
        activations.gelu_cuda(torch.zeros((4, 16), dtype=torch.bfloat16)[:, :8])
    x = torch.zeros((4, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        activations.gelu_backward_cuda(x, x.t())
    with pytest.raises(ValueError, match="dtype and shape"):
        activations.gelu_backward_cuda(x.float(), x)
    with pytest.raises(ValueError, match="dtype and shape"):
        activations.gelu_backward_cuda(x[:2], x)
    assert "gelu" not in kernels._LOADED


class _StandIn:
    """The library's two entry points over CPU memory: each records its
    arguments and writes the plain version's values through the pointers,
    so the wrappers' plumbing runs end to end."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.calls = []

    def _write(self, ptr, value):
        ctypes.memmove(ptr, value.data_ptr(), value.numel() * value.element_size())

    def basd_gelu_fwd(self, x, y, n, is_bf16, stream):
        self.calls.append(("fwd", x, y, n, is_bf16, stream))
        self._write(y, activations.gelu_plain(self.by_ptr[x]))
        return 0

    def basd_gelu_bwd(self, dy, x, dx, n, is_bf16, stream):
        self.calls.append(("bwd", dy, x, dx, n, is_bf16, stream))
        self._write(dx, activations.gelu_backward_plain(self.by_ptr[dy], self.by_ptr[x]))
        return 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_wrappers_launch_once_and_count(dtype, monkeypatch):
    x, dy = _x((6, 40), dtype, seed=7), _x((6, 40), dtype, seed=8)
    lib = _StandIn([x, dy])
    monkeypatch.setattr(kernels, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(
        cuda_stream=7))
    monkeypatch.setitem(kernels.LAUNCHES, "gelu_fwd", 0)
    monkeypatch.setitem(kernels.LAUNCHES, "gelu_bwd", 0)
    y = activations.gelu_cuda(x)
    dx = activations.gelu_backward_cuda(dy, x)
    assert torch.equal(y, _composite(x))
    assert torch.equal(dx, _grad(_composite, x, dy))
    bf16 = int(dtype == torch.bfloat16)
    assert lib.calls == [("fwd", x.data_ptr(), y.data_ptr(), 240, bf16, 7),
                         ("bwd", dy.data_ptr(), x.data_ptr(), dx.data_ptr(), 240, bf16, 7)]
    assert (kernels.LAUNCHES["gelu_fwd"], kernels.LAUNCHES["gelu_bwd"]) == (1, 1)
    # an empty tensor launches nothing
    assert activations.gelu_cuda(x[:0]).shape == (0, 40)
    assert len(lib.calls) == 2 and kernels.LAUNCHES["gelu_fwd"] == 1


def test_routes_by_alignment():
    """16-byte vectors where every pointer is 16-byte aligned, one value a
    thread otherwise (a view at an odd offset); the size needs no route of
    its own: the vector route's first block takes the tail."""
    x = torch.zeros(64, dtype=torch.bfloat16)
    assert activations.gelu_route(x) == "vec"
    assert activations.gelu_route(x[:13]) == "vec"
    assert activations.gelu_route(x[1:]) == "scalar"
    assert activations.gelu_route(x, x[8:]) == "vec"
    assert activations.gelu_route(x, x[4:]) == "scalar"
    f = torch.zeros(64)
    assert activations.gelu_route(f[4:], f) == "vec"
    assert activations.gelu_route(f[2:], f) == "scalar"
