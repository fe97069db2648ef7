"""The port stands alone: no module of `basd_tpu_torch` (nor
`chip_smoke.py`) imports JAX, flax, optax or the JAX package; entry points
refuse to fall back to the CPU silently; kernel wrappers give a non-CPU
tensor to the kernel or raise, never to the plain version."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import basd_tpu_torch
from basd_tpu_torch.ops import attention as tattn
from basd_tpu_torch.ops import warp_kernel as twarp
from basd_tpu_torch.spectral import jacobi as tjacobi
from basd_tpu_torch.spectral import jacobi_kernel

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "basd_tpu_torch"


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], "basd_tpu_torch.")
    )


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax') or n == 'basd_tpu' or "
        "n.startswith('basd_tpu.'))\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 54  # every module was imported


def test_importing_every_module_needs_no_yaml_pil_datasets_orbax_or_flax():
    """The card machine has none of these: with each blocked, every module
    of the port still imports (the Hugging Face branch imports `datasets`
    and `PIL` only when a Hugging Face dataset is loaded)."""
    blocked = ("yaml", "PIL", "datasets", "orbax", "flax")
    code = (
        "import importlib, sys\n"
        f"for name in {blocked!r}: sys.modules[name] = None\n"
        f"mods = {_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) == len(_modules()) >= 54


def test_sources_never_name_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|basd_tpu)(\.|\s|$)", re.M
    )
    files = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        text = f.read_text()
        assert not pattern.search(text), f
        assert "import jax" not in text, f
        assert "basd_tpu." not in text.replace("basd_tpu_torch", ""), f


@pytest.mark.parametrize("name", ["warp_kernel", "mixup", "augment"])
def test_augment_modules_never_name_jax(name):
    text = (PKG / "ops" / f"{name}.py").read_text()
    assert not re.search(r"\bjax\b", text)
    assert "basd_tpu." not in text.replace("basd_tpu_torch", "")


def test_entry_points_default_to_cuda_and_refuse_without_it():
    from basd_tpu_torch.losses import init_selector
    from basd_tpu_torch.models import create_student, load_teacher

    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_student("vit_micro_patch4", num_classes=10, drop_path_rate=0.0,
                       img_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_teacher("vit_micro_patch4", img_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_selector(0, 2, 64, 96)


def test_train_and_evaluate_default_to_cuda_and_refuse_without_it(tmp_path):
    from basd_tpu_torch import evaluate, train

    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    argv = ["experiment=basd_smoke", f"run.output_dir={tmp_path}"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.main([*argv, f"checkpoint.path={tmp_path / 'w.npz'}"])


def _forbid(monkeypatch, module, name):
    def boom(*a, **k):
        raise AssertionError(f"{name} ran for a non-CPU tensor")

    monkeypatch.setattr(module, name, boom)


def test_wrappers_never_route_a_device_tensor_to_the_plain_version(monkeypatch):
    """A tensor on another device (`meta` here) raises in the wrapper; the
    plain version is never called for it."""
    _forbid(monkeypatch, tattn, "attention_forward_plain")
    _forbid(monkeypatch, tattn, "attention_backward_plain")
    _forbid(monkeypatch, tjacobi, "jacobi_eigh")
    _forbid(monkeypatch, twarp, "geometric_warp_plain")
    x = torch.empty((2, 65, 192), device="meta")
    s = torch.empty((2, 65, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tattn.attention_forward(x, x, x, 64)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tattn.attention_backward(x, x, x, x, s, s, s, 64)
    with pytest.raises(ValueError, match="cuda or cpu"):
        jacobi_kernel.kernel_jacobi_eigh(torch.empty((4, 48, 48), device="meta"))
    p = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        twarp.fused_geometric_warp(torch.empty((2, 32, 32, 3), device="meta"),
                                   p, p, p, p, p)


def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    """The CUDA-side checks run before any library is loaded."""
    q = torch.zeros((2, 600, 128))  # N > 512: outside the kernel gate
    with pytest.raises(ValueError, match="does not take"):
        tattn._attention_forward_cuda(q, q, q, 64)
    h = torch.zeros((2, 65, 192), dtype=torch.float16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        tattn._attention_forward_cuda(h, h, h, 64)
    # bf16 loads 16-byte pieces: a view 2 bytes into its storage, or one
    # whose row stride is not a multiple of 8 elements, raises
    qkv = torch.zeros((2, 65, 3 * 192 + 8), dtype=torch.bfloat16)
    q, k, v = qkv[..., 1:193], qkv[..., 193:385], qkv[..., 385:577]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn._attention_forward_cuda(q, k, v, 64)
    rows = torch.zeros((2, 65, 196), dtype=torch.bfloat16)[..., :192]
    s = torch.zeros((2, 65, 3))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn._attention_backward_cuda(rows, rows, rows, rows, s, s, s, 64)
    # the model's views of one (B, N, 3D) tensor are aligned: fp32 takes
    # any view (its CUDA-core kernels load element by element)
    aligned = qkv[..., 8:200]
    tattn._check_cuda((aligned,) * 3, "qkv", 64)
    tattn._check_cuda((q.float(),) * 3, "qkv", 64)
    with pytest.raises(ValueError, match="even"):
        jacobi_kernel._jacobi_raw_cuda(torch.zeros((4, 33, 33)), 6)
    with pytest.raises(ValueError, match="fp32"):
        jacobi_kernel._jacobi_raw_cuda(torch.zeros((4, 32, 32), dtype=torch.float64), 6)
    params = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="fp32"):
        twarp._warp_cuda(torch.zeros((2, 32, 32, 3), dtype=torch.float64), params)
    with pytest.raises(ValueError, match="square"):
        twarp._warp_cuda(torch.zeros((2, 32, 24, 3)), params)
    with pytest.raises(ValueError, match=f"n <= {twarp.MAX_N}"):
        twarp._warp_cuda(torch.zeros((2, 241, 241, 1)), params)
    with pytest.raises(ValueError, match="contiguous"):
        twarp._warp_cuda(torch.zeros((2, 3, 32, 32)).permute(0, 2, 3, 1), params)
    with pytest.raises(ValueError, match="params"):
        twarp._warp_cuda(torch.zeros((2, 32, 32, 3)), torch.zeros((2, 7)))


def test_package_docstring_states_the_device_rule():
    assert "CUDA" in basd_tpu_torch.__doc__ and "CPU" in basd_tpu_torch.__doc__


def test_slice3_wrappers_never_route_a_device_tensor_to_the_plain_version(
        monkeypatch):
    """K5 and K6: a `meta` tensor raises in the wrapper; the plain version
    is never called for it."""
    from basd_tpu_torch.ops import attn_probe

    _forbid(monkeypatch, tjacobi, "jacobi_eigvals")
    _forbid(monkeypatch, attn_probe, "probe_attention_plain")
    with pytest.raises(ValueError, match="cuda or cpu"):
        jacobi_kernel.kernel_jacobi_eigvals(torch.empty((4, 48, 48), device="meta"))
    x = torch.empty((8, 2, 17, 16), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        attn_probe.probe_attention(x, x, x, variant="full")


def test_slice3_cuda_wrappers_reject_what_the_kernels_do_not_take():
    """The CUDA-side checks of K3's packed_log route, K5 and K6 run
    before any library is loaded."""
    from basd_tpu_torch.ops import attn_probe

    big = jacobi_kernel.MAX_N + 2
    with pytest.raises(ValueError, match=f"n <= {jacobi_kernel.MAX_N}"):
        jacobi_kernel._jacobi_raw_cuda(torch.zeros((1, big, big)), 6)
    with pytest.raises(ValueError, match="even"):
        jacobi_kernel._jacobi_eigvals_raw_cuda(torch.zeros((4, 191, 191)), 9)
    with pytest.raises(ValueError, match="fp32"):
        jacobi_kernel._jacobi_eigvals_raw_cuda(
            torch.zeros((4, 192, 192), dtype=torch.float64), 9)
    q = torch.zeros((8, 2, 17, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        attn_probe._probe_cuda(q.float(), q.float(), q.float(), "full", 8)
    h16 = torch.zeros((8, 2, 17, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hd = 64"):
        attn_probe._probe_cuda(h16, h16, h16, "full", 8)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2)
        attn_probe._probe_cuda(t, t, t, "full", 8)
    with pytest.raises(ValueError, match="group"):
        attn_probe._probe_cuda(q[:6], q[:6], q[:6], "tilemax", 8)
    with pytest.raises(ValueError, match="variant"):
        attn_probe._probe_cuda(q, q, q, "softmax", 8)


def test_every_kernel_has_a_launch_counter_and_a_library():
    from basd_tpu_torch import kernels

    assert set(kernels.LAUNCHES) == {
        "attention_fwd", "attention_bwd", "jacobi_eigh", "warp",
        "jacobi_eigvals", "attn_probe"}
    for name in kernels._SIGNATURES:
        assert (kernels.CSRC / f"{name}.cu").exists(), name
