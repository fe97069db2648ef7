"""The kernels' start-up check (`basd_tpu_torch/utils/kernel_smoke.py`), its
CLI (`tools/smoke_kernels.py`) and the trainer's call, on the CPU: no
card here, so the check's logic runs against stand-in checks on a
CUDA-typed device, and each real check runs on the CPU's plain versions."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from basd_tpu_torch import kernels
from basd_tpu_torch.tools import smoke_kernels
from basd_tpu_torch.training import trainer as trainer_mod
from basd_tpu_torch.utils import kernel_smoke as ks
from test_torch_isolation import _modules
from test_torch_trainer import _port_trainer, _data

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CARD = torch.device("cuda", 0)  # a CUDA-typed device; the stand-ins never touch it


def _stand_ins(monkeypatch, failing=None):
    """Replace the eight checks by stand-ins that record their calls and
    count one launch each under their kernel's name (as the real checks
    launch); `failing` raises ValueError instead. Forget earlier checks."""
    calls = []

    def make(name):
        def check(device):
            calls.append((name, device))
            if name == failing:
                raise ValueError(f"{name} injected failure")
            kernels.LAUNCHES["warp" if name == "warp" else "attention_fwd"] += 1
            return "stand-in ok"
        return check

    monkeypatch.setattr(ks, "KERNEL_CHECKS", tuple((n, make(n)) for n, _ in ks.KERNEL_CHECKS))
    monkeypatch.setattr(ks, "_VALIDATED", set())
    return calls


def test_cpu_returns_at_once_and_launches_nothing(monkeypatch):
    calls = _stand_ins(monkeypatch)
    before = dict(kernels.LAUNCHES)
    got = ks.validate_kernel_dispatches(torch.device("cpu"))
    assert got == dict.fromkeys(kernels.LAUNCHES, 0)
    assert kernels.LAUNCHES == before and calls == []


def test_failing_check_raises_naming_the_kernel_and_switches_nothing(monkeypatch, capsys):
    calls = _stand_ins(monkeypatch, failing="warp")
    env = dict(os.environ)
    with pytest.raises(RuntimeError, match=r"warp: ValueError: warp injected failure") as err:
        ks.validate_kernel_dispatches(CARD)
    assert isinstance(err.value.__cause__, ValueError)
    assert str(err.value).count("Error:") == 1  # only the failing kernel is named
    # every check ran, the failing one reported, nothing was switched
    assert [n for n, _ in calls] == ["attention", "attention_bwd", "warp", "jacobi", "mp_rank",
                                     "swiglu_gate", "rope_qk", "layernorm"]
    assert all(d == CARD for _, d in calls)
    assert dict(os.environ) == env
    out = capsys.readouterr().out
    assert "kernel_smoke warp FAILED (ValueError" in out
    assert "kernel_smoke jacobi ok, stand-in ok" in out
    assert "kernel_smoke mp_rank ok, stand-in ok" in out
    assert "kernel_smoke swiglu_gate ok, stand-in ok" in out
    assert "kernel_smoke rope_qk ok, stand-in ok" in out
    assert "kernel_smoke layernorm ok, stand-in ok" in out
    # not marked as checked: the next call checks again
    with pytest.raises(RuntimeError, match="warp"):
        ks.validate_kernel_dispatches(CARD, verbose=False)
    assert len(calls) == 16


def test_passing_checks_return_their_launches_once_per_device(monkeypatch):
    calls = _stand_ins(monkeypatch)
    before = dict(kernels.LAUNCHES)
    got = ks.validate_kernel_dispatches(CARD, verbose=False)
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update(attention_fwd=7, warp=1)
    assert got == want
    assert {n: kernels.LAUNCHES[n] - before[n] for n in before} == want
    # once per process and device: a second call checks nothing
    assert ks.validate_kernel_dispatches(CARD) == dict.fromkeys(kernels.LAUNCHES, 0)
    assert len(calls) == 8
    ks.validate_kernel_dispatches(torch.device("cuda", 1), verbose=False)
    assert len(calls) == 16


@pytest.mark.parametrize("name", [n for n, _ in ks.KERNEL_CHECKS])
def test_each_check_runs_on_the_plain_versions(name):
    """On the CPU each check's kernel side is the plain version, so each
    reads exact agreement: this runs the checks' own shapes and plumbing."""
    check = dict(ks.KERNEL_CHECKS)[name]
    before = dict(kernels.LAUNCHES)
    got = check(torch.device("cpu"))
    assert got in ("bit for bit", f"rel err 0 (tol {ks.BF16_ATTENTION_TOL})"), got
    assert kernels.LAUNCHES == before


def test_cli_on_the_cpu_has_nothing_to_check():
    out = subprocess.run(
        [sys.executable, "-m", "basd_tpu_torch.tools.smoke_kernels", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "nothing to check" in out.stdout


@pytest.mark.parametrize("failing", [None, "jacobi"])
def test_cli_prints_one_line_per_kernel_and_exits_1_on_a_failure(monkeypatch, capsys,
                                                                  failing):
    _stand_ins(monkeypatch, failing=failing)
    monkeypatch.setattr(smoke_kernels, "resolve_device", lambda device: CARD)
    rc = smoke_kernels.main([])
    out = capsys.readouterr().out.splitlines()
    names = [n for n, _ in ks.KERNEL_CHECKS]
    assert [line.split()[1].rstrip(":") for line in out[:len(names)]] == names
    assert [line.split()[0] for line in out[:len(names)]] == [
        "FAIL" if n == failing else "PASS" for n in names]
    assert out[-1] == ("SOME FAILED" if failing else "ALL PASS")
    assert rc == (1 if failing else 0)


def test_trainer_runs_the_check_on_its_device_before_building(monkeypatch, tmp_path):
    """A failing check raises out of `Trainer.__init__` before the selector
    is drawn; nothing falls back."""
    seen, drawn = [], []

    def failing(device, *, verbose=True):
        seen.append(device)
        raise RuntimeError("kernel check on cuda:0 failed: warp: injected")

    monkeypatch.setattr(trainer_mod, "validate_kernel_dispatches", failing)
    monkeypatch.setattr(trainer_mod, "init_selector",
                        lambda *a, **k: drawn.append(a) or pytest.fail("selector drawn"))
    with pytest.raises(RuntimeError, match="warp"):
        _port_trainer(tmp_path)
    assert seen == [torch.device("cpu")] and drawn == []


def test_trainer_on_the_cpu_checks_nothing_and_steps(tmp_path):
    trainer = _port_trainer(tmp_path)
    assert trainer.kernel_check_launches == dict.fromkeys(kernels.LAUNCHES, 0)
    (images, labels), _ = _data()
    x = torch.from_numpy(images[:16])
    y = torch.from_numpy(labels[:16]).long()
    state, metrics = trainer._step(trainer.state, x, y)
    assert state.step == 1 and torch.isfinite(metrics["loss"])


def test_every_jax_module_has_a_counterpart_and_the_isolation_test_sees_them():
    """After this slice every module of `basd_tpu` has a namesake in the
    port, but for the Pallas kernel module, whose counterpart holds the
    CUDA kernel's wrappers; the isolation test's walk finds the new ones."""
    jax_mods = sorted(m.name.split(".", 1)[1] for m in
                      pkgutil.walk_packages([str(ROOT / "basd_tpu")], "basd_tpu."))
    port = {m.split(".", 1)[1] for m in _modules()}
    renamed = {"spectral.pallas_jacobi": "spectral.jacobi_kernel"}
    assert [m for m in jax_mods if renamed.get(m, m) not in port] == []
    assert {"spectral.reference", "utils.kernel_smoke", "tools.smoke_kernels"} <= port
