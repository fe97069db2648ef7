"""Checkpointing: async saves, best/latest policy, resume; the port of
`basd_tpu/checkpoint/manager.py` with `torch.save` in place of orbax.

  * the full training state under `{output_dir}/{run}/checkpoints/{name}/`:
    `state.pt` (the student's y-point state dict, the ScheduleFree
    optimizer's state dict with z, v and step, the selector's
    log-temperatures and frozen projections, the step generator's state
    and `step`) and `custom.json` (epoch, best_val_acc, metrics_history,
    step_in_epoch, epoch_sums),
  * saves are ASYNC: `save_state` copies the state to host tensors
    synchronously (the step mutates it in place right after), then one
    background thread writes a temporary directory that one `os.replace`
    makes `name`; a previous `name` is first renamed aside and removed
    after, so at every moment one complete checkpoint is on disk and
    `restore_state` finds it,
  * a mid-epoch `latest` (`checkpoint.save_every_steps`) carries
    {step_in_epoch, running metric sums}, so a killed job resumes the same
    epoch and reproduces the uninterrupted run,
  * weights-only `.npz` exports of the student (the port's state-dict
    keys plus `__epoch__`) for evaluation, loaded strictly.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_STATE_FILE = "state.pt"
_CUSTOM_FILE = "custom.json"


def _to_host(obj: Any) -> Any:
    """A copy of `obj` with every tensor copied to the CPU (synchronous)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, Mapping):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _state_to_host(state) -> dict[str, Any]:
    """A `TrainState` as host tensors."""
    return {
        "student": _to_host(state.student.state_dict()),
        "optimizer": _to_host(state.optimizer.state_dict()),
        "selector": {
            "log_temperatures": _to_host(state.selector.log_temperatures),
            "proj_s": _to_host(state.selector.proj_s),
            "proj_t": _to_host(state.selector.proj_t),
        },
        "generator": state.generator.get_state(),
        "step": int(state.step),
    }


class CheckpointManager:
    def __init__(self, checkpoint_dir: Path | str):
        self.dir = Path(checkpoint_dir).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self._writer = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="checkpoint")
        self._pending: Future | None = None
        # host ms each save_state call held its caller (the epoch loop)
        self.blocked_ms: list[float] = []

    # -- full training state ------------------------------------------------

    def save_state(
        self,
        name: str,
        state,
        *,
        epoch: int,
        best_val_acc: float,
        metrics_history: dict,
        step_in_epoch: int | None = None,
        epoch_sums: dict | None = None,
        block: bool = False,
    ) -> Path:
        """Async atomic save of (state, metadata) under `name`.

        `step_in_epoch`/`epoch_sums` mark a MID-epoch checkpoint: resume
        restarts the same epoch at that batch offset with the recorded
        running metric sums."""
        t0 = time.perf_counter()
        path = self.dir / name
        self.wait()  # one write at a time; raises a failed earlier write
        host = _state_to_host(state)
        custom = {
            "epoch": epoch,
            "best_val_acc": best_val_acc,
            "metrics_history": metrics_history,
            "step_in_epoch": step_in_epoch,
            "epoch_sums": epoch_sums,
        }
        text = json.dumps(custom)  # serialized now: the caller's lists move on
        self._pending = self._writer.submit(self._write, path, host, text)
        if block:
            self.wait()
        self.blocked_ms.append((time.perf_counter() - t0) * 1e3)
        return path

    @staticmethod
    def _write(path: Path, host: dict, custom_text: str) -> None:
        tmp = path.with_name(f".{path.name}.tmp")
        old = path.with_name(f".{path.name}.old")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        torch.save(host, tmp / _STATE_FILE)
        (tmp / _CUSTOM_FILE).write_text(custom_text)
        if path.exists():
            shutil.rmtree(old, ignore_errors=True)
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)

    def wait(self) -> None:
        """Block until the enqueued save is durable; raise if it failed."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def _resolve(self, name_or_path: str | Path) -> Path:
        path = Path(name_or_path)
        if not path.is_absolute():
            path = self.dir / name_or_path
        if not path.exists():
            # a save stopped between its two renames leaves the previous
            # checkpoint renamed aside
            old = path.with_name(f".{path.name}.old")
            if old.exists():
                return old
            raise FileNotFoundError(f"no checkpoint at {path}")
        return path

    def restore_state(self, name_or_path: str | Path, state):
        """Load a saved training state into `state` (a `TrainState` of the
        same architecture) in place. Returns (state, custom) with custom =
        {epoch, best_val_acc, metrics_history, step_in_epoch, epoch_sums}."""
        path = self._resolve(name_or_path)
        saved = torch.load(path / _STATE_FILE, map_location="cpu",
                           weights_only=True)
        custom = json.loads((path / _CUSTOM_FILE).read_text())
        state.student.load_state_dict(saved["student"], strict=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        with torch.no_grad():
            for key, value in saved["selector"].items():
                getattr(state.selector, key).copy_(value)
        state.generator.set_state(saved["generator"])
        state.step = saved["step"]
        return state, custom

    # -- weights-only export (eval contract) --------------------------------

    def save_weights(self, filename: str, params: Mapping[str, torch.Tensor],
                     epoch: int) -> Path:
        """Flat `.npz` of a student state dict (the port's keys) with
        `__epoch__`."""
        flat = {k: v.detach().float().cpu().numpy() for k, v in params.items()}
        path = self.dir / filename
        np.savez(path, __epoch__=epoch, **flat)
        return path

    def load_weights(self, path: Path | str,
                     template: Mapping[str, torch.Tensor]):
        """A weights-only export as a state dict shaped and typed like
        `template`; returns (state_dict, epoch). A missing key, an extra key
        (another architecture) or a wrong shape raises."""
        with np.load(Path(path)) as z:
            flat = {k: z[k] for k in z.files if k != "__epoch__"}
            epoch = int(z["__epoch__"])
        out = {}
        for key, leaf in template.items():
            if key not in flat:
                raise ValueError(f"checkpoint is missing parameter '{key}'")
            arr = flat[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != {tuple(leaf.shape)}")
            out[key] = torch.from_numpy(arr).to(leaf.dtype)
        extra = sorted(set(flat) - set(template))
        if extra:
            # leftover parameters belong to a DIFFERENT architecture (e.g. a
            # deeper model whose early blocks happen to match shapes); the
            # config snapshot next to the checkpoint is the train/eval
            # contract
            raise ValueError(
                "checkpoint has parameters absent from the model "
                f"(architecture mismatch): {extra[:6]}"
                f"{'...' if len(extra) > 6 else ''}"
            )
        return out, epoch

    def close(self) -> None:
        """Drain the pending save and stop the writer thread."""
        self.wait()
        self._writer.shutdown(wait=True)
