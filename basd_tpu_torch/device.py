"""Device resolution for the port's entry points, and the step's device
constants."""

from __future__ import annotations

import functools
import subprocess

import torch

# every device constant made so far, by (builder, its arguments)
CONSTANTS: dict[tuple, torch.Tensor] = {}


def device_constant(build):
    """Decorate `build(*args)`, whose last argument is a torch.device, to
    make its tensor once per arguments and return that same tensor on every
    later call (callers only read it). The copy from the host happens at
    the first call, so a train step that has run once copies nothing more:
    a CUDA graph cannot capture a copy from pageable host memory."""

    @functools.wraps(build)
    def cached(*args):
        key = (build.__name__, *args)
        tensor = CONSTANTS.get(key)
        if tensor is None:
            tensor = CONSTANTS[key] = build(*args)
        return tensor

    return cached


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when None. Raises when CUDA is asked for
    and absent: nothing silently moves to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "basd_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain torch path"
        )
    return dev


def card_line(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, so a
    time stands beside the card that gave it; "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None else device.index
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip()
