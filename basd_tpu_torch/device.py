"""Device resolution for the port's entry points."""

from __future__ import annotations

import subprocess

import torch


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
