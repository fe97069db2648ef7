"""Device resolution for the port's entry points."""

from __future__ import annotations

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
