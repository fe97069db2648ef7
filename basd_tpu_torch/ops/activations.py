"""Exact (erf) GELU with the JAX package's precision contract: math in
fp32, result in the input dtype. (`basd_tpu/ops/activations.py` computes
the same function through tanh, a TPU lowering device.)"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float()).to(x.dtype)
