"""Determinism and debugging switches; the port of `basd_tpu/utils/debug.py`.

  * NaN debugging: autograd anomaly detection (the backward op that made a
    NaN raises, with the forward's traceback),
  * numerics for triage: deterministic algorithms, and no TF32 in matmuls
    or cuDNN convolutions.

The port runs eagerly, so the JAX module's `disable_jit` and
`verbose_compiles` have no counterpart.
"""

from __future__ import annotations

import torch


def configure_debug(*, nan_checks: bool = False, deterministic: bool = False) -> None:
    if nan_checks:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
    if deterministic:
        torch.use_deterministic_algorithms(True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
