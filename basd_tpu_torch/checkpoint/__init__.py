"""Checkpoints of the port (counterpart of `basd_tpu/checkpoint`)."""

from basd_tpu_torch.checkpoint.manager import CheckpointManager  # noqa: F401
