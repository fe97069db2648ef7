"""Utilities of the port (counterpart of `basd_tpu/utils`)."""
