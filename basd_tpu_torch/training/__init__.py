"""Training of the port (counterpart of `basd_tpu/training`)."""
