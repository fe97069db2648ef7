"""Device ops of the port (counterpart of `basd_tpu/ops`)."""
