"""The port's spectral and attention tuning tools (counterparts of the
JAX package's `tools/tune_spectral.py`, `tools/probe_jacobi_sweeps.py` and
`tools/probe_attn_internals.py`), and its kernel start-up check standalone
(`smoke_kernels`, the counterpart of `tools/smoke_kernels.py`). Run each as
`python -m basd_tpu_torch.tools.<name>`; each tuning tool's `main(...)`
takes `device=` (the CUDA card by default) and its sizes as keyword
arguments, `smoke_kernels.main` its command line."""
