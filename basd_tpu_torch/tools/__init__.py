"""The port's tools, counterparts of the JAX package's `tools/*.py`: the
spectral and attention tuners (`tune_spectral`, `probe_jacobi_sweeps`,
`probe_attn_internals`), the train step's stage profiler (`profile_step`),
the attribution probes (`probe_selector_internals`, `probe_loss_tail`,
`probe_step_gap`, `probe_teacher_block`, `probe_student_bwd`,
`probe_dualview`, `probe_ns_precision`), the kernels' start-up check
standalone (`smoke_kernels`) and the kernels' A/B timers (`time_jacobi`,
`time_warp`, `time_attn_probe`, `time_mp_rank`). Run each as `python -m
basd_tpu_torch.tools.<name>`; each runs on the CUDA card unless its `main`
is given `device="cpu"`, and takes its sizes as keyword arguments (the
tuners) or its JAX tool's command line and keyword sizes (the profiler and
the probes). `TEACHER_STATS` and `DATASET_STATS` are the normalisations
that `probe_step_gap` and `probe_selector_internals` stage with: the
teachers' ImageNet statistics and CIFAR-100's."""

TEACHER_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
DATASET_STATS = ((0.507, 0.487, 0.441), (0.267, 0.256, 0.276))
