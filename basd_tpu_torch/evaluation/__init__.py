"""Evaluation of the port (counterpart of `basd_tpu/evaluation`)."""

from basd_tpu_torch.evaluation.metrics import (  # noqa: F401
    evaluate_model,
    measure_efficiency,
    run_eval_suite,
    save_metrics,
)
