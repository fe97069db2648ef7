"""Data layer of the port (counterpart of `basd_tpu/data`)."""

from basd_tpu_torch.data.datasets import (  # noqa: F401
    dataset_info,
    get_channel_stats,
    get_subset_indices,
    iter_split_samples,
    load_split_arrays,
)
