"""BASD losses of the port (counterpart of `basd_tpu/losses`)."""

from basd_tpu_torch.losses.combined import (  # noqa: F401
    basd_loss,
    cross_entropy,
    extraction_points,
    uw_so_weights,
)
from basd_tpu_torch.losses.selector import (  # noqa: F401
    SelectorState,
    calibrate_subspace_k,
    init_selector,
    select_and_mix,
)
