"""Models of the port (counterpart of `basd_tpu/models`, ViT family)."""

from basd_tpu_torch.models.factory import create_student  # noqa: F401
from basd_tpu_torch.models.specs import ModelSpec, resolve_preset  # noqa: F401
from basd_tpu_torch.models.teacher import (  # noqa: F401
    Teacher,
    extract_intermediates,
    load_teacher,
)
from basd_tpu_torch.models.vit import VisionTransformer, ViTConfig  # noqa: F401
