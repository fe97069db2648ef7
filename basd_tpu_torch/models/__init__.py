"""Models of the port (counterpart of `basd_tpu/models`): ViT students and
teachers, CNN teachers, and the student's sizing from its teacher."""

from basd_tpu_torch.models.cnn import ConvNeXt, ConvNeXtConfig, ResNet, ResNetConfig  # noqa: F401
from basd_tpu_torch.models.factory import create_student, derive_student_arch  # noqa: F401
from basd_tpu_torch.models.specs import ModelSpec, resolve_preset  # noqa: F401
from basd_tpu_torch.models.teacher import (  # noqa: F401
    Teacher,
    estimate_intrinsic_dim,
    extract_intermediates,
    load_teacher,
)
from basd_tpu_torch.models.vit import VisionTransformer, ViTConfig  # noqa: F401
