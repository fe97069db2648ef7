"""Spectral primitives of the port (counterpart of `basd_tpu/spectral`)."""

from basd_tpu_torch.spectral.ops import (  # noqa: F401
    grassmann_basis,
    marchenko_pastur_rank,
    marchenko_pastur_rank_gram,
    masked_principal_angle_distance,
    nuclear_norm,
    nuclear_norm_gram,
    nuclear_norm_ns,
    nuclear_norm_pair,
    nuclear_norm_pair_gram,
    svdvals_psd,
    topk_basis,
    topk_basis_gram,
    topk_basis_gram_nograd,
)
