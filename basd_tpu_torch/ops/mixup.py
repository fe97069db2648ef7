"""On-device MixUp / CutMix with soft targets: the port of
`basd_tpu/ops/mixup.py`.

Each step picks ONE of the two transforms, with a single
lambda ~ Beta(alpha, alpha) for the whole batch, pairs each sample with
its roll-by-1 neighbour, and returns soft targets
lam * y + (1 - lam) * y_rolled (torchvision v2
`RandomChoice([MixUp(alpha=1), CutMix(alpha=1)])`). As in `augment`, a
sampler draws from a `torch.Generator` and `mixup_cutmix` is a
deterministic function of the draws. On a data-parallel rank the batch is
a slice of the global batch and the roll crosses the slice's first row:
`neighbour` gives it the sample before the slice (`parallel.mesh.data_shift`
of the previous rank's last one).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class MixDraws(NamedTuple):
    """Per-batch draws, each a 0-dim tensor."""

    use_cutmix: torch.Tensor  # bool, p = 0.5
    lam: torch.Tensor  # fp32 ~ Beta(alpha, alpha)
    box_y: torch.Tensor  # cutmix box centre row / H, uniform [0, 1)
    box_x: torch.Tensor  # cutmix box centre column / W, uniform [0, 1)


def sample_mixup(generator: torch.Generator, alpha: float = 1.0) -> MixDraws:
    """Beta(1, 1) is Uniform(0, 1); otherwise lam = X / (X + Y) with
    X, Y ~ Gamma(alpha) from the generator (`torch.distributions` takes no
    generator)."""
    dev = generator.device
    rand = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    use_cutmix = rand() < 0.5
    if alpha == 1.0:
        lam = rand()
    else:
        xy = torch._standard_gamma(
            torch.full((2,), alpha, device=dev), generator=generator)
        lam = xy[0] / (xy[0] + xy[1])
    box_y, box_x = rand(2).unbind()
    return MixDraws(use_cutmix, lam, box_y, box_x)


def mixup_cutmix(
    images: torch.Tensor,  # (B, H, W, C) float
    labels: torch.Tensor,  # (B,) int
    draws: MixDraws,
    *,
    num_classes: int,
    neighbour: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`neighbour`: (image (H, W, C), one-hot (C,)) of the sample that
    precedes row 0 in the global batch, where `images` is a slice of it;
    without it the roll wraps within `images`."""
    use_cutmix, lam, box_y, box_x = draws
    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    if neighbour is None:
        rolled_images = torch.roll(images, 1, dims=0)
        rolled_targets = torch.roll(onehot, 1, dims=0)
    else:
        rolled_images = torch.cat([neighbour[0][None].to(images.dtype), images[:-1]])
        rolled_targets = torch.cat([neighbour[1][None], onehot[:-1]])

    mixed_mixup = lam * images + (1.0 - lam) * rolled_images

    # cutmix: a box of area (1 - lam), centred uniformly, clipped to the image
    h, w = images.shape[1], images.shape[2]
    cut = torch.sqrt(1.0 - lam)
    ch, cw = cut * h, cut * w
    cy, cx = box_y * h, box_x * w
    y0 = torch.clamp(cy - ch / 2.0, 0.0, h)
    y1 = torch.clamp(cy + ch / 2.0, 0.0, h)
    x0 = torch.clamp(cx - cw / 2.0, 0.0, w)
    x1 = torch.clamp(cx + cw / 2.0, 0.0, w)
    yy = torch.arange(h, dtype=torch.float32, device=images.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=images.device)[None, :]
    box = ((yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1))[None, :, :, None]
    mixed_cutmix = torch.where(box, rolled_images, images)
    # the effective lambda of the clipped box (torchvision semantics)
    lam_cutmix = 1.0 - ((y1 - y0) * (x1 - x0)) / (h * w)

    images_out = torch.where(use_cutmix, mixed_cutmix, mixed_mixup)
    lam_eff = torch.where(use_cutmix, lam_cutmix, lam)
    targets = lam_eff * onehot + (1.0 - lam_eff) * rolled_targets
    return images_out, targets


def shard_neighbour(images: torch.Tensor, labels: torch.Tensor, num_classes: int,
                    mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The `neighbour` of this data rank's slice: the previous data rank's
    last image and one-hot label (the last rank's for rank 0), in one sum
    over the data group."""
    from basd_tpu_torch.parallel.mesh import data_shift

    last = torch.cat([images[-1].reshape(-1).float(),
                      F.one_hot(labels[-1].long(), num_classes).float()])
    prev = data_shift(last, mesh)
    return prev[:-num_classes].view_as(images[-1]).to(images.dtype), prev[-num_classes:]
