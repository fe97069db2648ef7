"""Host -> device input pipeline: shuffled epochs with device prefetch; the
port of `basd_tpu/data/pipeline.py`.

The host work is only batch slicing of uint8 arrays. Batches go to the
device through pinned host memory with `non_blocking=True`, `size` of them
in flight, so the copy of batch k+1 overlaps step k.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator

import numpy as np
import torch


def epoch_batches(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    rng: np.random.Generator,
    *,
    drop_last: bool = True,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Shuffled full batches; the same index order as the JAX package for
    the same generator. `images[idx]` is a fresh, writable copy even when
    `images` is a read-only memory map."""
    order = rng.permutation(len(labels))
    num_batches = len(labels) // batch_size
    for b in range(num_batches):
        idx = order[b * batch_size : (b + 1) * batch_size]
        yield images[idx], labels[idx]
    if not drop_last and len(labels) % batch_size:
        idx = order[num_batches * batch_size :]
        yield images[idx], labels[idx]


def to_device(batch: tuple[np.ndarray, ...], device) -> tuple[torch.Tensor, ...]:
    """numpy arrays -> tensors on `device`; to a CUDA device through pinned
    memory with a non-blocking copy. Labels become int64."""
    device = torch.device(device)
    out = []
    for a in batch:
        if not a.flags.writeable:  # a read-only memory-map view
            a = np.array(a)
        t = torch.from_numpy(a)
        if t.dtype == torch.int32:  # labels: the losses index with int64
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out.append(t)
    return tuple(out)


def prefetch_to_device(
    iterator: Iterator[tuple[np.ndarray, ...]],
    *,
    device,
    size: int = 2,
) -> Iterator[tuple[torch.Tensor, ...]]:
    """Keep `size` batches in flight to `device` (double buffering)."""
    queue: deque = deque()
    for batch in iterator:
        queue.append(to_device(batch, device))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
