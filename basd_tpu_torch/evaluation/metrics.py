"""Evaluation suite: in-distribution accuracy, OOD robustness transfer with
class-subset logit masking, and an efficiency micro-benchmark; the port of
`basd_tpu/evaluation/metrics.py`.

  * `evaluate_model`     -- top-1/top-5 (micro) + mean CE loss, optional
                           logit masking to a class subset; the sums stay
                           on the device and are fetched once per split
  * `measure_efficiency` -- params, forward GFLOPs (`count_flops`) and
                           throughput img/s on the model's device
  * `run_eval_suite`     -- primary + eval_datasets, OOD sets normalized
                           with the PRIMARY dataset's stats
  * `save_metrics`       -- metrics.json, the JAX package's schema

Top-5 counts a label as a hit when fewer than k logits rank before it,
where a logit ranks before the label's if it is greater, or equal at a
lower index: `jax.lax.top_k`'s tie rule, exact and deterministic
(`torch.topk` makes no promise on ties). Top-1 is `argmax`, which takes the
first maximum. The short tail batch runs at its own size (the JAX package
pads it to a static shape and masks the padding: the same sums).
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from basd_tpu_torch.data.datasets import (
    dataset_info,
    get_channel_stats,
    get_subset_indices,
    load_split_arrays,
)
from basd_tpu_torch.data.pipeline import to_device
from basd_tpu_torch.ops.preprocess import eval_view


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _forward(model, params: Mapping[str, torch.Tensor] | None, x: torch.Tensor):
    """The model's logits on `x` at `params` (the model's own weights when
    None), without touching the model's parameters."""
    if params is None:
        return model(x, train=False).logits
    return functional_call(model, dict(params), (x,), {"train": False}).logits


def topk_hits(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) bool: the label is among the top k logits, ties broken by the
    lower index (`jax.lax.top_k`'s rule)."""
    own = logits.gather(1, labels[:, None])
    idx = torch.arange(logits.shape[1], device=logits.device)
    before = (logits > own) | ((logits == own) & (idx[None, :] < labels[:, None]))
    return before.sum(dim=1) < k


@torch.no_grad()
def evaluate_model(
    model: torch.nn.Module,
    params: Mapping[str, torch.Tensor] | None,
    images_u8: np.ndarray,
    labels: np.ndarray,
    *,
    img_size: int,
    crop_ratio: float,
    mean,
    std,
    batch_size: int,
    valid_indices: tuple[int, ...] | None = None,
    label_smoothing: float = 0.0,
) -> dict[str, Any]:
    """top-1/top-5 accuracy (micro) + mean CE loss over a split, on the
    model's device."""
    device = _device_of(model)
    mean = tuple(float(m) for m in mean)
    std = tuple(float(s) for s in std)
    valid = (torch.as_tensor(valid_indices, dtype=torch.long, device=device)
             if valid_indices is not None else None)
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    top1 = torch.zeros((), dtype=torch.long, device=device)
    top5 = torch.zeros((), dtype=torch.long, device=device)
    n = len(labels)
    for lo in range(0, n, batch_size):
        imgs, labs = to_device((images_u8[lo : lo + batch_size],
                                labels[lo : lo + batch_size]), device)
        x = eval_view(imgs, img_size, crop_ratio, mean, std)
        logits = _forward(model, params, x)
        if valid is not None:
            logits = logits[:, valid]
        logp = F.log_softmax(logits.float(), dim=-1)
        c = logits.shape[-1]
        smoothed = (1.0 - label_smoothing) * F.one_hot(labs, c) + label_smoothing / c
        loss_sum -= (smoothed * logp).sum()
        top1 += (logits.argmax(dim=-1) == labs).sum()
        top5 += topk_hits(logits, labs, min(5, c)).sum()
    loss_sum, top1, top5 = (float(v) for v in torch.stack(
        [loss_sum.double(), top1.double(), top5.double()]).cpu())
    return {
        "val_acc": 100.0 * top1 / n,
        "val_acc_top5": 100.0 * top5 / n,
        "loss": loss_sum / n,
    }


def count_flops(model: torch.nn.Module, image_size: int, in_channels: int = 3) -> int:
    """Forward FLOPs of one image: `torch.utils.flop_counter.FlopCounterMode`
    on a CPU copy of the model at batch 1, so the count is the same
    whatever device the model is on (on the card the hand-written kernels'
    products would be invisible to it). It counts the matrix products and
    convolutions (2 per multiply-add: the patch embedding, qkv, QK^T, PV,
    proj, the MLP and the head of a ViT) and nothing elementwise, so it is
    not XLA's `cost_analysis` count, which the JAX package reports."""
    from torch.utils.flop_counter import FlopCounterMode

    cpu = copy.deepcopy(model).to("cpu")
    x = torch.zeros((1, image_size, image_size, in_channels))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        cpu(x, train=False)
    return int(counter.get_total_flops())


@torch.no_grad()
def measure_efficiency(
    model: torch.nn.Module,
    params: Mapping[str, torch.Tensor] | None = None,
    *,
    image_size: int,
    in_channels: int = 3,
    batch_size: int = 64,
    num_warmup: int = 50,
    num_batches: int = 200,
) -> dict[str, float]:
    """Params (M), forward GFLOPs (`count_flops`), and steady-state
    throughput img/s: `num_batches` forwards of a zero batch after
    `num_warmup`, timed by CUDA events on the card (the host clock on the
    CPU)."""
    tensors = list(params.values()) if params is not None else list(model.parameters())
    param_count = sum(int(t.numel()) for t in tensors)
    gflops = count_flops(model, image_size, in_channels) / 1e9

    device = _device_of(model)
    batch = torch.zeros((batch_size, image_size, image_size, in_channels),
                        device=device)
    for _ in range(max(num_warmup, 1)):
        _forward(model, params, batch)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(num_batches):
            _forward(model, params, batch)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(num_batches):
            _forward(model, params, batch)
        seconds = time.perf_counter() - t0
    return {
        "param_count": param_count,
        "param_count_m": param_count / 1e6,
        "gflops": gflops,
        "throughput_img_per_sec": batch_size * num_batches / seconds,
    }


def run_eval_suite(
    model: torch.nn.Module,
    params: Mapping[str, torch.Tensor] | None,
    config,
    *,
    config_path: str,
) -> dict[str, Any]:
    """Primary + OOD robustness + efficiency. OOD sets use the PRIMARY
    dataset's channel stats; subset datasets get logit masking."""
    datasets_to_eval = [config.data.dataset] + list(config.data.eval_datasets)
    mean, std = get_channel_stats(config.data.dataset)
    crop_ratio = config.data.eval_crop_ratio
    img_size = config.model.vit.img_size

    primary_results: dict = {}
    robustness_results: dict = {}

    for ds_name in datasets_to_eval:
        info = dataset_info(ds_name)
        images, labels = load_split_arrays(ds_name, info["eval_split"], img_size)
        valid_indices = get_subset_indices(ds_name, config.data.dataset)
        metrics = evaluate_model(
            model, params, images, labels,
            img_size=img_size, crop_ratio=crop_ratio, mean=mean, std=std,
            batch_size=config.data.batch_size, valid_indices=valid_indices,
        )
        if ds_name == config.data.dataset:
            primary_results = metrics
        else:
            robustness_results[ds_name] = metrics
        print(
            f"eval {ds_name} "
            f"top1={metrics['val_acc']:.4f} top5={metrics['val_acc_top5']:.4f} "
            f"loss={metrics['loss']:.6f}"
        )

    eval_cfg = config.get("evaluation", {}) or {}
    efficiency = measure_efficiency(
        model, params,
        image_size=img_size,
        batch_size=eval_cfg.get("efficiency_batch_size", 64),
        num_warmup=eval_cfg.get("efficiency_warmup", 50),
        num_batches=eval_cfg.get("efficiency_batches", 200),
    )
    print(
        f"efficiency params_m={efficiency['param_count_m']:.4f} "
        f"gflops={efficiency['gflops']:.4f} "
        f"throughput={efficiency['throughput_img_per_sec']:.2f} img/s"
    )

    return {
        "run": {"name": config.run.name, "config": config_path},
        "primary": {"dataset": config.data.dataset, **primary_results},
        "robustness": robustness_results,
        "efficiency": efficiency,
    }


def save_metrics(results: dict[str, Any], output_dir: Path | str) -> Path:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    metrics_path = output_dir / "metrics.json"
    with open(metrics_path, "w") as f:
        json.dump(results, f, indent=2)
    return metrics_path
