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

On a CUDA device without a mesh (`eval_route`) each full batch of
`evaluate_model` replays one captured CUDA graph of `eval_view`, the
forward and the loss and hit sums, accumulated on the device, and
`measure_efficiency` times replays of a captured forward: the counterparts
of the JAX package's cached jitted eval step and its jitted forward. The
graphs read the parameters from static buffers that each call refills, and
live in an LRU cache of 8 keyed on the model (a weak reference), the batch
shape, `valid_indices` and the view's settings, as the JAX package keeps
its jitted steps (`device.CapturedCall`: the first call of a graph is an
eager warm-up, the second captures). A graph gives the eager path's bits.

Top-5 counts a label as a hit when fewer than k logits rank before it,
where a logit ranks before the label's if it is greater, or equal at a
lower index: `jax.lax.top_k`'s tie rule, exact and deterministic
(`torch.topk` makes no promise on ties). Top-1 is `argmax`, which takes the
first maximum. The short tail batch runs at its own size (the JAX package
pads it to a static shape and masks the padding: the same sums).

Over a mesh (`parallel/mesh.py`, the JAX package's `sharding` argument)
each data rank evaluates its slice of every batch (the tail's slices of
uneven sizes, `shard_rows`) and the loss and hit sums are summed over the
data group; the efficiency measurement runs on rank 0 on the one-process
student and is broadcast.
"""

from __future__ import annotations

import copy
import json
import time
import weakref
from collections import OrderedDict
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
from basd_tpu_torch.device import CapturedCall
from basd_tpu_torch.ops.preprocess import eval_view
from basd_tpu_torch.parallel.mesh import (
    broadcast_,
    data_all_reduce,
    main_print,
    shard_rows,
)
from basd_tpu_torch.parallel.sharding_rules import full_module


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


def eval_route(device, mesh=None) -> tuple[str, str]:
    """("graph" | "eager", reason): how `evaluate_model` runs its batches
    and `measure_efficiency` its forwards on `device`."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "eager", f"{dev.type}: the plain versions, op by op"
    if mesh is not None:
        return "eager", ("a mesh: each rank evaluates its slices of every batch and "
                         "the sums meet in a host collective")
    return "graph", ("one CUDA graph per full batch (eval_view, the forward, the loss "
                     "and hit sums on the device) and per efficiency forward; the "
                     "short tail eager at its own size")


_EVAL_GRAPH_CACHE: OrderedDict = OrderedDict()
_EVAL_CACHE_MAX = 8


class _EvalGraph:
    """One cached evaluation graph: `fn(params, *inputs)` captured over
    static parameter and input buffers (`device.CapturedCall`), and `sums`,
    the (loss, top-1, top-5) accumulators that the eval batch adds into."""

    def __init__(self, fn, params_like, inputs_like, device, sums=None):
        self.params = {k: torch.empty_like(v) for k, v in params_like.items()}
        self.inputs = tuple(torch.empty_like(x) for x in inputs_like)
        self.sums = sums
        self.call = CapturedCall(lambda: fn(self.params, *self.inputs), device)

    def load_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Copy this call's parameters into the static buffers the graph reads."""
        if params.keys() != self.params.keys():
            raise ValueError("the evaluation graph was captured for other parameter names")
        with torch.no_grad():
            for key, value in params.items():
                self.params[key].copy_(value)

    def __call__(self, *inputs):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        return self.call()


def _cached_eval_graph(model, key, build) -> _EvalGraph:
    """The graph cached for (model, key), else `build()`'s; the least
    recently used beyond 8, and any whose model is gone, are dropped."""
    for stale in [k for k in _EVAL_GRAPH_CACHE if k[0]() is None]:
        del _EVAL_GRAPH_CACHE[stale]
    key = (weakref.ref(model), key)
    graph = _EVAL_GRAPH_CACHE.get(key)
    if graph is None:
        graph = _EVAL_GRAPH_CACHE[key] = build()
        while len(_EVAL_GRAPH_CACHE) > _EVAL_CACHE_MAX:
            _EVAL_GRAPH_CACHE.popitem(last=False)
    else:
        _EVAL_GRAPH_CACHE.move_to_end(key)
    return graph


def _eval_batch(model, params, imgs, labs, sums, *, view, valid, label_smoothing) -> None:
    """Add one batch's smoothed CE loss and top-1/top-5 hits into `sums` =
    (loss_sum, top1, top5), in place on the device."""
    logits = _forward(model, params, eval_view(imgs, *view))
    if valid is not None:
        logits = logits[:, valid]
    logp = F.log_softmax(logits.float(), dim=-1)
    c = logits.shape[-1]
    smoothed = (1.0 - label_smoothing) * F.one_hot(labs, c) + label_smoothing / c
    loss_sum, top1, top5 = sums
    loss_sum -= (smoothed * logp).sum()
    top1 += (logits.argmax(dim=-1) == labs).sum()
    top5 += topk_hits(logits, labs, min(5, c)).sum()


def _zero_sums(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.long, device=device),
            torch.zeros((), dtype=torch.long, device=device))


@torch.no_grad()
def eager_eval_sums(model, params, images_u8, labels, *, img_size, crop_ratio, mean,
                    std, batch_size, valid_indices=None, label_smoothing=0.0,
                    mesh=None) -> torch.Tensor:
    """(loss_sum, top1, top5) as float64 on the device, every batch op by
    op: the CPU's and a mesh's path (this rank's slices), and what the
    graph route is held against."""
    device = _device_of(model)
    view = (img_size, crop_ratio, tuple(float(m) for m in mean),
            tuple(float(s) for s in std))
    valid = (torch.as_tensor(valid_indices, dtype=torch.long, device=device)
             if valid_indices is not None else None)
    sums = _zero_sums(device)
    n = len(labels)
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        if mesh is not None:
            a, b = shard_rows(hi - lo, mesh.data, mesh.data_index)
            lo, hi = lo + a, lo + b
            if lo == hi:
                continue
        imgs, labs = to_device((images_u8[lo:hi], labels[lo:hi]), device)
        _eval_batch(model, params, imgs, labs, sums, view=view, valid=valid,
                    label_smoothing=label_smoothing)
    return torch.stack([s.double() for s in sums])


@torch.no_grad()
def graph_eval_sums(model, params, images_u8, labels, *, img_size, crop_ratio, mean,
                    std, batch_size, valid_indices=None,
                    label_smoothing=0.0) -> torch.Tensor:
    """`eager_eval_sums`'s result, each full batch a replay of the cached
    graph for this (model, batch shape, valid_indices, view, smoothing)
    and the short tail eager at its own size, into the same device sums."""
    device = _device_of(model)
    view = (img_size, crop_ratio, tuple(float(m) for m in mean),
            tuple(float(s) for s in std))
    n = len(labels)
    full = n - n % batch_size
    if full == 0:
        return eager_eval_sums(model, params, images_u8, labels, img_size=img_size,
                               crop_ratio=crop_ratio, mean=mean, std=std,
                               batch_size=batch_size, valid_indices=valid_indices,
                               label_smoothing=label_smoothing)
    params = dict(model.named_parameters()) if params is None else dict(params)
    first = to_device((images_u8[:batch_size], labels[:batch_size]), device)
    if valid_indices is not None:
        valid_indices = tuple(int(i) for i in valid_indices)

    def valid_tensor():
        return (torch.as_tensor(valid_indices, dtype=torch.long, device=device)
                if valid_indices is not None else None)

    def build() -> _EvalGraph:
        sums = _zero_sums(device)
        valid = valid_tensor()
        owner = weakref.ref(model)  # the cache must not keep the model alive

        def batch(static_params, imgs, labs):
            _eval_batch(owner(), static_params, imgs, labs, sums, view=view,
                        valid=valid, label_smoothing=label_smoothing)

        return _EvalGraph(batch, params, first, device, sums=sums)

    key = ("eval", tuple(first[0].shape), first[0].dtype, valid_indices, view,
           float(label_smoothing))
    graph = _cached_eval_graph(model, key, build)
    graph.load_params(params)
    for s in graph.sums:
        s.zero_()
    for lo in range(0, full, batch_size):
        batch = first if lo == 0 else to_device(
            (images_u8[lo:lo + batch_size], labels[lo:lo + batch_size]), device)
        graph(*batch)
    if full < n:
        imgs, labs = to_device((images_u8[full:], labels[full:]), device)
        _eval_batch(model, graph.params, imgs, labs, graph.sums, view=view,
                    valid=valid_tensor(), label_smoothing=label_smoothing)
    return torch.stack([s.double() for s in graph.sums])


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
    mesh=None,
) -> dict[str, Any]:
    """top-1/top-5 accuracy (micro) + mean CE loss over a split, on the
    model's device (`eval_route`: a graph per full batch on the card);
    over a `mesh`, this rank's slices of the batches."""
    kw = dict(img_size=img_size, crop_ratio=crop_ratio, mean=mean, std=std,
              batch_size=batch_size, valid_indices=valid_indices,
              label_smoothing=label_smoothing)
    if eval_route(_device_of(model), mesh)[0] == "graph":
        sums = graph_eval_sums(model, params, images_u8, labels, **kw)
    else:
        sums = eager_eval_sums(model, params, images_u8, labels, mesh=mesh, **kw)
    if mesh is not None:
        sums = data_all_reduce(sums, mesh, "eval_sums")
    n = len(labels)
    loss_sum, top1, top5 = (float(v) for v in sums.cpu())
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
    `num_warmup` (at least 2 on the card: the warm-up and the capture),
    timed by CUDA events around replays of the captured forward on the
    card (`eval_route`), by the host clock around eager forwards on the
    CPU."""
    tensors = list(params.values()) if params is not None else list(model.parameters())
    param_count = sum(int(t.numel()) for t in tensors)
    gflops = count_flops(model, image_size, in_channels) / 1e9

    device = _device_of(model)
    batch = torch.zeros((batch_size, image_size, image_size, in_channels),
                        device=device)
    if eval_route(device)[0] == "graph":
        params = dict(model.named_parameters()) if params is None else dict(params)
        owner = weakref.ref(model)
        graph = _cached_eval_graph(model, ("forward", tuple(batch.shape)), lambda: _EvalGraph(
            lambda static_params, x: _forward(owner(), static_params, x), params,
            (batch,), device))
        graph.load_params(params)
        graph.inputs[0].zero_()
        forward, warm = graph.call, max(num_warmup, 2)
    else:
        forward, warm = (lambda: _forward(model, params, batch)), max(num_warmup, 1)
    for _ in range(warm):
        forward()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(num_batches):
            forward()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(num_batches):
            forward()
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
    mesh=None,
) -> dict[str, Any]:
    """Primary + OOD robustness + efficiency. OOD sets use the PRIMARY
    dataset's channel stats; subset datasets get logit masking. Over a
    `mesh` every rank returns the same results."""
    say = main_print(mesh)
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
            mesh=mesh,
        )
        if ds_name == config.data.dataset:
            primary_results = metrics
        else:
            robustness_results[ds_name] = metrics
        say(
            f"eval {ds_name} "
            f"top1={metrics['val_acc']:.4f} top5={metrics['val_acc_top5']:.4f} "
            f"loss={metrics['loss']:.6f}"
        )

    eval_cfg = config.get("evaluation", {}) or {}
    efficiency_kw = dict(
        image_size=img_size,
        batch_size=eval_cfg.get("efficiency_batch_size", 64),
        num_warmup=eval_cfg.get("efficiency_warmup", 50),
        num_batches=eval_cfg.get("efficiency_batches", 200),
    )
    if mesh is None:
        efficiency = measure_efficiency(model, params, **efficiency_kw)
    else:
        efficiency = _main_rank_efficiency(model, params, mesh, efficiency_kw)
    say(
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


def _main_rank_efficiency(model, params, mesh, efficiency_kw) -> dict[str, float]:
    """`measure_efficiency` of the one-process student on rank 0, broadcast
    to every rank."""
    plain, plain_params = full_module(model, params, mesh)
    keys = ("param_count", "param_count_m", "gflops", "throughput_img_per_sec")
    values = torch.zeros(len(keys), dtype=torch.float64, device=mesh.device)
    if mesh.is_main:
        result = measure_efficiency(plain, plain_params, **efficiency_kw)
        values = torch.tensor([float(result[k]) for k in keys], dtype=torch.float64,
                              device=mesh.device)
    values = broadcast_(values, mesh).tolist()
    out = dict(zip(keys, values))
    out["param_count"] = int(out["param_count"])
    return out


def save_metrics(results: dict[str, Any], output_dir: Path | str) -> Path:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    metrics_path = output_dir / "metrics.json"
    with open(metrics_path, "w") as f:
        json.dump(results, f, indent=2)
    return metrics_path
