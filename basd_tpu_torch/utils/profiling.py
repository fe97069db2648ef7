"""Tracing and profiling utilities; the port of `basd_tpu/utils/profiling.py`.

  * `profile_trace`       -- a `torch.profiler` trace (host and CUDA
                            activity) around a block, written as a Chrome
                            trace (viewable in Perfetto),
  * `step_cost_analysis`  -- FLOPs, transcendentals and bytes accessed of
                            everything one call of a function does, backward
                            included (the counterpart of the JAX package's
                            XLA cost of a compiled function).

The forward FLOPs of one image of a model are `evaluation.metrics.count_flops`.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from basd_tpu_torch import kernels


@contextlib.contextmanager
def profile_trace(log_dir: str | Path):
    """Trace the block with `torch.profiler` (CPU, and CUDA when present)
    and write `log_dir/trace.json`; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


# ops whose every output element is one transcendental, as XLA's cost
# analysis counts exp, log, tanh, erf, sin, cos, sqrt, rsqrt and the
# logistic; GELU, SiLU and the (log-)softmax are one per element here, where
# XLA sees their exp or erf. In-place forms count too.
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh", "tan",
    "erf", "erfc", "erfinv", "sin", "cos", "asin", "acos", "atan", "atan2",
    "sqrt", "rsqrt", "sigmoid", "gelu", "silu", "_softmax", "_log_softmax",
    "gelu_backward", "_log_softmax_backward_data",
})


def _pow_is_transcendental(args) -> bool:
    """pow with a tensor exponent or a non-integer scalar one."""
    exponent = args[1]
    if isinstance(exponent, torch.Tensor):
        if exponent.dim():
            return True
        exponent = exponent.item()
    return not float(exponent).is_integer()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _CostTally(TorchDispatchMode):
    """Totals of one `step_cost_analysis` call: every aten op run while the
    mode is on, and the kernels' own reports (`kernels.add_cost`)."""

    def __init__(self):
        super().__init__()
        self.flops = self.transcendentals = self.bytes_accessed = 0

    def add(self, flops: int, transcendentals: int, bytes_accessed: int) -> None:
        self.flops += int(flops)
        self.transcendentals += int(transcendentals)
        self.bytes_accessed += int(bytes_accessed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        name = packet.__name__.rstrip("_")
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if name in _TRANSCENDENTAL or (name == "pow" and _pow_is_transcendental(args)):
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        # views alias their input and `empty*` writes nothing
        if not func.is_view and not name.startswith("empty"):
            self.bytes_accessed += sum(
                t.numel() * t.element_size() for t in _tensors((args, kwargs, out)))
        return out


def step_cost_analysis(fn, *example_args) -> dict[str, float]:
    """Run `fn(*example_args)` once and return the `flops`,
    `bytes_accessed` and `transcendentals` of everything the call did, its
    backward included when it runs one.

    A `TorchDispatchMode` sees every aten op: FLOPs by the formulas of
    `torch.utils.flop_counter` (matrix products, `bmm`, `addmm`,
    convolutions and their backward, SDPA), 2 per multiply-add as XLA
    counts them; transcendentals as the output elements of the ops in
    `_TRANSCENDENTAL` and of `pow` with a non-integer exponent;
    `bytes_accessed` as the input and output bytes of each op that is not
    a view. That is the unfused sum: every op reads its inputs from memory
    and writes its outputs back, where XLA counts the bytes of its fused
    kernels, so it reads higher than the JAX package's count. The port's
    kernels, called through `ctypes`, report their own work
    (`kernels.add_cost`) as their plain versions count at the same shape,
    so a step counts the same on the card as on the CPU.

    Elementwise arithmetic is not counted, and neither is
    `torch.linalg.eigh` (cuSOLVER's, above the Jacobi gate), which has no
    formula: an MFU from these FLOPs is conservative, as the JAX bench says
    of XLA's count (bench.py:310-312)."""
    tally = _CostTally()
    kernels.COST_TALLIES.append(tally)
    try:
        with tally:
            fn(*example_args)
    finally:
        kernels.COST_TALLIES.remove(tally)
    return {
        "flops": float(tally.flops),
        "bytes_accessed": float(tally.bytes_accessed),
        "transcendentals": float(tally.transcendentals),
    }
