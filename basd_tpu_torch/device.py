"""Device resolution for the port's entry points, the step's device
constants, and a call captured as one CUDA graph (`CapturedCall`)."""

from __future__ import annotations

import functools
import subprocess
import time

import torch

from basd_tpu_torch import kernels

# every device constant made so far, by (builder, its arguments)
CONSTANTS: dict[tuple, torch.Tensor] = {}


def device_constant(build):
    """Decorate `build(*args)`, whose last argument is a torch.device, to
    make its tensor once per arguments and return that same tensor on every
    later call (callers only read it). The copy from the host happens at
    the first call, so a train step that has run once copies nothing more:
    a CUDA graph cannot capture a copy from pageable host memory."""

    @functools.wraps(build)
    def cached(*args):
        key = (build.__name__, *args)
        tensor = CONSTANTS.get(key)
        if tensor is None:
            tensor = CONSTANTS[key] = build(*args)
        return tensor

    return cached


class CapturedCall:
    """`fn()` as one CUDA graph on `device`, where `fn` reads and writes
    only tensors that outlive it: static buffers that the caller refills
    before each call, and state it updates in place.

    The first call runs `fn` eagerly on a side stream (the warm-up, which
    builds the kernels, the library handles and the device constants); the
    second releases the memory the warm-up left cached and captures it on
    that stream into a private memory pool, with
    `generator` (if any) registered so that each replay draws anew, and
    replays it; later calls replay. A call returns what `fn` returned: the
    warm-up's own tensors, then the graph's outputs, which the next replay
    overwrites. Capture runs nothing, and the graph launches the eager
    call's kernels on the same buffers in the same order, so it gives the
    eager call's bits. A failed capture or replay raises; nothing falls
    back to eager.

    `kernels.LAUNCHES` keeps its meaning: the capture pass counts its
    launches (`launches`, one replay's) and takes them back out, and each
    replay adds them. `capture_s` is the capture's host seconds,
    `pool_bytes` the memory its pool reserved."""

    def __init__(self, fn, device, generator: torch.Generator | None = None):
        self.fn = fn
        self.device = torch.device(device)
        self.generator = generator
        self.stream = self.graph = self.outputs = self.launches = None
        self.capture_s = self.pool_bytes = None

    def __call__(self):
        if self.stream is None:
            return self._warm_up()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for name, count in self.launches.items():
            kernels.LAUNCHES[name] += count
        return self.outputs

    def _warm_up(self):
        current = torch.cuda.current_stream(self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = self.fn()
        current.wait_stream(self.stream)
        return out

    def _capture(self) -> None:
        # the warm-up's freed blocks stay cached in the default pool, which
        # the graph's private pool cannot draw on and the allocator does
        # not release while a capture is under way: give them back first
        # (a 7B teacher's activations do not fit twice beside its weights)
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=self.stream):
            reserved = torch.cuda.memory_reserved(self.device)
            self.outputs = self.fn()
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s = time.perf_counter() - t0
        self.launches = {name: kernels.LAUNCHES[name] - n for name, n in before.items()}
        kernels.LAUNCHES.update(before)  # the capture pass launched nothing
        self.graph = graph
        self.fn = None  # the graph holds the work; let go of what fn closed over


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when None. Raises when CUDA is asked for
    and absent: nothing silently moves to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "basd_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain torch path"
        )
    return dev


def card_line(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, so a
    time stands beside the card that gave it; "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None else device.index
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip()
