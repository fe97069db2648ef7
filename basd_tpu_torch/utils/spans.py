"""Spans of the train step, recorded inside the step itself, replayed or
eager: where a step's time goes, stage by stage, and what the host does
around it.

Each `TrainStep` owns one `SpanRecorder` (`step_fn.spans`) with two rings.

* Device stamps. A span of the step body (`span`) opens and closes at two
  of a step's `WIDTH` boundaries (`BOUNDARIES`); spans that follow one
  another share a boundary, so a step stamps each boundary once, at most
  `WIDTH` stamps. On a CUDA device a stamp is `basd_span_stamp`
  (`csrc/spans.cu`), one thread on the step's stream that writes the
  device clock (`%globaltimer`) into `ring[slot % steps, boundary]` while
  the recorder's device flag is set; the step's closing stamp advances
  `slot`, a device counter. A CUDA graph captures the stamps whatever the
  flag, so turning spans on or off needs no recapture; an eager step
  launches them only while spans are on. On the CPU a stamp is
  `time.perf_counter_ns()`, taken in op order. The `basd:*` spans also open
  the `torch.profiler` range of their name, as the step always has; `step`,
  `select` and `procrustes` are stamps only, so that a trace still credits
  each kernel to the same `basd:*` range.
* Host spans (`launch_span`, `input_span`): `basd_host:launch` around the
  host work of one `TrainStep` call, `basd_host:input` around producing one
  batch in `data.pipeline.prefetch_to_device`. Each opens a
  `torch.profiler` range of its name and, while spans are on, records two
  `perf_counter_ns` readings. Their names do not begin with `basd:`.

`on()` and `off()` switch both rings between steps (the default is off);
`read()` synchronizes and returns the records since `on()` as `Span`s on
the host's `perf_counter_ns` clock: `calibrate()` maps the device clock
onto it. A step's spans share its index: the number of `TrainStep` calls
made before it; a `basd_host:input` span's index is the number of batches
produced before it, which is the index of the step that takes the batch
when one iterator feeds the step from its first call.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

STEP = "step"
# each span of the step and the boundaries it opens and closes at, in a
# step's row of the ring. `procrustes` runs from the per-point Procrustes
# terms to the end of the loss (their mean and UW-SO's weighted sum, a few
# scalar kernels), so that it closes where `basd:loss` closes
BOUNDARIES = {
    STEP: (0, 9),
    "basd:augment": (0, 1),
    "basd:views": (0, 1),
    "basd:teacher": (1, 2),
    "basd:student_forward": (2, 3),
    "basd:loss": (3, 6),
    "select": (4, 5),
    "procrustes": (5, 6),
    "basd:backward": (6, 7),
    "basd:optimizer": (7, 8),
}
WIDTH = 10
STEPS = 1024
PROFILED = "basd:"
LAUNCH, INPUT = "basd_host:launch", "basd_host:input"


class Span(NamedTuple):
    step: int
    name: str
    parent: str | None
    start: int  # perf_counter_ns
    end: int


def span(recorder: SpanRecorder | None, name: str):
    """`recorder.span(name)`, or no span where there is no recorder."""
    return nullcontext() if recorder is None else recorder.span(name)


class SpanRecorder:
    """The spans of one train step on `device`, the last `STEPS` steps
    kept (`STEPS` x `WIDTH` int64, 80 KiB, allocated here, outside any
    graph's pool)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.steps = steps = STEPS
        self.cuda = self.device.type == "cuda"
        self.enabled = False
        self.launched = self.produced = 0  # TrainStep calls, batches produced
        self.offset_ns = self.offset_err_ns = self.drift_ns = 0
        self.layout: dict[str, tuple[str | None, int, int]] = {}
        self.host: deque = deque(maxlen=2 * steps)
        self._first = 0  # the index of the first step since on()
        self._stack: list[str] = []
        self._stamped = 0  # this step's stamped boundaries, as bits
        if self.cuda:
            zeros = lambda *shape, dtype=torch.int64: torch.zeros(
                shape, dtype=dtype, device=self.device)
            self.ring, self.slot = zeros(steps, WIDTH), zeros()
            self.flag = zeros(dtype=torch.int32)
            # the calibration's own stamp: an always-set flag, one cell
            self._one, self._cal, self._cal_slot = (
                zeros(dtype=torch.int32) + 1, zeros(1, 1), zeros())
            self.calibrate()
        else:
            self.ring, self.slot = np.zeros((steps, WIDTH), np.int64), 0

    # ---- device stamps ----

    @contextmanager
    def span(self, name: str):
        """Stamp `name`'s boundaries around the block (each boundary once a
        step); a `basd:*` span also opens its `torch.profiler` range."""
        opens, closes = BOUNDARIES[name]
        if name == STEP:
            self._stamped = 0
        parent = self._stack[-1] if self._stack else None
        self._stack.append(name)
        try:
            self._stamp(opens, False)
            with record_function(name) if name.startswith(PROFILED) else nullcontext():
                yield
            self._stamp(closes, name == STEP)
            self.layout[name] = (parent, opens, closes)
        finally:
            self._stack.pop()

    def _stamp(self, boundary: int, closing: bool) -> None:
        bit = 1 << boundary
        if self._stamped & bit:
            return
        self._stamped |= bit
        if self.cuda:
            if self.enabled or torch.cuda.is_current_stream_capturing():
                self._launch(self.flag, self.ring, self.slot, boundary, WIDTH, self.steps,
                             closing)
        elif self.enabled:
            self.ring[self.slot % self.steps, boundary] = time.perf_counter_ns()
            self.slot += closing

    def _launch(self, flag, ring, slot, boundary, width, steps, closing) -> None:
        from basd_tpu_torch import kernels

        status = kernels.library("spans").basd_span_stamp_launch(
            flag.data_ptr(), ring.data_ptr(), slot.data_ptr(), boundary, width, steps,
            int(closing), torch.cuda.current_stream(self.device).cuda_stream)
        kernels.check(status, "basd_span_stamp")

    def calibrate(self) -> tuple[int, int]:
        """(offset, uncertainty) in ns of the device clock against
        `perf_counter_ns`: a stamp launched on the idle device between two
        host readings, the tightest of five; the offset is the stamp
        minus the readings' midpoint, the uncertainty half their distance.
        Keeps the change from the previous offset in `drift_ns`."""
        if not self.cuda:
            return 0, 0
        best = None
        torch.cuda.synchronize(self.device)
        for _ in range(5):
            t0 = time.perf_counter_ns()
            self._launch(self._one, self._cal, self._cal_slot, 0, 1, 1, False)
            torch.cuda.synchronize(self.device)
            t1 = time.perf_counter_ns()
            reading = (int(self._cal.item()) - (t0 + t1) // 2, (t1 - t0) // 2)
            if best is None or reading[1] < best[1]:
                best = reading
        self.drift_ns = best[0] - self.offset_ns if self.offset_ns else 0
        self.offset_ns, self.offset_err_ns = best
        return best

    # ---- host spans ----

    @contextmanager
    def _host_span(self, name: str, index: int):
        with record_function(name):
            start = time.perf_counter_ns() if self.enabled else None
            yield
            if start is not None:
                self.host.append(Span(index, name, None, start, time.perf_counter_ns()))

    @contextmanager
    def launch_span(self):
        """`basd_host:launch` around one TrainStep call's host work."""
        with self._host_span(LAUNCH, self.launched):
            yield
        self.launched += 1

    @contextmanager
    def input_span(self):
        """`basd_host:input` around producing one batch."""
        with self._host_span(INPUT, self.produced):
            yield
        self.produced += 1

    # ---- switching and reading ----

    def on(self) -> None:
        """Record from the next step on: the ring and the host ring start
        empty (on the step's stream, after the steps already launched)."""
        if self.cuda:
            self.slot.zero_()
            self.flag.fill_(1)
        else:
            self.slot = 0
        self.host.clear()
        self._first = self.launched
        self.enabled = True

    def off(self) -> None:
        """Stop recording after the steps already launched; what was
        recorded stays readable until the next `on()`."""
        if self.cuda:
            self.flag.fill_(0)
        self.enabled = False

    def read(self) -> list[Span]:
        """Every span recorded since `on()` (of the device's, the last
        `steps` steps), by start, on the `perf_counter_ns` clock; on a CUDA
        device after a synchronize and a new `calibrate()`."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.calibrate()
            n, ring = int(self.slot.item()), self.ring.cpu().numpy()
        else:
            n, ring = self.slot, self.ring
        out = list(self.host)
        for s in range(max(0, n - self.steps), n):
            row = ring[s % self.steps] - self.offset_ns
            out += [Span(self._first + s, name, parent, int(row[a]), int(row[b]))
                    for name, (parent, a, b) in self.layout.items()]
        return sorted(out, key=lambda r: (r.start, -r.end))
