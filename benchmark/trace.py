"""A torch.profiler trace (its Chrome-trace export) read into the device's
timeline, the host's launches and ranges, and what the metrics ask of
them.

Device operations are the events of category `kernel`, `gpu_memcpy` and
`gpu_memset`; each carries the correlation id of the host call that
launched it (`cuda_runtime` / `cuda_driver`: a kernel launch, or the
`cudaGraphLaunch` of a replay). A device operation is attributed to the
`basd:*` range whose host interval holds its launch, on whatever thread
launched it: the backward's kernels launch from autograd's thread, not
from the thread that opened `basd:backward`.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function"}
RANGE_PREFIX = "basd:"


class Timeline:
    def __init__(self, events: list[dict]):
        self.device = []  # (start us, end us, name, category, correlation)
        self.launch_ts = {}  # correlation -> the launch's host time
        self.ranges = []  # (start, end, name) of the basd:* ranges
        self.host = []  # (start, end, name) of the host's calls
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat"), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e["name"], cat, corr))
            elif cat in HOST_CATS:
                if cat in LAUNCH_CATS and corr is not None:
                    self.launch_ts[corr] = ts
                if cat == "user_annotation" and e["name"].startswith(RANGE_PREFIX):
                    self.ranges.append((ts, ts + dur, e["name"]))
                self.host.append((ts, ts + dur, e["name"]))
        if self.launch_ts:
            # only what this trace launched: a profiler cycle can also report
            # operations that an earlier, untraced cycle launched
            self.device = [d for d in self.device if d[4] in self.launch_ts]
        self.device.sort()
        self.ranges.sort()
        self.host.sort()

    @classmethod
    def load(cls, path) -> "Timeline":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def kernels(self, pattern: str | None = None) -> list[tuple]:
        """The kernels, or those whose name `pattern` (a regex) finds."""
        rx = re.compile(pattern) if pattern else None
        return [d for d in self.device
                if d[3] == "kernel" and (rx is None or rx.search(d[2]))]

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged = []
        for start, end, *_ in self.device:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [tuple(m) for m in merged]

    def busy_us(self) -> float:
        """Microseconds in which some operation ran on the device."""
        return sum(end - start for start, end in self.busy_intervals())

    def stage_us(self) -> dict[str, float]:
        """Device microseconds of the operations launched inside each
        `basd:*` range, by the range's name."""
        starts = [r[0] for r in self.ranges]
        out = defaultdict(float)
        for start, end, _, _, corr in self.device:
            ts = self.launch_ts.get(corr)
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= self.ranges[i][1]:
                out[self.ranges[i][2]] += end - start
        return dict(out)

    def stage_ms(self, ranges) -> float | None:
        """Device ms of the operations launched inside the named ranges, or
        None where the trace holds none of them."""
        stage = self.stage_us()
        found = [stage[n] for n in ranges if n in stage]
        return sum(found) / 1e3 if found else None

    def host_at(self, ts: float) -> str:
        """The innermost host call running at `ts` (the latest-started one
        that has not ended), or "no traced host call"."""
        i = bisect.bisect_right(self.host, (ts, float("inf"), "")) - 1
        best = None
        # host calls nest, so the innermost running call started last;
        # look back over the calls that started before `ts`
        for j in range(i, max(i - 2000, -1), -1):
            start, end, name = self.host[j]
            if end >= ts:
                best = name
                break
        return best or "no traced host call"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        between device operations grouped by what the host was doing when
        each began, in seconds over the whole trace."""
        by_name = defaultdict(float)
        for start, end, name, _, _ in self.device:
            by_name[name[:160]] += (end - start) / 1e6
        gaps = defaultdict(float)
        busy = self.busy_intervals()
        for (_, end), (start, _) in zip(busy, busy[1:]):
            gaps[self.host_at(end)[:160]] += (start - end) / 1e6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in order(by_name)],
                "idle_gaps": [[n, s] for n, s in order(gaps)]}
