"""The trace reader: device operations attributed to the `basd:*` range
whose host interval holds their launch, on any thread; busy time as the
union of device intervals; idle gaps by the host call running."""

from __future__ import annotations

from benchmark.trace import Timeline


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def timeline():
    return Timeline([
        ev("user_annotation", "basd:teacher", 0, 100),
        ev("user_annotation", "basd:backward", 200, 300),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
        # the backward's launch comes from autograd's thread
        ev("cuda_runtime", "cudaLaunchKernel", 250, 2, tid=7, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 600, 2, corr=3),
        ev("cpu_op", "aten::fill_", 590, 30),
        ev("kernel", "k_teacher", 20, 40, corr=1),
        ev("kernel", "k_backward", 260, 100, corr=2),
        ev("gpu_memcpy", "copy", 300, 100, corr=2),
        ev("kernel", "k_outside", 610, 10, corr=3),
        # launched in an untraced profiler cycle: not this trace's
        ev("kernel", "k_earlier", 5, 3, corr=99),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1},
    ])


def test_stage_attribution_by_launch_time_on_any_thread():
    assert timeline().stage_us() == {"basd:teacher": 40.0, "basd:backward": 200.0}


def test_busy_is_the_union_of_device_intervals():
    tl = timeline()
    # [20, 60] + [260, 400] (the copy overlaps the kernel) + [610, 620]
    assert tl.busy_us() == 40 + 140 + 10
    assert [k[2] for k in tl.kernels("backward|outside")] == ["k_backward", "k_outside"]


def test_breakdown():
    b = timeline().breakdown()
    assert b["device_ops"][0] == ["k_backward", 100 / 1e6]
    # the gap 60..260 opens inside basd:teacher, the gap 400..610 inside
    # basd:backward (the innermost host call running when each opens)
    assert dict(b["idle_gaps"]) == {"basd:teacher": 200 / 1e6, "basd:backward": 210 / 1e6}
