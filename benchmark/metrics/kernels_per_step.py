"""Kernels on the device per step in the profiled stretch of replays."""


def read(r):
    tr = r.trace
    n = len(tr.replays.kernels())
    return n / tr.replay_steps if n else None
