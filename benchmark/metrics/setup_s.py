"""Seconds from the process's start to the first timed step: staging, the
kernels' start-up check and build, the weights, the pool and the first
steps (warm-up, capture, replays)."""


def read(r):
    return r.setup_s
