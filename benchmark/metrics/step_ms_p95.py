"""The 95th percentile over every step of the window of the ms between
consecutive step ends (CUDA events on the step's stream)."""


def read(r):
    from benchmark.harness import percentile

    return percentile(r.window.step_ms, 95) if len(r.window.step_ms) >= 20 else None
