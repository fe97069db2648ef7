"""The step's products counted from the configuration (`costs/<family>.py`),
times the steps of the traced run's unprofiled stretch, over its seconds
and the bf16 peak."""


def read(r):
    from benchmark.costs import h100

    tr = r.trace
    if tr.stretch.steps == 0 or not tr.replays.device:
        return None
    flops = tr.costs.step_flops(tr.cfg) * tr.stretch.steps
    return 100.0 * flops / tr.stretch.window_s / h100.BF16_FLOPS
