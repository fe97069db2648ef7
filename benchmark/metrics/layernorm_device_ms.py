"""Device ms a step of the one-pass LayerNorm kernels (`csrc/layernorm.cu`,
named `basd_layernorm_*`) across the profiled replays; nothing where the
program launches none."""

KERNELS = r"basd_layernorm"


def read(r):
    tr = r.trace
    kernels = tr.replays.kernels(KERNELS)
    if not kernels:
        return None
    return sum(end - start for start, end, *_ in kernels) / 1e3 / tr.replay_steps
