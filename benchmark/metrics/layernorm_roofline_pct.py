"""Share of the LayerNorm kernel's roofline: the least device time of the
step's teacher LayerNorms (`costs/layernorm.layernorm_bound_s`), times the
profiled replays, over the device time of the kernels named here across
those replays; nothing where the program launches none."""

from benchmark.costs.layernorm import layernorm_bound_s

KERNELS = r"basd_layernorm"


def read(r):
    tr = r.trace
    kernels = tr.replays.kernels(KERNELS)
    if not kernels:
        return None
    busy_s = sum(end - start for start, end, *_ in kernels) / 1e6
    return 100.0 * layernorm_bound_s(tr.cfg) * tr.replay_steps / busy_s
