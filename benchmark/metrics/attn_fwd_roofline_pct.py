"""Share of K1, the attention forward's roofline: the least device time of the step's
calls (`costs/<family>.attention_bound_s`), over the device time of the
kernels named here, across the profiled replays."""

KERNELS = r"attn_fwd_mma"


def read(r):
    tr = r.trace
    kernels = tr.replays.kernels(KERNELS)
    if not kernels:
        return None
    busy_s = sum(end - start for start, end, *_ in kernels) / 1e6
    bound_s = tr.costs.attention_bound_s(tr.cfg, backward=False) * tr.replay_steps
    return 100.0 * bound_s / busy_s
