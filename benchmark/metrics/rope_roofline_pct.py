"""Share of the RoPE kernel's roofline: the least device time of the
step's calls (`costs/<family>.rope_bound_s`), times the profiled replays,
over the device time of the kernels named here across those replays;
nothing where the program launches none or the family counts no RoPE."""

KERNELS = r"rope_qk"


def read(r):
    tr = r.trace
    bound = getattr(tr.costs, "rope_bound_s", None)
    kernels = tr.replays.kernels(KERNELS)
    if bound is None or not kernels:
        return None
    busy_s = sum(end - start for start, end, *_ in kernels) / 1e6
    return 100.0 * bound(tr.cfg) * tr.replay_steps / busy_s
