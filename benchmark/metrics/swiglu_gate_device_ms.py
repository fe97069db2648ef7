"""Device ms a step of the SwiGLU gate kernels (`csrc/swiglu.cu`, named
`swiglu_gate_*`) across the profiled replays; nothing where the program
launches none."""

KERNELS = r"swiglu_gate"


def read(r):
    tr = r.trace
    kernels = tr.replays.kernels(KERNELS)
    if not kernels:
        return None
    return sum(end - start for start, end, *_ in kernels) / 1e3 / tr.replay_steps
