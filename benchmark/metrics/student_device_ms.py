"""Device ms of the student's forward and of the backward (remat's
recomputation and the loss's backward run inside it) in one step: the
operations launched inside basd:student_forward and basd:backward of a
profiled eager step (`TrainStep.eager`), on any thread. A replay launches
the same kernels."""


def read(r):
    return r.trace.eager.stage_ms(("basd:student_forward", "basd:backward"))
