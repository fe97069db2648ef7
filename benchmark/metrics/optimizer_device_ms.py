"""Device ms of the ScheduleFree update in one step:
the operations launched inside basd:optimizer of a profiled eager step
(`TrainStep.eager`), on any thread. A replay launches the same kernels."""


def read(r):
    return r.trace.eager.stage_ms(("basd:optimizer",))
