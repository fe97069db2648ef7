"""Device ms of the selector, the Procrustes loss, CE and UW-SO in one step:
the operations launched inside basd:loss of a profiled eager step
(`TrainStep.eager`), on any thread. A replay launches the same kernels."""


def read(r):
    return r.trace.eager.stage_ms(("basd:loss",))
