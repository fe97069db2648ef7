"""Device ms of the views, TrivialAugmentWide and MixUp/CutMix in one step:
the operations launched inside basd:augment of a profiled eager step
(`TrainStep.eager`), on any thread. A replay launches the same kernels."""


def read(r):
    return r.trace.eager.stage_ms(("basd:augment",))
