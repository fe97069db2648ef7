"""Share of the profiled stretch of replays (host clock, synchronized at
both ends) in which no operation ran on the device."""


def read(r):
    tr = r.trace
    if tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
