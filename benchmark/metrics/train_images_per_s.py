"""Images of all the window's steps over the window's seconds (host clock,
ended by a synchronize)."""


def read(r):
    return r.window.steps * r.batch / r.window.window_s
