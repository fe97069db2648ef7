"""torch.cuda.max_memory_allocated from the start of the port's staging to
the window's end, in GiB (the graph's pool included, the reference's
work after it left out)."""


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None
