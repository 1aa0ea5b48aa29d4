"""launches_per_tick: the device kernels, copies and memsets that the
profiler records over the traced chunks, per tick of the batch (the
host's issue: the batch runner and the chunk runner).  A count; it
repeats exactly where the program's work does."""


def read(t):
    if not t.device:
        return None
    return len(t.device) / t.ticks
