"""device_idle_share: 100 x (1 - the union of the device's activity
intervals / the traced interval), from the traced chunks' profile of
CUDA activities alone, the interval on the host's clock."""


def read(t):
    if not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
