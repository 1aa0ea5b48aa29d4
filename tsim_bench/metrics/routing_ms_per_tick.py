"""routing_ms_per_tick: device ms a tick of the routing segment's
kernels, K2 / K5 (the next-move stacks) and K3 (the wavefronts), by
kernel name."""

ROUTING_KERNELS = ("sdir_kernel", "sdir_batched_kernel", "wf_tiled")


def read(t):
    ks = t.kernels(ROUTING_KERNELS)
    if not ks:
        return None
    return sum(d for _, _, d in ks) / 1e6 / t.ticks
