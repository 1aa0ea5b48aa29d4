"""k9_roofline_share: the least time of a routing segment of R ticks on
the megakernel path, its bytes (`costs.mega_cost`) over the published
3.35 TB/s, as a share of K9's device time a call.

The bytes are counted from the traced chunks' own state, by the frozen
reference: for each traced chunk the K9 inputs of its first segment,
built by the reference's plain path from the chunk's start state, for
its first two worlds (the reference's call to `ops/plain.mega_segment`
is caught and ends its run there).  An input that differs between the
two counts once a world, one they share counts once; the vehicles at
the segment's two ends are every world's, read from the chunk's start
and end states (`mega_cost` takes the fewer)."""

import torch

from tsim_bench.costs import PEAK_BYTES, mega_cost

K9_KERNELS = ("mega_kernel",)


class _Caught(Exception):
    pass


def world_inputs(t, start, b: int):
    """(Config, K9's inputs of the first segment of world b of `start`),
    by the reference's plain path, or None."""
    ref, prog = t.extra["ref"], t.extra["pkg"]
    cfg = ref.make_config(t.extra["cfg_values"])
    world = ref.transfer.world_from_leaves(
        prog.transfer.world_leaves(prog.mesh.world_at(start, b)))
    got = {}

    def catch(cfg_, a):
        got.update(a)
        raise _Caught

    real = ref.HE.mega_segment
    ref.HE.mega_segment = catch
    try:
        ref.sim.run_chunk(cfg, world, max(1, cfg.PATHFINDING_COOLDOWN))
    except _Caught:
        pass
    finally:
        ref.HE.mega_segment = real
    return (cfg, got) if got else None


def segment_bytes(t, start, end):
    B = int(start.key.shape[0])
    one = world_inputs(t, start, 0)
    if one is None or B < 2:
        return None
    cfg, a0 = one
    _, a1 = world_inputs(t, start, 1)
    batched = {k for k, v in a0.items()
               if v.shape != a1[k].shape or not torch.equal(v, a1[k])}
    a = {k: (v.expand(B, *v.shape) if k in batched else v)
         for k, v in a0.items()}
    a["pa"] = (start.veh_map >= 0).to(torch.int32)
    out = t.extra["ref"].megakernel.segment_plain(cfg, a0)
    got = {k: v.expand(B, *v.shape) for k, v in out.items()}
    got["pa"] = (end.veh_map >= 0).to(torch.int32)
    return mega_cost(a, got, batched | {"pa"})


def read(t):
    ks = t.kernels(K9_KERNELS)
    if not ks:
        return None
    with torch.no_grad():
        nb = [segment_bytes(t, s, e) for s, e in t.extra["states"]]
    nb = [b for b in nb if b is not None]
    if not nb:
        return None
    per_call_s = sum(d for _, _, d in ks) / len(ks) / 1e9
    return 100.0 * (sum(nb) / len(nb)) / PEAK_BYTES / per_call_s
