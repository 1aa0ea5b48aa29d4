"""k1_roofline_share: the least time of a tick's decide + move, its
bytes (`costs.k1_cost`, each cell plane read once and written once and
each vehicle's own reads) over the published 3.35 TB/s, as a share of
K1's device time a call.  The bytes are counted from the traced chunks'
own state: at each chunk's start and end the cells where a vehicle
stands (`veh_map`), the fewer of the two.  K1 is byte-bound: its
operations' bound (one compare per cell and phase) is far lower."""

import torch

from tsim_bench.costs import PEAK_BYTES, k1_cost

K1_KERNELS = ("dm_worlds", "dm_coop")


def tick_bytes(t) -> float:
    out = []
    for start, end in t.extra["states"]:
        planes = min(((s.veh_map >= 0).to(torch.int32) for s in (start, end)),
                     key=lambda p: int(p.sum()))
        out.append(k1_cost((planes,), t.extra["cfg"])[0])
    return sum(out) / len(out)


def read(t):
    ks = t.kernels(K1_KERNELS)
    if not ks:
        return None
    per_call_s = sum(d for _, _, d in ks) / len(ks) / 1e9
    return 100.0 * tick_bytes(t) / PEAK_BYTES / per_call_s
