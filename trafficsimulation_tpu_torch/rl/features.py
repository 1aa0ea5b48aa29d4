"""Per-group RL state features (the JAX package's `rl/features.py`).

One segment sum over the lane-label planes gives every group's local
flows at once; its values are counts (0/1 occupancy or stuck ticks), so
the f32 sums are exact in any order.  `neighbor_mean` takes all the
columns a state needs in one gather, adds the neighbours in the order
d = 0..3 and divides once, as JAX's loop does per column; the
timer feature is the multiply by the f32 reciprocal of 30 into which XLA's
jitted compile turns JAX's division.  Every feature equals JAX's bit for
bit.  On a world split by rows (`parallel/spatial.py`) the flows are the
ranks' partial sums plus one all-reduce of integers: exact, as the
unsharded sums.  A controller step computes each plane's flows once and
hands them to its state builder (`flows=`).
"""

from __future__ import annotations

import torch

from ..core.state import Grid, GroupStatic

NS_IN, NS_OUT, EW_IN, EW_OUT = 0, 1, 2, 3
SINKS = 1024


def group_flows(grid: Grid, flow_map: torch.Tensor, num_groups: int,
                slab=None):
    """(local_ns, local_ew) per group: the sum of flow_map over the
    group's in-flow lane cells, f32 [G] each.  `slab`
    (`parallel/spatial.Slab`): `grid` and `flow_map` are a rank's own
    rows, and the group's sums come from one all-reduce of integers."""
    G = num_groups
    qg = grid.queue_group.reshape(-1)
    qb = grid.queue_bucket.reshape(-1).to(torch.int32)
    # cells of no lane go to SINKS sink bins by cell index, so that the
    # card's atomic adds do not all meet in one bin
    cell = torch.arange(qg.shape[0], dtype=torch.int32, device=qg.device)
    seg = torch.where((qg >= 0) & (qg < G), qg * 5 + qb,
                      G * 5 + (cell & (SINKS - 1)))
    vals = flow_map.reshape(-1).to(torch.float32)
    sums = torch.zeros((G * 5 + SINKS,), dtype=torch.float32,
                       device=vals.device).scatter_add(0, seg.long(), vals)
    q = sums[:G * 5]
    if slab is not None:
        q = slab.sum_counts(q)
    q = q.reshape(G, 5)
    return q[:, NS_IN], q[:, EW_IN]


def neighbor_mean(gs: GroupStatic, vals: torch.Tensor) -> torch.Tensor:
    """Mean of `vals` ([G] or [G, k]: k columns at once) over each
    group's valid neighbours (count >= 1): the four neighbours added to
    0 in the order d = 0..3, then one division, as JAX's loop does."""
    G = vals.shape[0]
    has = gs.neighbor >= 0                                    # [G, 4]
    v = vals[torch.clamp(gs.neighbor, 0, G - 1).long()]      # [G, 4, ...]
    has_v = has.reshape(has.shape + (1,) * (vals.dim() - 1))
    v = torch.where(has_v, v, 0.0)
    s = torch.zeros_like(v[:, 0]) + v[:, 0]
    for d in range(1, 4):
        s = s + v[:, d]
    c = has.sum(dim=1).to(torch.int32).reshape(
        (G,) + (1,) * (vals.dim() - 1))
    return s / torch.clamp(c, min=1)


def _phase_cols(lights):
    ph0 = (lights.ft_phase == 0).to(torch.float32)
    # XLA's jitted `/ 30.0` is a multiply by the f32 reciprocal
    return ph0, 1.0 - ph0, lights.rl_timer.to(torch.float32) * (1.0 / 30.0)


def srl_state(cfg, grid: Grid, gs: GroupStatic, lights, occupancy,
              stuck_map, flows=None, stuck_flows=None):
    """REINFORCE's state, SRL_INPUT_DIMENSIONS (7, 11, 13, 17 or 19)
    columns, f32 [G, dim].  `flows`, `stuck_flows`: the `group_flows` of
    `occupancy` and `stuck_map` where the caller has them."""
    G = gs.valid.shape[0]
    ln, le = flows if flows is not None else \
        group_flows(grid, occupancy, G)
    p_ns, p_ew = ln - le, le - ln
    cols = [ln, le, p_ns, p_ew, *_phase_cols(lights)]
    dim = cfg.SRL_INPUT_DIMENSIONS
    if dim > 13:
        sn, se = stuck_flows if stuck_flows is not None else \
            group_flows(grid, stuck_map, G)
    # every neighbour mean of the row in one pass
    src = []
    if dim > 7:
        src += [gs.intersection_size, gs.penalty_score]
    if dim > 11:
        src += [p_ns, p_ew]
    if dim > 17:
        src += [sn - se, se - sn]
    means = neighbor_mean(gs, torch.stack(src, 1)).unbind(1) if src else ()
    if dim > 7:
        cols += [gs.intersection_size, gs.penalty_score, *means[:2]]
    if dim > 11:
        cols += list(means[2:4])
    if dim > 13:
        cols += [sn, se, sn - se, se - sn]
    if dim > 17:
        cols += list(means[4:6])
    return torch.stack(cols, dim=1)


def a2c_state(cfg, grid: Grid, gs: GroupStatic, lights, occupancy,
              flows=None):
    """A2C's 13 state columns, f32 [G, 13].  `flows`: the `group_flows`
    of `occupancy` where the caller has them."""
    G = gs.valid.shape[0]
    ln, le = flows if flows is not None else \
        group_flows(grid, occupancy, G)
    p_ns, p_ew = ln - le, le - ln
    m = neighbor_mean(gs, torch.stack([p_ns, p_ew, gs.intersection_size,
                                       gs.penalty_score], 1)).unbind(1)
    return torch.stack([ln, le, p_ns, p_ew, m[0], m[1], *_phase_cols(lights),
                        gs.intersection_size, gs.penalty_score, m[2], m[3]],
                       dim=1)


def gat_state(cfg, grid: Grid, gs: GroupStatic, lights, occupancy,
              flows=None):
    """GAT-DQN's star graph: (1 + 4 neighbours) x 9 features, f32
    [G, 5, 9], and the validity mask, f32 [G, 5].  `flows`: the
    `group_flows` of `occupancy` where the caller has them."""
    G = gs.valid.shape[0]
    ln, le = flows if flows is not None else \
        group_flows(grid, occupancy, G)
    node = torch.stack([ln, le, ln - le, le - ln, *_phase_cols(lights),
                        gs.intersection_size, gs.penalty_score], dim=1)
    has = gs.neighbor >= 0                                    # [G, 4]
    nbr = torch.where(has[..., None],
                      node[torch.clamp(gs.neighbor, 0, G - 1).long()], 0.0)
    ones = torch.ones((G, 1), dtype=torch.float32, device=node.device)
    return (torch.cat([node[:, None], nbr], dim=1),
            torch.cat([ones, has.to(torch.float32)], dim=1))
