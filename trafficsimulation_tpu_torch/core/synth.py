"""Synthetic hand-built worlds: a full `World` without the generation
pipeline (the JAX package's `core/synth.py`; its module docstring gives
the two uses: tests that need exact control of the geometry, and the
multi-chip dry run).

`crossroad_world` builds the smallest complete city: two 2-lane roads
crossing at a 4-cell intersection with one light group (4 lights, queue
runs, clearance bucket), two serviced city blocks with routable
entrances, four highway ends and a pre-generated demand table.  The
planes and the trips are drawn in numpy as the JAX version draws them,
the tables written into `empty_statics` on `device`; the cost field
comes from the port's `routing.compute_cost_fields`.  RL light controllers are not ported
(ROADMAP Queue 1 item 14): a config that names one raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import codes as C
from .. import prng
from ..config import Config
from .state import (BlockStatic, Demand, DestStatic, Grid, GroupStatic,
                    LightStatic, Overrides, World)


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def empty_statics(cfg: Config, device="cuda"):
    """Zero-filled static tables at the cfg capacities (no lights, no
    groups, no blocks): (lights, groups, blocks, dests)."""
    caps = cfg.capacities()
    L, A = caps.max_lights, caps.max_lights * 8
    G, Q = caps.max_groups, caps.max_queue_cells
    B, E = caps.max_blocks, caps.max_entrances_hw
    D = caps.max_dests
    i32, f32 = np.int32, np.float32

    def full(n, v, dt=i32):
        return _t(np.full(n, v, dt), device)
    ls = LightStatic(
        valid=full(L, False, bool), pos=full(L, 0), group=full(L, -1),
        axis=full(L, -1), assign_road=full(A, -1), assign_light=full(A, -1),
        assign_valid=full(A, False, bool), srun_lo=full(A, 0),
        srun_hi=full(A, 0), srun_light=full(A, -1), sextra_cell=full(A, -1),
        sextra_light=full(A, -1))
    gs = GroupStatic(
        valid=full(G, False, bool), neighbor=full((G, 4), -1),
        intermediates=full((G, 8), -1), bbox=full((G, 4), 0),
        intersection_size=full(G, 0, f32), penalty_score=full(G, 0, f32),
        queue_cells=full(Q, 0), queue_qgroup=full(Q, -1),
        queue_qbucket=full(Q, 0), run_lo=full(Q, 0), run_hi=full(Q, 0),
        run_seg=full(Q, -1))
    bs = BlockStatic(
        valid=full(B, False, bool), btype=full(B, 0, np.uint8),
        inner_count=full(B, 0), entrance=full(B, -1), dest=full(B, -1),
        service_dest=full(B, -1), food_cap=full(B, 0, f32),
        waste_cap=full(B, 0, f32), needs_food=full(B, False, bool),
        produces_waste=full(B, False, bool))
    dests = DestStatic(
        valid=full(D, False, bool), pos=full(D, 0), kind=full(D, 0, np.uint8),
        block=full(D, -1), hw_pos=full(E, -1), hw_valid=full(E, False, bool))
    return ls, gs, bs, dests


def assemble_world(cfg: Config, grid: Grid, ls, gs, bs, dests, demand,
                   key: torch.Tensor) -> World:
    """Wrap static tables and a grid into a runnable `World`: dynamic
    state zeroed, the key stack of the first MAX_FIELD_DESTS
    destinations computed from the grid.  `key`: the PRNG key as an
    int32 [2] tensor on the world's device."""
    from ..agents.blocks import init_blocks_state
    from ..agents.pedestrians import init_pedestrians
    from ..agents.rain import init_rain_state
    from ..lights import fsm
    from ..ops import engine, routing
    from ..sim import _nearest_exit_table, init_metrics, init_vehicles

    if cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM in fsm.RL_ALGOS:
        raise NotImplementedError(
            "RL light controllers are not ported yet (ROADMAP Queue 1 "
            "item 14)")
    dev = key.device
    caps = cfg.capacities()
    H, W = cfg.HEIGHT, cfg.WIDTH
    D = dests.valid.shape[0]
    DF = min(D, cfg.MAX_FIELD_DESTS or D)
    field = routing.compute_cost_fields(
        cfg, grid.allowed_dirs, grid.road_class, dests.pos[:DF],
        dests.valid[:DF], is_road=grid.is_road)
    L = ls.valid.shape[0]
    return World(
        grid=grid, lights_static=ls, groups_static=gs, blocks_static=bs,
        dests=dests,
        cost_field=engine.field_to_keys(cfg, field, grid.road_class),
        nearest_exit=_nearest_exit_table(cfg, dests, DF),
        veh_map=torch.full((H, W), -1, dtype=torch.int32, device=dev),
        stop_map=torch.zeros((H, W), dtype=torch.bool, device=dev),
        rain_map=torch.zeros((H, W), dtype=torch.bool, device=dev),
        stuck_map=torch.zeros((H, W), dtype=torch.int32, device=dev),
        density=torch.zeros((H, W), dtype=torch.float32, device=dev),
        vehicles=init_vehicles(caps.max_vehicles, dev),
        lights=fsm.init_lights_state(cfg, gs.valid.shape[0], L, gs.valid),
        blocks=init_blocks_state(bs),
        rain=init_rain_state(cfg, dev),
        demand=demand, metrics=init_metrics(dev),
        overrides=Overrides(
            light_force=torch.full((L,), -1, dtype=torch.int8, device=dev),
            spawn_rain=torch.zeros((), dtype=torch.bool, device=dev)),
        peds=init_pedestrians(H, W, cfg.PEDESTRIANS_ENABLED, dev),
        ped_map=torch.zeros((H, W), dtype=torch.int32, device=dev),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
        elapsed=torch.zeros((), dtype=torch.float32, device=dev),
        key=key)


def crossroad_world(cfg: Config, key=None, n_trips: int = 48,
                    device="cuda") -> World:
    """See module docstring.  Requires HEIGHT, WIDTH >= 24.  `key`:
    uint32 [2] (`prng.PRNGKey`), PRNGKey(0) by default."""
    H, W = cfg.HEIGHT, cfg.WIDTH
    assert H >= 24 and W >= 24, "crossroad_world needs >= 24x24"
    if key is None:
        key = prng.PRNGKey(0)
    dev = torch.device(device)
    ym, xm = H // 2 - 1, W // 2 - 1
    R = min(cfg.TRAFFIC_LIGHT_RANGE, ym - 3, xm - 3)

    cell = np.full((H, W), C.SIDEWALK, np.uint8)
    dirs = np.zeros((H, W), np.uint8)
    rc = np.zeros((H, W), np.uint8)
    NB, EB, SB, WB = C.DIR_BITS  # N = +y

    # two-lane horizontal road: row ym eastbound, ym + 1 westbound
    cell[ym, 1:W - 1] = C.R2
    dirs[ym, 1:W - 1] = EB
    rc[ym, 1:W - 1] = 2
    cell[ym + 1, 1:W - 1] = C.R2
    dirs[ym + 1, 1:W - 1] = WB
    rc[ym + 1, 1:W - 1] = 2
    # two-lane vertical road: col xm northbound (+y), xm + 1 southbound
    cell[1:H - 1, xm] = C.R2
    dirs[1:H - 1, xm] = NB
    rc[1:H - 1, xm] = 2
    cell[1:H - 1, xm + 1] = C.R2
    dirs[1:H - 1, xm + 1] = SB
    rc[1:H - 1, xm + 1] = 2

    # 4-cell intersection: union of through dirs (turns happen there)
    for (y, x, d) in ((ym, xm, EB | NB), (ym, xm + 1, EB | SB),
                      (ym + 1, xm, WB | NB), (ym + 1, xm + 1, WB | SB)):
        cell[y, x] = C.INTERSECTION
        dirs[y, x] = d
        rc[y, x] = 1  # intersections are road class 1

    # approach cells become ControlledRoad: (controlled cell, run, axis)
    approaches = [
        ((ym, xm - 1), [(ym, x) for x in range(xm - R, xm)], 1),
        ((ym + 1, xm + 2), [(ym + 1, x)
                            for x in range(xm + 2, xm + 2 + R)], 1),
        ((ym - 1, xm), [(y, xm) for y in range(ym - R, ym)], 0),
        ((ym + 2, xm + 1), [(y, xm + 1)
                            for y in range(ym + 2, ym + 2 + R)], 0),
    ]
    orig = cell.copy()
    for (cy, cx), _, _ in approaches:
        cell[cy, cx] = C.CONTROLLED_ROAD

    # lights at the 4 diagonal corner sidewalks
    light_pos = [(ym - 1, xm - 1), (ym + 2, xm + 2),
                 (ym - 1, xm + 2), (ym + 2, xm - 1)]
    light_axis = [1, 1, 0, 0]
    for (ly, lx) in light_pos:
        cell[ly, lx] = C.TRAFFIC_LIGHT

    # blocks and entrances (routable dests; the road gains an arrow into
    # the entrance, the entrance points back out)
    xe0, xe1 = max(3, xm - R - 2), min(W - 4, xm + R + 3)
    ent0 = (ym - 1, xe0)   # south of the eastbound lane
    ent1 = (ym + 2, xe1)   # north of the westbound lane
    cell[ent0] = C.BLOCK_ENTRANCE
    dirs[ent0] = NB
    dirs[ym, xe0] |= SB
    cell[ent1] = C.BLOCK_ENTRANCE
    dirs[ent1] = SB
    dirs[ym + 1, xe1] |= NB

    # highway ends
    hw_in = [(ym, 1), (ym + 1, W - 2), (1, xm), (H - 2, xm + 1)]
    hw_out = [(ym, W - 2), (ym + 1, 1), (H - 2, xm), (1, xm + 1)]
    for (y, x) in hw_in:
        cell[y, x] = C.HIGHWAY_ENTRANCE
    for (y, x) in hw_out:
        cell[y, x] = C.HIGHWAY_EXIT

    def flat(yx):
        return yx[0] * W + yx[1]

    # ---- static tables at cfg capacities, written in place ----------------
    ls, gs, bs, dests = empty_statics(cfg, dev)
    caps = cfg.capacities()

    def put(t, vals):
        t[:len(vals)] = torch.as_tensor(vals, dtype=t.dtype)

    light_id_plane = np.full((H, W), -1, np.int32)
    for i, (ly, lx) in enumerate(light_pos):
        light_id_plane[ly, lx] = i
    ls.valid[:4] = True
    put(ls.pos, [flat(p) for p in light_pos])
    ls.group[:4] = 0
    put(ls.axis, light_axis)
    # assignment pairs: light i controls its approach run
    ar, al = [], []
    for i, ((cy, cx), run, _ax) in enumerate(approaches):
        ar.append(flat((cy, cx)))
        al.append(i)
        for c in run:
            ar.append(flat(c))
            al.append(i)
    put(ls.assign_road, ar)
    put(ls.assign_light, al)
    ls.assign_valid[:len(ar)] = True
    # stop runs (fsm.build_stop_map): one lane run and one own-cell run
    # per light, in diff-buffer index space
    OFFV = H * (W + 1)
    sruns = [
        (ym * (W + 1) + (xm - R), ym * (W + 1) + xm, 0),
        ((ym + 1) * (W + 1) + (xm + 2), (ym + 1) * (W + 1) + xm + 2 + R, 1),
        (OFFV + (ym - R) * W + xm, OFFV + ym * W + xm, 2),
        (OFFV + (ym + 2) * W + (xm + 1),
         OFFV + (ym + 2 + R) * W + (xm + 1), 3),
    ] + [(ly * (W + 1) + lx, ly * (W + 1) + lx + 1, i)
         for i, (ly, lx) in enumerate(light_pos)]
    put(ls.srun_lo, [r[0] for r in sruns])
    put(ls.srun_hi, [r[1] for r in sruns])
    put(ls.srun_light, [r[2] for r in sruns])

    # queue runs (prefix-buffer indexing: an H-run at row y over [x0, x1]
    # -> Ph[y*(W+1)+x0 .. +x1+1]; a V-run at col x over [y0, y1] -> OFF_V
    # + y0*W+x .. (y1+1)*W+x)
    OFF_V = H * (W + 1)
    NS_IN, NS_OUT, EW_IN, EW_OUT, CLEAR = 0, 1, 2, 3, 4

    def hrun(y, x0, x1, bucket):
        return (y * (W + 1) + x0, y * (W + 1) + x1 + 1, bucket)

    def vrun(x, y0, y1, bucket):
        return (OFF_V + y0 * W + x, OFF_V + (y1 + 1) * W + x, bucket)

    runs = [
        hrun(ym, xm - R, xm - 1, EW_IN),
        hrun(ym + 1, xm + 2, xm + 1 + R, EW_IN),
        vrun(xm, ym - R, ym - 1, NS_IN),
        vrun(xm + 1, ym + 2, ym + 1 + R, NS_IN),
        hrun(ym, xm + 2, xm + 1 + R, EW_OUT),
        hrun(ym + 1, xm - R, xm - 1, EW_OUT),
        vrun(xm, ym + 2, ym + 1 + R, NS_OUT),
        vrun(xm + 1, ym - R, ym - 1, NS_OUT),
        vrun(xm, ym, ym + 1, CLEAR),
        vrun(xm + 1, ym, ym + 1, CLEAR),
    ]
    gs.valid[0] = True
    put(gs.bbox, [[xm, xm + 1, ym, ym + 1]])
    gs.intersection_size[0] = 4 / 16
    put(gs.run_lo, [r[0] for r in runs])
    put(gs.run_hi, [r[1] for r in runs])
    put(gs.run_seg, [0 * 5 + r[2] for r in runs])

    # queue label planes (per-cell path parity with the run tables)
    qg = np.full((H, W), -1, np.int32)
    qb = np.full((H, W), -1, np.int8)
    for _, run, ax in approaches:
        for (y, x) in run:
            qg[y, x] = 0
            qb[y, x] = NS_IN if ax == 0 else EW_IN
    for (y, x) in ((ym, xm), (ym, xm + 1), (ym + 1, xm), (ym + 1, xm + 1)):
        qg[y, x] = 0
        qb[y, x] = CLEAR

    # ---- blocks and destinations ------------------------------------------
    d_ent0, d_ent1 = 0, 1
    exit_ids = list(range(2, 2 + len(hw_out)))
    bs.valid[:2] = True
    put(bs.btype, [C.RESIDENTIAL, C.MARKET])
    bs.inner_count[:2] = 4
    put(bs.entrance, [flat(ent0), flat(ent1)])
    put(bs.dest, [d_ent0, d_ent1])
    bs.food_cap[:2] = 4 * cfg.FOOD_CAPACITY_PER_CELL
    bs.waste_cap[:2] = 4 * cfg.WASTE_CAPACITY_PER_CELL
    bs.needs_food[:2] = True
    bs.produces_waste[:2] = True
    dpos = [flat(ent0), flat(ent1)] + [flat(p) for p in hw_out]
    dests.valid[:len(dpos)] = True
    put(dests.pos, dpos)
    put(dests.kind, [0, 0] + [1] * len(hw_out))
    put(dests.block, [0, 1] + [-1] * len(hw_out))
    put(dests.hw_pos, [flat(p) for p in hw_in])
    dests.hw_valid[:len(hw_in)] = True

    dest_plane = np.full((H, W), -1, np.int32)
    for i, p in enumerate(dpos):
        dest_plane[p // W, p % W] = i

    grid = Grid(
        cell_type=_t(cell, dev), orig_type=_t(orig, dev),
        allowed_dirs=_t(dirs, dev), road_class=_t(rc, dev),
        is_road=_t(np.isin(cell, C.ROAD_LIKE), dev),
        intersection=_t(cell == C.INTERSECTION, dev),
        group_id=_t(np.where(cell == C.INTERSECTION, 0, -1).astype(np.int32),
                    dev),
        block_id=_t(np.full((H, W), -1, np.int32), dev),
        light_id=_t(light_id_plane, dev), dest_id=_t(dest_plane, dev),
        queue_group=_t(qg, dev), queue_bucket=_t(qb, dev))

    # ---- demand: interleaved internal (block -> block) and through trips --
    T = caps.max_trips
    n_trips = min(n_trips, T)
    rng = np.random.default_rng(7)
    origin = np.zeros((T,), np.int32)
    ddest = np.zeros((T,), np.int32)
    kind = np.zeros((T,), np.uint8)
    valid = np.zeros((T,), bool)
    depart = np.full((T,), 2 ** 20 - 1, np.int32)
    # reachability per origin given the lane and turn graph above
    reach = {flat(hw_in[0]): [d_ent0, exit_ids[0], exit_ids[1]],
             flat(hw_in[1]): [d_ent1, exit_ids[0], exit_ids[1]],
             flat(hw_in[2]): [exit_ids[2], exit_ids[1], exit_ids[0]],
             flat(hw_in[3]): [exit_ids[3], exit_ids[0], exit_ids[1]],
             flat(ent0): [exit_ids[0], exit_ids[1], d_ent1],
             flat(ent1): [exit_ids[1], exit_ids[0]]}
    origins = list(reach.keys())
    for i in range(n_trips):
        o = origins[rng.integers(len(origins))]
        origin[i] = o
        ddest[i] = reach[o][rng.integers(len(reach[o]))]
        kind[i] = 0 if o in (flat(ent0), flat(ent1)) else 1
        valid[i] = True
        depart[i] = 1 + i // 2
    demand = Demand(
        depart_tick=_t(depart, dev), origin=_t(origin, dev),
        dest=_t(ddest, dev), kind=_t(kind, dev), valid=_t(valid, dev),
        cursor=torch.zeros((), dtype=torch.int32, device=dev),
        day=torch.zeros((), dtype=torch.int32, device=dev))
    key_t = _t(np.asarray(key, np.uint32).reshape(2).view(np.int32), dev)
    return assemble_world(cfg, grid, ls, gs, bs, dests, demand, key_t)
