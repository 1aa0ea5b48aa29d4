# Frozen copy of trafficsimulation_tpu_torch/ops/megakernel.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
"""The routing segment as one K9 call: R = PATHFINDING_COOLDOWN ticks of
lights, decide + move and the post-move tail with the state kept on the
card (the JAX package's `ops/megakernel.py`; its module docstring gives
the design and the reference semantics).

  `build_chunk_static`  the chunk's geometry tables: the one-hot run
                        matrices of the queue counts and the stop paint
                        (JAX's form, which the plain version multiplies
                        in f32), the same runs as rectangles (the
                        kernel's form) with the kernel's owner table of
                        its light stages (`light_owner_table`), the
                        light / group tables and the static planes of
                        the plane-space service tail
  `prepare_segment`     what the segment's ticks take from outside the
                        lattice: the random seeds and rain draws (rows
                        of `engine.tick_chain`), the rain maps (rain has
                        no feedback from traffic) and the spawn schedule
                        (the cursor never depends on the lattice)
  `segment_plain`       the plain version of K9: the R ticks in torch ops,
                        its light stages those of the per-tick path
                        (`lights/fsm.py`) on the group and light rows
  `run_segment_mega`    one segment: the schedule, one K9 call
                        (`plain.mega_segment`), and the engine
                        state rebuilt from its outputs with the metrics
                        folded tick by tick
  `mega_ok`             the gate of `sim.advance`'s megakernel branch

The JAX kernel's reductions are int8 one-hot matrix products for the MXU
(Mosaic has no gather).  The plain version computes the queue counts and
the stop paint with the same run matrices in f32 products (exact: 0/1
operands, counts far below 2^24; torch on the card has no integer
matmul), including the int8 wrap of each queue run's count
(`_queue_reductions`); the controllers and the phase commit gather, as
`lights/fsm.py` does, so JAX's light / group and neighbour one-hots have
no counterpart here.  The CUDA kernel (`csrc/megakernel.cu`) walks the
run rectangles instead.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from .. import codes as C
from ..config import Config

from ..agents.rain import step_rain_ticks
from ..core.state import LightsState, Overrides
from ..lights import fsm
from . import engine
from . import plain as HE
from .plain import (PA_KIND_SH, PA_PARKED_SH, PA_DEST_SH,
                            PC_DEPART_SH, PC_STEPS_SH, PD_PHASE_SH,
                            PD_TIMER_SH, PD_BLOCK_SH, _bit, _fld, i32)
from .labels import set_last

KIND_INTERNAL, KIND_THROUGH, KIND_FOOD, KIND_WASTE = 0, 1, 2, 3
DEST_NONE = 16383
SVC_BLOCK_NONE = 16383

# stats row layout (f32 [R, N_STATS])
(ST_DONE_I, ST_DONE_T, ST_DUR_I, ST_DUR_T, ST_STEPS_I, ST_STEPS_T,
 ST_DONE_SVC, ST_DUR_SVC, ST_STEPS_SVC, ST_NEW_MAL, ST_NEW_COL,
 ST_KILL_I, ST_KILL_T, ST_DROP_I, ST_DROP_T) = range(15)
N_STATS = 16

# light state rows: li int32 [9, G], lf f32 [2, G]
LI_FIELDS = ("current_phase", "pending_phase", "transition_timer",
             "clearance_timer", "ft_phase", "fixed_time_timer",
             "queue_timer", "gap_timer", "last_arrival")
LI_CUR, LI_PEND, LI_TRANS, LI_CLEAR, LI_FT, LI_FTT, LI_QT, LI_GAP, \
    LI_LASTARR = range(9)
LF_NSP, LF_EWP = range(2)

# columns of the kernel's per-tick scalar table `ticks` (int32 [R, 8])
TK_SEED, TK_TICK, TK_SVC0, TK_FDUE, TK_WDUE = 0, 4, 5, 6, 7

_BIG = 1 << 30


def _i8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int8)


def _wrap8(x: torch.Tensor) -> torch.Tensor:
    """int32 -> the int8 value with the same low byte (XLA's s32 -> s8
    convert), as int32."""
    return ((x + 128) & 255) - 128


# ---------------------------------------------------------------------------
# Chunk-static tables
# ---------------------------------------------------------------------------


def _run_rects(lo, hi, H: int, W: int):
    """Decode prefix-buffer run indices (`fsm.group_reductions` layout:
    the H-section [H, W+1] first, then the V-section [H+1, W]) into
    rectangles: (is_h, y, x0, x1, x, y0, y1); a horizontal run spans row
    y, cols [x0, x1), a vertical one col x, rows [y0, y1)."""
    NH = H * (W + 1)
    is_h = lo < NH
    y = lo // (W + 1)
    x0 = lo % (W + 1)
    x1 = hi % (W + 1)
    lo2 = torch.clamp(lo - NH, min=0)
    hi2 = torch.clamp(hi - NH, min=0)
    return is_h, y, x0, x1, lo2 % W, lo2 // W, hi2 // W


def _rect_table(valid, is_h, y, x0, x1, x, y0, y1, *extra):
    """The kernel's run rows: orientation (0 none, 1 vertical, 2
    horizontal), the fixed coordinate, the span [a0, a1), then `extra`
    columns."""
    orient = torch.where(valid, torch.where(is_h, 2, 1), 0)
    cols = [orient, torch.where(is_h, y, x), torch.where(is_h, x0, y0),
            torch.where(is_h, x1, y1), *extra]
    return torch.stack([c.to(torch.int32) for c in cols], dim=1) \
        .contiguous()


def build_chunk_static(cfg: Config, world) -> dict:
    """Every geometry-derived input of the segment kernel that is fixed
    for a chunk (the JAX `build_chunk_static`; its keys and values but
    the one-hots that only its row-form light stages read, `ogl`,
    `l_hasgrp` and `neigh`, plus the kernel's rectangle tables `qrun`
    [R, 6] and `srun` [S, 5], the light -> group table `l_group` (-1 for
    a light without a group), the group neighbours `nbr` and the
    intersection mask `inter`).  The block planes put each block's values
    at its service-arrival cell; two blocks sharing a cell leave the
    last block's values there, as XLA's CPU scatter does."""
    H, W = cfg.HEIGHT, cfg.WIDTH
    HW = H * W
    grid = world.grid
    gs, ls, bs, dests = (world.groups_static, world.lights_static,
                         world.blocks_static, world.dests)
    dev = grid.is_road.device
    G = world.lights.current_phase.shape[-1]
    L = ls.valid.shape[0]
    DF = world.cost_field.shape[0]
    i32t = torch.int32
    iota_h = torch.arange(H, dtype=i32t, device=dev)
    iota_w = torch.arange(W, dtype=i32t, device=dev)

    # ---- queue runs ------------------------------------------------------
    valid_r = gs.run_seg >= 0
    is_h, ry, rx0, rx1, rx, ry0, ry1 = _run_rects(
        torch.clamp(gs.run_lo, min=0), torch.clamp(gs.run_hi, min=0), H, W)
    vmask = valid_r & ~is_h
    hmask = valid_r & is_h
    seg_g = torch.where(valid_r, gs.run_seg // 5, 0)
    seg_b = torch.where(valid_r, gs.run_seg % 5, 0)
    q_cv = _i8(vmask[None, :] & (iota_w[:, None] == rx[None, :]))
    q_rmv = _i8(vmask[None, :] & (iota_h[:, None] >= ry0[None, :])
                & (iota_h[:, None] < ry1[None, :]))
    q_rh = _i8(hmask[:, None] & (iota_h[None, :] == ry[:, None]))
    q_cmh = _i8(hmask[:, None] & (iota_w[None, :] >= rx0[:, None])
                & (iota_w[None, :] < rx1[:, None]))
    gid = torch.arange(G, dtype=i32t, device=dev)
    q_og = _i8(valid_r[:, None] & (seg_g[:, None] == gid[None, :]))
    bq = _i8((torch.arange(8, dtype=i32t, device=dev)[:, None]
              == seg_b[None, :]) & valid_r[None, :])
    qrun = _rect_table(valid_r & (seg_g < G), is_h, ry, rx0, rx1, rx, ry0,
                       ry1, seg_g, seg_b)

    # ---- stop runs, with the extra cells as 1-cell horizontal runs ------
    ex_ok = ls.sextra_cell >= 0
    ex_c = torch.clamp(ls.sextra_cell, min=0)
    ex_lo = (ex_c // W) * (W + 1) + ex_c % W
    s_lo = torch.cat([ls.srun_lo, torch.where(ex_ok, ex_lo, -1)])
    s_hi = torch.cat([ls.srun_hi, torch.where(ex_ok, ex_lo + 1, -1)])
    s_light = torch.cat([ls.srun_light,
                         torch.where(ex_ok, ls.sextra_light, -1)])
    s_valid = s_light >= 0
    sis_h, sy, sx0, sx1, sx, sy0, sy1 = _run_rects(
        torch.clamp(s_lo, min=0), torch.clamp(s_hi, min=0), H, W)
    svm = s_valid & ~sis_h
    shm = s_valid & sis_h
    s_rmv = _i8(svm[None, :] & (iota_h[:, None] >= sy0[None, :])
                & (iota_h[:, None] < sy1[None, :]))
    s_cv = _i8(svm[:, None] & (iota_w[None, :] == sx[:, None]))
    s_rh = _i8(shm[None, :] & (iota_h[:, None] == sy[None, :]))
    s_cmh = _i8(shm[:, None] & (iota_w[None, :] >= sx0[:, None])
                & (iota_w[None, :] < sx1[:, None]))
    lid = torch.arange(L, dtype=i32t, device=dev)
    s_ol = _i8(s_valid[None, :] & (s_light[None, :] == lid[:, None]))
    srun = _rect_table(s_valid & (s_light < L), sis_h, sy, sx0, sx1, sx,
                       sy0, sy1, s_light)

    l_hasgrp = ls.valid & (ls.group >= 0)

    # ---- static planes -------------------------------------------------
    Dall = dests.pos.shape[0]
    dpos = torch.clamp(dests.pos, 0, HW - 1)
    sink = torch.where(dests.valid, dpos, HW)

    def plane(idx, vals, fill, dtype=i32t):
        buf = torch.full((HW + 1,), fill, dtype=dtype, device=dev)
        return set_last(buf, idx, vals.to(dtype))[:HW].reshape(H, W)

    svc_target = torch.where((bs.service_dest >= 0) & (bs.service_dest < DF),
                             bs.service_dest, bs.dest)
    blk_ok = (svc_target >= 0) & (svc_target < DF)
    home_dest = torch.where(svc_target >= 0, svc_target, bs.dest)
    has_home = bs.valid & (home_dest >= 0)
    bcell = torch.where(has_home,
                        dpos[torch.clamp(home_dest, 0, Dall - 1).long()], HW)
    B = bs.valid.shape[0]
    # the blocks whose values a cell keeps (the last of several blocks on
    # one cell); the others write to the sink HW
    bid = torch.arange(B, device=dev)
    last = torch.full((HW + 1,), -1, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, bcell.long(), bid, "amax", include_self=True)
    bhome = torch.where((bcell < HW) & (last[bcell.long()] == bid), bcell,
                        HW).long()

    def bplane(vals, fill, dtype=i32t):
        return plane(bhome, vals, fill, dtype)

    f32 = torch.float32
    cs = dict(
        q_cv=q_cv, q_rmv=q_rmv, q_rh=q_rh, q_cmh=q_cmh, q_og=q_og, bq=bq,
        s_rmv=s_rmv, s_cv=s_cv, s_rh=s_rh, s_cmh=s_cmh, s_ol=s_ol,
        g_inter=grid.intersection.to(i32t),
        g_destid=grid.dest_id,
        g_destkind1=plane(sink, dests.kind == 1, 0),
        g_nexit=plane(sink, world.nearest_exit, -1),
        g_exitcell=(grid.cell_type == C.HIGHWAY_EXIT).to(i32t),
        b_mask=bplane(has_home, 0),
        b_ok=bplane(blk_ok & has_home, 0),
        b_bid=bplane(torch.arange(B, device=dev), -1),
        b_svcdest=bplane(torch.where(svc_target >= 0, svc_target, 0), 0),
        b_needs=bplane(bs.needs_food & has_home, 0),
        b_prod=bplane(bs.produces_waste & has_home, 0),
        b_inner=bplane(bs.inner_count.to(f32), 0.0, f32),
        b_fcap=bplane(bs.food_cap, 0.0, f32),
        b_wcap=bplane(bs.waste_cap, 0.0, f32),
        l_valid=ls.valid.to(i32t)[None],
        l_axis=ls.axis.to(i32t)[None],
        gg_valid=gs.valid.to(i32t)[None],
        bcell=bcell, has_home=has_home, bhome=bhome,
        svc0=torch.where((svc_target[0] >= 0) & (svc_target[0] < DF),
                         svc_target[0], bs.dest[0]).to(i32t),
        # the kernel's forms
        qrun=qrun, srun=srun,
        lown=light_owner_table(qrun, srun, torch.where(
            l_hasgrp, ls.group, -1).to(i32t), G),
        l_group=torch.where(l_hasgrp, ls.group, -1).to(i32t).contiguous(),
        nbr=gs.neighbor.to(i32t).contiguous(),
        inter=grid.intersection.contiguous(),
    )
    return cs


def light_owner_table(qrun, srun, l_group, G: int) -> torch.Tensor:
    """K9's owner table of its light stages, int32: the queue runs, the
    lights and the stop runs grouped by pseudo-group, as offsets `qoff`,
    `loff`, `soff` [G + 3] each, then the run, light and stop-run indices
    in group order [NQ], [L], [NS].  Pseudo-group g < G is a light group
    (a stop run belongs to its light's group); a light of no group l goes
    with pseudo-group l mod (G + 1), so that such lights spread over the
    blocks; G + 1 holds the runs that cover no cell (orientation 0),
    which no block takes.  Of a world's `nb` blocks, the kernel's block j
    takes the contiguous pseudo-groups [j (G + 1) / nb, (j + 1) (G + 1)
    / nb) (`group_owner`), so each group's counts, controller, lights and
    paint stay in one block, and each block's items are one range of
    each index list (`light_owners`)."""
    dev = qrun.device
    L = l_group.shape[0]
    lgrp = torch.where((l_group >= 0) & (l_group < G), l_group,
                       torch.arange(L, device=dev) % (G + 1))
    qg = qrun[:, 4]
    qgrp = torch.where((qrun[:, 0] != 0) & (qg >= 0) & (qg < G), qg, G + 1)
    sl = srun[:, 4]
    sok = (srun[:, 0] != 0) & (sl >= 0) & (sl < L)
    sgrp = torch.where(sok, lgrp[torch.clamp(sl, 0, max(L - 1, 0)).long()]
                       if L else torch.full_like(sl, G), G + 1)
    offs, idxs = [], []
    for grp in (qgrp, lgrp, sgrp):
        grp = grp.long()
        cnt = torch.zeros((G + 2,), dtype=torch.int64, device=dev) \
            .scatter_add(0, grp, torch.ones_like(grp))
        offs.append(torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)]))
        idxs.append(torch.sort(grp, stable=True).indices)
    return torch.cat(offs + idxs).to(torch.int32)


# ---------------------------------------------------------------------------
# Per-segment schedule
# ---------------------------------------------------------------------------


def prepare_segment(cfg: Config, world, es, R: int,
                    draws: torch.Tensor) -> dict:
    """What the segment's R ticks take from outside the lattice (the JAX
    `prepare_segment`): `draws` int64 [R, N_DRAWS] holds the ticks' rows
    of `engine.tick_draws`, the same rows the per-tick path consumes
    (the key is advanced by the caller).  Returns the seeds (int32 bits
    [R, 4]), the elapsed time after each tick, the rain map each tick
    reads (bool [R, H, W]) and the final rain, the spawn planes of each
    tick (`spawn_pa` the packed word or 0, `spawn_pe` the pool slot or
    -1), the trips created and dropped before placement per tick, and
    the final demand cursor."""
    H, W = cfg.HEIGHT, cfg.WIDTH
    HW = H * W
    caps = cfg.capacities()
    S = caps.max_spawns_per_tick
    V = caps.max_vehicles
    dt = float(cfg.TIME_PER_STEP_IN_SECONDS)
    dev = es.pa.device
    i32t = torch.int32
    D0 = engine.D_SEEDS
    seeds = engine._to_i32(draws[:, D0:D0 + 4])

    # rain: no feedback from traffic, the whole segment now
    rain, rmaps = step_rain_ticks(
        cfg, H, W, es.rain, draws[:, engine.D_RAIN:engine.D_RAIN + 5],
        force_spawn=es.overrides.spawn_rain)

    # spawn schedule: failed spawns consume their slot too, so the cursor
    # and the slot window do not depend on the lattice.  Tick t's due
    # trips are the run of consecutive valid, departed trips from its
    # cursor, at most S; they lie in the window of R * S trips from the
    # segment's cursor, and so do their slots in the compacted free list.
    dem = world.demand
    T = dem.depart_tick.shape[0]
    slots0 = engine.free_slots(es.slot_used, (R + 1) * S)
    win = torch.arange(R * S, device=dev)
    idx = es.dem_cursor + win
    j = torch.clamp(idx, 0, T - 1).long()
    # the first tick of the segment at which each trip is due
    first = torch.where((idx < T) & dem.valid[j],
                        torch.clamp(dem.depart_tick[j] - es.tick - 1, min=0),
                        R)
    if not cfg.ENABLE_TRAFFIC:
        first = torch.full_like(first, R)
    # stop[t, w]: the first trip from w on that is not yet due at tick t
    # (R * S past the window), so a tick's run is one gather
    ticks = torch.arange(R, device=dev)[:, None]
    stop = torch.where(first[None, :] > ticks, win[None, :], R * S)
    stop = torch.cat([stop.flip(1).cummin(1).values.flip(1),
                      torch.full((R, 1), R * S, dtype=stop.dtype,
                                 device=dev)], dim=1)        # [R, R*S + 1]
    off = torch.zeros((1,), dtype=torch.int64, device=dev)
    offs, counts = [], []
    for t in range(R):
        n = torch.clamp(stop[t].gather(0, off) - off, max=S)
        offs.append(off)
        counts.append(n)
        off = off + n
    sidx = torch.arange(S, device=dev)
    pos = torch.cat(offs)[:, None] + sidx[None, :]             # [R, S]
    due = sidx[None, :] < torch.cat(counts)[:, None]
    jj = j[pos]
    slots = slots0[pos]
    can = due & (slots >= 0)
    org = torch.clamp(dem.origin[jj], 0, HW - 1)
    kind = dem.kind[jj].to(i32t)
    # same-tick same-cell dedup, the lowest index wins (the static part of
    # placement; the occupancy check runs in the kernel)
    dup = ((org[:, None, :] == org[:, :, None])
           & (sidx[None, :] < sidx[:, None]) & can[:, None, :]).any(dim=2) \
        & can
    place = can & ~dup
    dest = torch.where(kind <= KIND_THROUGH, dem.dest[jj], -1)
    dest = torch.where(dest < 0, DEST_NONE,
                       torch.clamp(dest, max=DEST_NONE - 1))
    pa_v = (1 | (kind << PA_KIND_SH) | (dest << PA_DEST_SH)).to(i32t)
    # placed cells of a tick are distinct after the dedup: a plain
    # scatter into each tick's plane (HW its sink)
    rows = torch.arange(R, device=dev)[:, None] * (HW + 1)
    cell = (torch.where(place, org, HW) + rows).reshape(-1).long()
    spa = torch.zeros((R * (HW + 1),), dtype=i32t, device=dev).index_put(
        (cell,), pa_v.reshape(-1))
    spe = torch.full((R * (HW + 1),), -1, dtype=i32t, device=dev).index_put(
        (cell,), torch.clamp(slots, 0, V - 1).to(i32t).reshape(-1))
    kinds = torch.arange(4, device=dev)
    created = ((kind[..., None] == kinds) & can[..., None]).sum(dim=1)
    lost = dup | (due & (slots < 0))
    drop_static = torch.stack([(lost & (kind == KIND_INTERNAL)).sum(dim=1),
                               (lost & (kind != KIND_INTERNAL)).sum(dim=1)],
                              dim=1)
    elapsed = es.elapsed + dt * (1 + torch.arange(R, dtype=torch.float32,
                                                  device=dev))
    return dict(
        seeds=seeds, elapsed=elapsed,
        rain_planes=torch.cat([es.rain_map[None], rmaps[:R - 1]]),
        final_rain=rain, final_rain_map=rmaps[R - 1],
        spawn_pa=spa.reshape(R, HW + 1)[:, :HW].reshape(R, H, W)
        .contiguous(),
        spawn_pe=spe.reshape(R, HW + 1)[:, :HW].reshape(R, H, W)
        .contiguous(),
        created=created.to(i32t), drop_static=drop_static.to(i32t),
        final_cursor=es.dem_cursor + off[0].to(i32t))


# ---------------------------------------------------------------------------
# The plain version of K9
# ---------------------------------------------------------------------------


def _dot(row: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """row @ mat in f32 (exact for the 0/1 and small integer operands
    here)."""
    return torch.matmul(row.to(torch.float32), mat)


def _light_tables(a: dict):
    """The group and light tables `fsm.run_controllers` and
    `fsm.execute_phase_change` read, from K9's inputs."""
    gs = SimpleNamespace(valid=a["gg_valid"][0] != 0, neighbor=a["nbr"])
    ls = SimpleNamespace(valid=a["l_valid"][0] != 0, group=a["l_group"],
                         axis=a["l_axis"][0])
    return gs, ls


def _queue_reductions(occ, m: dict):
    """Per-group (ns_in, ns_out, ew_in, ew_out) counts and the
    intersection-occupied flag from the run matrices (the JAX
    `_queue_reductions`, in f32).  Each run's count wraps to int8 before
    the group sum, as the JAX kernel's `_i8(cnt * bq)` does."""
    occ = occ.to(torch.float32)
    cntv = ((occ @ m["q_cv"]) * m["q_rmv"]).sum(dim=0)
    cnth = ((m["q_rh"] @ occ) * m["q_cmh"]).sum(dim=1)
    cnt = _wrap8((cntv + cnth).to(torch.int32))   # a run is one or other
    q = [(_dot(cnt * m["bq_i"][b], m["q_og"])).to(torch.int32)
         for b in range(5)]
    return q[0], q[1], q[2], q[3], q[4] > 0


def _stop_map_paint(lstop, m: dict):
    """The stop plane from the lights' stop flags: a cell stops when a
    stopped light's run covers it (the JAX `_stop_map_paint`)."""
    stopped = _dot(lstop, m["s_ol"])                          # [S]
    pv = (m["s_rmv"] * stopped) @ m["s_cv"]
    ph = (m["s_rh"] * stopped) @ m["s_cmh"]
    return (pv + ph) > 0


def _blk_argmax(val, b_mask, b_ok, b_bid, b_svcd, fallback):
    """The neediest block over the block planes: the largest value, ties
    to the lowest block id; no candidate above -1 gives block 0 and the
    fallback destination (the table argmax's slot 0).  Returns (value,
    block, destination)."""
    msk = torch.where(b_ok, val, -1.0)
    m = msk.max()
    win = b_mask & b_ok & (msk == m)
    bid = torch.where(win, b_bid, _BIG).min()
    d = torch.where(win & (b_bid == bid), b_svcd, _BIG).min()
    degen = m <= -1.0
    return m, torch.where(degen, 0, bid), torch.where(degen, fallback, d)


PLANES = ("pa", "pb", "pc", "pd", "pe", "pl")
TANKS = ("food", "waste", "frem", "wrem")
OUTPUTS = PLANES + ("stop",) + TANKS + ("li", "lf", "lstop", "stats")


def segment_plain(cfg: Config, a: dict) -> dict:
    """Plain version of K9 (the JAX `_mega_kernel`'s R grid steps as torch
    ops): `a` holds the chunk tables of `build_chunk_static`, this
    segment's `sdir4` / `wnd`, the streams (`ticks` int32 [R, 8],
    `elapsed` f32 [R], `rain` bool [R, H, W], `spawn_pa` / `spawn_pe`
    int32 [R, H, W], `force` int32 [L]) and the carry (planes pa..pl,
    block tanks on their cells, `li` int32 [9, G], `lf` f32 [2, G],
    `lstop` bool [L]).  Returns the carry after R ticks, the last stop
    plane and the stats rows f32 [R, N_STATS]."""
    H, W = a["pa"].shape
    R = a["ticks"].shape[0]
    dt = float(cfg.TIME_PER_STEP_IN_SECONDS)
    f32 = torch.float32
    dev = a["pa"].device
    m = {k: a[k].to(f32) for k in ("q_cv", "q_rmv", "q_rh", "q_cmh", "q_og",
                                   "s_rmv", "s_cv", "s_rh", "s_cmh", "s_ol")}
    m["bq_i"] = a["bq"].to(torch.int32)
    gs, ls = _light_tables(a)
    inter, destid = a["g_inter"] != 0, a["g_destid"]
    b_mask, b_ok = a["b_mask"] != 0, a["b_ok"] != 0
    b_needs, b_prod = a["b_needs"] != 0, a["b_prod"] != 0
    b_bid, b_svcd = a["b_bid"], a["b_svcdest"]
    b_fcap, b_wcap, inner = a["b_fcap"], a["b_wcap"], a["b_inner"]
    exitcell, destk1 = a["g_exitcell"] != 0, a["g_destkind1"] != 0
    nexit = a["g_nexit"]
    ticks = a["ticks"]
    zeros_b = torch.zeros((H, W), dtype=torch.bool, device=dev)
    maxw = cfg.SERVICE_VEHICLE_MAX_LOAD_WASTE

    pa, pb, pc, pd, pe, pl = (a[k] for k in PLANES)
    food, waste, frem, wrem = (a[k] for k in TANKS)
    li, lf = a["li"], a["lf"]
    lights = LightsState(**{f: li[k] for k, f in enumerate(LI_FIELDS)},
                         ns_pressure=lf[LF_NSP], ew_pressure=lf[LF_EWP],
                         rl_timer=torch.zeros_like(li[LI_CUR]),
                         light_stop=a["lstop"])
    stats = []
    for t in range(R):
        # ---- lights -------------------------------------------------------
        q = _queue_reductions(pa & 1, m)
        lights = fsm.run_controllers(cfg, None, gs, lights, None,
                                     reductions=q[:4])
        lights = fsm.execute_phase_change(cfg, ls, gs, lights, q[4])
        if t == 0:   # host overrides hold for the segment's first tick
            lights = fsm.apply_light_overrides(lights, a["force"])
        stop_map = _stop_map_paint(lights.light_stop, m)

        # ---- decide + move ------------------------------------------------
        seeds = ticks[t, TK_SEED:TK_SEED + 4].to(torch.int64) & 0xFFFFFFFF
        randoms = engine.tick_randoms(cfg, seeds, H, W)
        pa, pb, pc, pd, pe, pl, flags = HE.decide_move_core(
            cfg, a["sdir4"], a["wnd"], pa, pb, pc, pd, pe, pl, stop_map,
            a["rain"][t], zeros_b, inter, destid, *randoms)
        n_new_mal = (flags & HE.FLAG_NEW_MAL).sum()
        n_new_col = ((flags & HE.FLAG_NEW_COL) >> 1).sum()

        # ---- arrivals ------------------------------------------------------
        elapsed_t = a["elapsed"][t]
        tick_t = ticks[t, TK_TICK]
        present = (pa & 1) == 1
        kind = _fld(pa, PA_KIND_SH, 2)
        dest14 = _fld(pa, PA_DEST_SH, 14)
        at_dest = present & (destid >= 0) & (dest14 == destid)
        phase0 = _fld(pd, PD_PHASE_SH, 2)
        dur = elapsed_t - _fld(pc, PC_DEPART_SH, 20).to(f32) * dt
        steps = _fld(pc, PC_STEPS_SH, 12).to(f32)
        done_i = at_dest & (kind == KIND_INTERNAL)
        done_t = at_dest & (kind == KIND_THROUGH)
        svc_done = at_dest & (kind >= KIND_FOOD) & (phase0 == 2) & exitcell

        # ---- service FSM at the block cells --------------------------------
        is_svc = at_dest & (kind >= KIND_FOOD)
        sb_raw = _fld(pd, PD_BLOCK_SH, 14)
        arrive = is_svc & (phase0 == 0)
        shortage = torch.where(b_mask & b_needs, b_fcap - food, -1.0)
        surplus = torch.where(b_mask & b_prod, waste, -1.0)
        give = torch.where(arrive & (kind == KIND_FOOD), torch.minimum(
            pl, torch.clamp(shortage, min=0.0)), 0.0)
        take = torch.where(arrive & (kind == KIND_WASTE), torch.minimum(
            maxw - pl, torch.clamp(surplus, min=0.0)), 0.0)
        food = torch.minimum(torch.clamp(food + give, min=0.0), b_fcap)
        waste = torch.minimum(torch.clamp(waste - take, min=0.0), b_wcap)
        pl = pl - give + take
        parked = _bit(pa, PA_PARKED_SH) | arrive
        phase = torch.where(arrive, 1, phase0)
        timer = torch.where(arrive, cfg.SERVICE_VEHICLE_LOAD_TIME,
                            _fld(pd, PD_TIMER_SH, 8))
        servicing = is_svc & (phase == 1) & ~arrive
        timer = torch.where(servicing, timer - 1, timer)
        finish = servicing & (timer <= 0)
        more = torch.where(kind == KIND_FOOD, pl > 0, pl < maxw)
        svc0 = ticks[t, TK_SVC0]
        blk = (b_mask, b_ok, b_bid, b_svcd, svc0)
        mf, bidf, df = _blk_argmax(shortage, *blk)
        mw, bidw, dw = _blk_argmax(surplus, *blk)
        is_food = kind == KIND_FOOD
        go_again = finish & more & torch.where(is_food, mf > 0, mw > 0)
        go_exit = finish & ~go_again
        new_dest = torch.where(go_again, torch.where(is_food, df, dw),
                               torch.where(go_exit, nexit, dest14))
        new_dest = torch.where(new_dest < 0, DEST_NONE,
                               torch.clamp(new_dest, max=DEST_NONE))
        new_sb = torch.where(go_again, torch.where(is_food, bidf, bidw),
                             sb_raw)
        phase = torch.where(go_again, 0, torch.where(go_exit, 2, phase))
        parked = parked & ~finish
        pa_svc = (pa & i32(~((1 << PA_PARKED_SH)
                             | (DEST_NONE << PA_DEST_SH)))) \
            | (parked.to(torch.int32) << PA_PARKED_SH) \
            | (torch.clamp(new_dest, 0, DEST_NONE) << PA_DEST_SH)
        pd_svc = (phase | (torch.clamp(timer, 0, 255) << PD_TIMER_SH)
                  | (new_sb << PD_BLOCK_SH))
        pa = torch.where(is_svc, pa_svc, pa)
        pd = torch.where(is_svc, pd_svc, pd)

        # ---- despawns (stuck despawn is off under the gate) ---------------
        despawn = at_dest & ((kind <= KIND_THROUGH) | (
            (kind >= KIND_FOOD) & (phase == 2) & destk1))
        pa, pb, pc, pd, pe = (torch.where(despawn, 0, p)
                              for p in (pa, pb, pc, pd, pe))
        pl = torch.where(despawn, 0.0, pl)

        # ---- spawns (scheduled; the live occupancy check here) ------------
        spa, spe = a["spawn_pa"][t], a["spawn_pe"][t]
        has_spawn = spe >= 0
        occupied = present & ~despawn
        place = has_spawn & ~occupied
        kind_s = _fld(spa, PA_KIND_SH, 2)
        drop_i = (has_spawn & occupied & (kind_s == KIND_INTERNAL)).sum()
        drop_t = (has_spawn & occupied & (kind_s != KIND_INTERNAL)).sum()
        _, bidf2, df2 = _blk_argmax(
            torch.where(b_mask & b_needs, b_fcap - food, -1.0), *blk)
        _, bidw2, dw2 = _blk_argmax(
            torch.where(b_mask & b_prod, waste, -1.0), *blk)
        s_food = kind_s == KIND_FOOD
        sdest = torch.where(s_food, df2, dw2)
        sdest = torch.where(sdest < 0, DEST_NONE,
                            torch.clamp(sdest, max=DEST_NONE - 1))
        is_svc_s = kind_s >= KIND_FOOD
        spawn_dest = torch.where(is_svc_s, sdest,
                                 _fld(spa, PA_DEST_SH, 14))
        spawn_pa = (spa & i32(~(DEST_NONE << PA_DEST_SH))) \
            | (spawn_dest << PA_DEST_SH)
        spawn_pd = torch.where(is_svc_s, torch.where(s_food, bidf2, bidw2),
                               SVC_BLOCK_NONE) << PD_BLOCK_SH
        spawn_pc = torch.clamp(tick_t + 1, 0, (1 << 20) - 1)
        spawn_pl = torch.where(s_food, float(
            cfg.SERVICE_VEHICLE_MAX_LOAD_FOOD), 0.0).to(f32)
        pa = torch.where(place, spawn_pa, pa)
        pb = torch.where(place, 0, pb)
        pc = torch.where(place, spawn_pc, pc)
        pd = torch.where(place, spawn_pd, pd)
        pe = torch.where(place, torch.clamp(spe, min=0), pe)
        pl = torch.where(place, spawn_pl, pl)

        # ---- block resources (`step_blocks` on the planes) ----------------
        if cfg.GRADUAL_CITY_BLOCK_RESOURCES:
            frate = inner * float(np.float32(1.0 / cfg.FOOD_CONSUMPTION_TICKS))
            wrate = inner * float(np.float32(1.0 / cfg.WASTE_PRODUCTION_TICKS))
            frem = frem + torch.where(b_mask & b_needs, frate, 0.0)
            fwhole = torch.floor(frem)
            food = torch.clamp(food - fwhole, min=0.0)
            frem = frem - fwhole
            wrem = wrem + torch.where(b_mask & b_prod, wrate, 0.0)
            wwhole = torch.floor(wrem)
            waste = torch.minimum(waste + wwhole, b_wcap)
            wrem = wrem - wwhole
        else:
            fdue = ticks[t, TK_FDUE] != 0
            wdue = ticks[t, TK_WDUE] != 0
            food = torch.where(b_mask & b_needs & fdue,
                               torch.clamp(food - inner, min=0.0), food)
            waste = torch.where(b_mask & b_prod & wdue,
                                torch.minimum(waste + inner, b_wcap), waste)

        # ---- stats row (ST_* order; no stuck kills under the gate) --------
        zf = torch.zeros((), dtype=f32, device=dev)
        stats.append(torch.stack([v.to(f32) for v in (
            done_i.sum(), done_t.sum(),
            torch.where(done_i, dur, zf).sum(),
            torch.where(done_t, dur, zf).sum(),
            torch.where(done_i, steps, zf).sum(),
            torch.where(done_t, steps, zf).sum(),
            svc_done.sum(), torch.where(svc_done, dur, zf).sum(),
            torch.where(svc_done, steps, zf).sum(), n_new_mal, n_new_col,
            zf, zf, drop_i, drop_t, zf)]))

    return dict(pa=pa, pb=pb, pc=pc, pd=pd, pe=pe, pl=pl, stop=stop_map,
                food=food, waste=waste, frem=frem, wrem=wrem,
                li=torch.stack([getattr(lights, f) for f in LI_FIELDS]),
                lf=torch.stack([lights.ns_pressure, lights.ew_pressure]),
                lstop=lights.light_stop, stats=torch.stack(stats))


# ---------------------------------------------------------------------------
# The segment runner and the gate
# ---------------------------------------------------------------------------


def mega_ok(cfg: Config, world) -> bool:
    """Gate of the megakernel branch (the JAX `mega_ok`): opt-in by
    TSIM_MEGA_FORCE (the card) or TSIM_MEGA_INTERPRET (also the CPU,
    where K9's wrapper runs its plain version), off under
    TSIM_NO_MEGAKERNEL; FSM light algorithms only, pedestrians,
    stuck-despawn and hierarchical routing off.  JAX's VMEM budget is
    the TPU's and has no counterpart here."""
    if os.environ.get("TSIM_NO_MEGAKERNEL"):
        return False
    interpret = bool(os.environ.get("TSIM_MEGA_INTERPRET"))
    if not (os.environ.get("TSIM_MEGA_FORCE") or interpret):
        return False
    if not cfg.USE_PALLAS_ENGINE:
        return False
    if cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM not in fsm.FSM_ALGOS:
        return False
    if cfg.PEDESTRIANS_ENABLED or cfg.VEHICLE_STUCK_DESPAWN_ENABLED:
        return False
    if cfg.ROUTING_HIER:
        return False
    return world.grid.is_road.device.type == "cuda" or interpret


# chunk tables that stay on the host side of K9
_HOST_KEYS = ("bcell", "has_home", "bhome", "svc0")


def run_segment_mega(cfg: Config, world, es, cs: dict, sdir, R: int,
                     draws: torch.Tensor):
    """Advance the engine state `es` by R ticks with one K9 call (the JAX
    `run_segment_mega`).  `cs` from `build_chunk_static`, `sdir` from
    `engine.routing_planes`, `draws` the ticks' rows of
    `engine.tick_draws` (int64 [R, N_DRAWS]); the key is left to the
    caller.  No host sync."""
    args, seg = segment_inputs(cfg, world, es, cs, sdir, R, draws)
    out = HE.mega_segment(cfg, args)
    return segment_state(cfg, es, cs, seg, out, sdir[2])


def segment_inputs(cfg: Config, world, es, cs: dict, sdir, R: int,
                   draws: torch.Tensor):
    """(K9's inputs as `segment_plain` takes them, the segment schedule
    of `prepare_segment`)."""
    H, W = cfg.HEIGHT, cfg.WIDTH
    dev = es.pa.device
    i32t = torch.int32
    sdir4, wnd, _ = sdir
    seg = prepare_segment(cfg, world, es, R, draws)

    tk = es.tick + torch.arange(R, dtype=i32t, device=dev)
    ticks = torch.stack([
        *seg["seeds"].unbind(1), tk, cs["svc0"].expand(R),
        (tk % cfg.FOOD_CONSUMPTION_TICKS == 0).to(i32t),
        (tk % cfg.WASTE_PRODUCTION_TICKS == 0).to(i32t)], dim=1)

    lt = es.lights
    bst = es.blocks
    # the carried tanks on their blocks' cells, one scatter for the four
    HW = H * W
    tanks = torch.zeros((4, HW + 1), dtype=torch.float32, device=dev) \
        .index_put((torch.arange(4, device=dev)[:, None], cs["bhome"][None]),
                   torch.stack([bst.food, bst.waste, bst.food_rem,
                                bst.waste_rem]))
    tanks = [t[:HW].reshape(H, W) for t in tanks]
    args = {k: v for k, v in cs.items() if k not in _HOST_KEYS}
    args.update(
        sdir4=sdir4, wnd=wnd, ticks=ticks.contiguous(),
        elapsed=seg["elapsed"], rain=seg["rain_planes"],
        spawn_pa=seg["spawn_pa"], spawn_pe=seg["spawn_pe"],
        force=es.overrides.light_force.to(i32t),
        pa=es.pa, pb=es.pb, pc=es.pc, pd=es.pd, pe=es.pe, pl=es.pl,
        **dict(zip(TANKS, tanks)),
        li=torch.stack([getattr(lt, f) for f in LI_FIELDS]),
        lf=torch.stack([lt.ns_pressure, lt.ew_pressure]),
        lstop=lt.light_stop)
    return args, seg


def segment_state(cfg: Config, es, cs: dict, seg: dict, out: dict,
                  density: torch.Tensor):
    """The engine state after the segment, from K9's outputs: lights,
    the tanks gathered back from their cells, the used pool slots from
    the final planes, and the metrics folded tick by tick."""
    HW = cfg.HEIGHT * cfg.WIDTH
    V = cfg.capacities().max_vehicles
    R = out["stats"].shape[0]
    dt = float(cfg.TIME_PER_STEP_IN_SECONDS)
    dev = es.pa.device
    lt = es.lights
    bcell = cs["bcell"]
    li, lf = out["li"], out["lf"]
    lights = lt.replace(**{f: li[k] for k, f in enumerate(LI_FIELDS)},
                        ns_pressure=lf[LF_NSP], ew_pressure=lf[LF_EWP],
                        light_stop=out["lstop"])
    fields = ("food", "waste", "food_rem", "waste_rem")
    bst = es.blocks
    cellc = torch.clamp(bcell, 0, HW - 1).long()
    tanks = torch.where(cs["has_home"],
                        torch.stack([out[k] for k in TANKS]).reshape(4, -1)
                        [:, cellc],
                        torch.stack([getattr(bst, f) for f in fields]))
    blocks = bst.replace(**dict(zip(fields, tanks)))
    pa, pe = out["pa"], out["pe"]
    slot = torch.where((pa.reshape(-1) & 1) == 1, pe.reshape(-1), V).long()
    slot_used = torch.zeros((V + 1,), dtype=torch.bool, device=dev) \
        .index_put((slot,), torch.ones((), dtype=torch.bool, device=dev))[:V]
    return es.replace(
        pa=pa, pb=out["pb"], pc=out["pc"], pd=out["pd"], pe=pe,
        pl=out["pl"], slot_used=slot_used, stop_map=out["stop"],
        rain_map=seg["final_rain_map"], density=density,
        lights=lights, blocks=blocks, rain=seg["final_rain"],
        dem_cursor=seg["final_cursor"],
        metrics=fold_metrics(cfg, es.metrics, out["stats"], seg),
        overrides=Overrides(
            light_force=torch.full_like(es.overrides.light_force, -1),
            spawn_rain=torch.zeros((), dtype=torch.bool, device=dev)),
        tick=es.tick + R, elapsed=es.elapsed + R * dt)


_COUNTERS = ("completed_internal", "completed_through", "completed_service",
             "sum_steps_internal", "sum_steps_through", "malfunctions_total",
             "collisions_total", "created_internal", "created_through",
             "created_service", "errored_internal", "errored_through")


def fold_metrics(cfg: Config, m, stats: torch.Tensor, seg: dict):
    """The metrics after the segment from the per-tick stats rows and the
    schedule's created / dropped counts, as JAX folds them tick by tick
    (`run_segment_mega`): the counters summed at once, the day rollover
    in closed form, the f32 duration sums in tick order; tensor ops
    only."""
    i32t = torch.int32
    R = stats.shape[0]
    si = stats.to(i32t)
    created, drop_s = seg["created"], seg["drop_static"]
    n_svc = si[:, ST_DONE_SVC]
    inc = torch.stack([       # per tick, in the order of _COUNTERS
        si[:, ST_DONE_I], si[:, ST_DONE_T] + n_svc, n_svc, si[:, ST_STEPS_I],
        (stats[:, ST_STEPS_T] + stats[:, ST_STEPS_SVC]).to(i32t),
        si[:, ST_NEW_MAL], si[:, ST_NEW_COL], created[:, 0], created[:, 1],
        created[:, 2] + created[:, 3],
        drop_s[:, 0] + si[:, ST_DROP_I] + si[:, ST_KILL_I],
        drop_s[:, 1] + si[:, ST_DROP_T] + si[:, ST_KILL_T]], dim=1)
    tot = torch.stack([getattr(m, k) for k in _COUNTERS]) \
        + inc.sum(dim=0, dtype=i32t)
    m = m.replace(**dict(zip(_COUNTERS, tot)))
    off = (cfg.SIMULATION_STARTING_TIME_OF_DAY_HOURS * 3600
           + cfg.SIMULATION_STARTING_TIME_OF_DAY_MINUTES * 60)
    new_day = torch.div(off + seg["elapsed"], 86400,
                        rounding_mode="floor").to(i32t)
    # the day rollover in closed form: tick t starts a new day when its
    # day passes the last tick's; the daily counters after tick t sum the
    # ticks of t's day so far (plus the carried counters before any roll)
    rolled = new_day > torch.cat([m.day.reshape(1), new_day[:-1]])
    g = torch.cumsum(rolled.to(i32t), 0, dtype=i32t)
    ar = torch.arange(R, device=stats.device)
    same = (ar[None, :] <= ar[:, None]) & (g[None, :] == g[:, None])
    counts = torch.stack([created[:, 0] + created[:, 1],
                          (stats[:, ST_DONE_I] + stats[:, ST_DONE_T])
                          .to(i32t) + n_svc], dim=1)           # [R, 2]
    start = torch.stack([m.daily_created, m.daily_finished])
    daily = (same[..., None] * counts[None]).sum(dim=1, dtype=i32t) \
        + torch.where((g == 0)[:, None], start, 0)
    before = torch.cat([start[None], daily[:-1]])
    diff = before[:, 1] - before[:, 0]
    # the last roll's difference (a 1-element index: a 0-d one would be
    # read back to the host as a Python int)
    last = torch.argmax(torch.where(rolled, ar, -1)).reshape(1)
    m = m.replace(
        last_daily_difference=torch.where(rolled.any(), diff[last][0],
                                          m.last_daily_difference),
        daily_diff_sum=m.daily_diff_sum
        + torch.where(rolled, diff, 0).sum(dtype=i32t),
        days_completed=m.days_completed + rolled.sum(dtype=i32t),
        daily_created=daily[-1, 0], daily_finished=daily[-1, 1],
        day=new_day[-1])
    # the f32 duration sums in the per-tick order: the carried sums, then
    # per tick the rows (internal, through) and (0, service); a cumsum
    # along the outer dimension adds in row order on either device
    d = stats[:, [ST_DUR_I, ST_DUR_T, ST_DUR_SVC, ST_DUR_SVC]]
    d[:, 2] = 0.0
    dur = torch.cat([torch.stack([m.sum_duration_internal,
                                  m.sum_duration_through])[None],
                     d.reshape(2 * R, 2)]).cumsum(0)[-1]
    return m.replace(sum_duration_internal=dur[0], sum_duration_through=dur[1])
