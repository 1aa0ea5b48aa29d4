"""Plane-CA simulation engine: vehicles as packed grid planes (the JAX
package's `ops/engine.py`; its module docstring describes the design).

The packed u32 planes pa..pe are int32 tensors with the same bits.  u32
arithmetic that can carry into bit 31 (the hash behind the tick's random
planes) runs in int64 masked to 32 bits.  Scatters that the JAX package
writes with `.at[idx].set(..., mode="drop")` and a sink index write into
a buffer with one extra slot that is sliced off.

The tick's random draws come from `prng` on the host: `step_engine`
takes them as one small int64 row per tick (`tick_draws` below)
instead of a key, so the device never waits for the key chain.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import codes as C
from ..config import Config

from .. import prng
from ..agents.blocks import step_blocks, food_shortage, waste_surplus
from ..agents.rain import step_rain
from ..core.state import Overrides, Vehicles, _Struct
from ..lights import fsm
from ..rl.controllers import GAT_ALGOS, rl_controller_step
from . import hier
from . import hopper_engine as HE
from . import routing
from .density import density_map
from .hopper_engine import (
    PA_KIND_SH, PA_HEAD_SH, PA_BASE_SH, PA_CUR_SH, PA_PARKED_SH, PA_COL_SH,
    PA_MAL_SH, PA_STUCKF_SH, PA_DEST_SH, PB_STUCK_SH, PB_STRAND_SH,
    PB_CONTRA_SH, PC_DEPART_SH, PC_STEPS_SH, PD_PHASE_SH, PD_TIMER_SH,
    PD_BLOCK_SH, PD_CFKEY_SH, PD_CFMODE_SH, PD_CFSTEPS_SH, KBIG,
    i32, _bit, _fld, _u)


DEST_NONE = 16383
SVC_BLOCK_NONE = 16383
INF_U16 = 65535
KIND_INTERNAL, KIND_THROUGH, KIND_FOOD, KIND_WASTE = 0, 1, 2, 3
_M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# Fixed-point cost fields
# ---------------------------------------------------------------------------


def field_to_keys(cfg: Config, F: torch.Tensor,
                  road_class: torch.Tensor) -> torch.Tensor:
    """The stored key stack K0[d, m, c] = (q << 2) | m with q =
    round(2 * (F[d, m, c + delta_m] + 1 + road_penalty(c + delta_m)))
    clipped to [0, 65534], or KBIG when the candidate is unreachable (see
    the JAX `field_to_keys`).  [D, 4, H, W] int32; leading batch dims of
    F [..., D, 4, H, W] and road_class [..., H, W] pass through."""
    enter_stat = 1.0 + routing.road_type_penalty(cfg, road_class)
    out = torch.empty(F.shape, dtype=torch.int32, device=F.device)
    for m in range(4):
        fn = routing._shift_plane(F[..., m, :, :], m, routing.INF)
        en = routing._shift_plane(enter_stat, m, routing.INF)[..., None, :, :]
        Q = fn + en
        del fn
        v = torch.clamp(torch.round(Q * 2.0), 0, 65534).to(torch.int32)
        k = torch.where(Q >= routing.INF, KBIG, v)
        out[..., m, :, :] = (k << 2) | m
    return out


def costs_u16_to_keys(q: torch.Tensor) -> torch.Tensor:
    """u16 move-candidate costs [D, 4, H, W] (65535 = unreachable, any
    int dtype) -> the stored key form."""
    q = q.to(torch.int32)
    k = torch.where(q >= INF_U16, KBIG, q)
    m = torch.arange(4, dtype=torch.int32, device=q.device).reshape(
        1, 4, 1, 1)
    return (k << 2) | m


def _neighbors4(f: torch.Tensor, fill) -> torch.Tensor:
    """[4, H, W]: the value at each cell's neighbour in direction m (N =
    +y, E = +x, S, W; `routing._shift_plane`), `fill` outside the grid,
    from one padded copy."""
    H, W = f.shape[-2:]
    p = torch.nn.functional.pad(f, (1, 1, 1, 1), value=fill)
    return torch.stack([p[..., 2:, 1:W + 1], p[..., 1:H + 1, 2:],
                        p[..., :H, 1:W + 1], p[..., 1:H + 1, :W]], dim=-3)


def entry_costs(cfg: Config, allowed, is_road, soft2, hard):
    """(legal4, pen4), int32 [4, H, W] each, the inputs of K2 (see the
    JAX `_entry_costs`): per direction m, whether m is a legal move of
    the cell (0/1) and the cost of entering the neighbour, or 1 << 17
    where the move is blocked."""
    cp2 = int(round(2 * cfg.VEHICLE_CONTRAFLOW_PENALTY))
    # C.DIR_BITS[m] == 1 << m
    m = torch.arange(4, dtype=torch.int32, device=allowed.device)
    legal4 = (allowed.to(torch.int32)[..., None, :, :] >> m[:, None, None]) & 1
    legal = legal4 != 0
    ok = (legal | _neighbors4(is_road.to(torch.int32), 0).bool()) \
        & ~_neighbors4(hard.to(torch.int32), 1).bool()
    pen = _neighbors4(soft2, 60000) + torch.where(legal, 0, cp2)
    pen4 = torch.where(ok, torch.clamp(pen, max=60000), 1 << 17)
    return legal4, pen4.to(torch.int32)


def build_sdir(cfg: Config, K0, allowed, is_road, soft2, hard,
               rows: slice = None):
    """Packed next-move stack [ceil(D/4), H, W] int32 (see the JAX
    `build_sdir`): the entry costs here, the encode in K2.  `rows`: the
    rows of the entry costs that K0 covers (a split world's decide window
    inside its route window), all by default."""
    tp2 = int(round(2 * cfg.VEHICLE_TURN_PENALTY)
              if cfg.VEHICLE_TURN_PENALTY_ENABLED else 0)
    legal4, pen4 = entry_costs(cfg, allowed, is_road, soft2, hard)
    if rows is not None:
        legal4, pen4 = legal4[:, rows], pen4[:, rows]
    return HE.build_sdir(K0, pen4.contiguous(), legal4.contiguous(), tp2)


def build_wavefront(cfg: Config, allowed, is_road, hard):
    """Packed per-direction overtake wavefronts [H, W] int32 (K3)."""
    return HE.build_wavefront(cfg, allowed.contiguous(),
                              is_road.contiguous(), hard.contiguous())


ND_NONE = 7


def pack_sdir4(sdir: torch.Tensor) -> torch.Tensor:
    """Pack 4 consecutive u8 destination rows into one int32 word
    (byte k of word g = row 4g+k); padding rows decode to ND_NONE."""
    D, H, W = sdir.shape
    D4 = (D + 3) // 4
    s = torch.full((D4 * 4, H, W), ND_NONE, dtype=torch.int64,
                   device=sdir.device)
    s[:D] = sdir.to(torch.int64)
    s = s.reshape(D4, 4, H, W)
    w = s[:, 0] | (s[:, 1] << 8) | (s[:, 2] << 16) | (s[:, 3] << 24)
    return _to_i32(w)


def _to_i32(x64: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value -> int32 with the same low 32 bits."""
    x64 = x64 & _M32
    return torch.where(x64 >= (1 << 31), x64 - (1 << 32), x64).to(torch.int32)


# ---------------------------------------------------------------------------
# SoA <-> planes conversion (once per chunk)
# ---------------------------------------------------------------------------

def _scatter_cells(HW, pos, vals, dtype, device):
    """A flat plane of zeros with vals written at pos (pos == HW drops)."""
    z = torch.zeros((HW + 1,), dtype=dtype, device=device)
    return z.index_put((pos,), vals.to(dtype))[:HW]


def vehicles_to_planes(cfg: Config, v: Vehicles, H: int, W: int,
                       rows: tuple = None):
    """Pack the vehicle pool onto the lattice: (pa..pe int32, pl f32) and
    the [V] slot-used mask.  `rows`: (lo, hi), the planes of those rows
    alone (a rank's own rows of a split world, `parallel/spatial.py`):
    the vehicles whose cell lies there."""
    HW = H * W
    V = v.active.shape[0]
    dev = v.active.device
    pos = torch.where(v.active, torch.clamp(v.pos, 0, HW - 1), HW).long()
    if rows is not None:
        lo, hi = rows
        H, HW = hi - lo, (hi - lo) * W
        pos = torch.where((pos >= lo * W) & (pos < hi * W), pos - lo * W, HW)
    dt = float(cfg.TIME_PER_STEP_IN_SECONDS)
    dest = torch.where(v.dest >= 0, torch.clamp(v.dest, max=DEST_NONE - 1),
                       DEST_NONE)
    I = torch.int64
    pa_v = (1 | (v.kind.to(I) << PA_KIND_SH)
            | (torch.clamp(v.heading + 1, 0, 7).to(I) << PA_HEAD_SH)
            | (torch.clamp(v.base_speed, 0, 15).to(I) << PA_BASE_SH)
            | (torch.clamp(v.current_speed, 0, 15).to(I) << PA_CUR_SH)
            | (v.parked.to(I) << PA_PARKED_SH)
            | (v.in_collision.to(I) << PA_COL_SH)
            | (v.in_malfunction.to(I) << PA_MAL_SH)
            | (v.is_stuck.to(I) << PA_STUCKF_SH)
            | (dest.to(I) << PA_DEST_SH))
    pb_v = (torch.clamp(v.stuck_ticks, 0, 4095).to(I)
            | (torch.clamp(v.stranded_ticks, 0, 4095).to(I) << PB_STRAND_SH)
            | (torch.clamp(v.contraflow_ticks, 0, 255).to(I)
               << PB_CONTRA_SH))
    # XLA turns `/ dt` into a multiply by the f32 reciprocal
    depart_tick = torch.clamp(torch.round(
        v.depart_time * float(np.float32(1.0 / dt))), 0, (1 << 20) - 1).to(I)
    pc_v = depart_tick | (torch.clamp(v.steps_traveled, 0, 4095).to(I)
                          << PC_STEPS_SH)
    sb = torch.where(v.service_block >= 0,
                     torch.clamp(v.service_block, max=SVC_BLOCK_NONE - 1),
                     SVC_BLOCK_NONE)
    pd_v = (v.service_phase.to(I)
            | (torch.clamp(v.service_timer, 0, 255).to(I) << PD_TIMER_SH)
            | (sb.to(I) << PD_BLOCK_SH)
            | (torch.clamp(v.contraflow_key, 0, 3).to(I) << PD_CFKEY_SH)
            | (v.detour.to(I) << PD_CFMODE_SH)
            | (torch.clamp(v.contraflow_steps, 0, 31).to(I)
               << PD_CFSTEPS_SH))
    pe_v = torch.arange(V, dtype=I, device=dev)

    def scat(vals):
        vals = torch.where(v.active, _to_i32(vals), 0)
        return _scatter_cells(HW, pos, vals, torch.int32, dev).reshape(H, W)

    planes = (scat(pa_v), scat(pb_v), scat(pc_v), scat(pd_v), scat(pe_v),
              _scatter_cells(HW, pos, torch.where(v.active, v.load, 0.0),
                             torch.float32, dev).reshape(H, W))
    return planes, v.active.clone()


def planes_to_vehicles(cfg: Config, planes, V: int, slab=None) -> Vehicles:
    """Unpack the lattice into the SoA pool; inactive slots get pool
    defaults.  `slab`: the planes are a rank's own rows of a split world
    (`parallel/spatial.Slab`); each slot is written by the rank that
    holds its vehicle, through one owner-masked all-reduce."""
    pa, pb, pc, pd, pe, pl = planes
    H, W = pa.shape
    HW = H * W
    dev = pa.device
    paf, pbf, pcf, pdf = (p.reshape(-1) for p in (pa, pb, pc, pd))
    present = (paf & 1) == 1
    dt = float(cfg.TIME_PER_STEP_IN_SECONDS)
    slot = torch.where(present, pe.reshape(-1), V).clamp(0, V).long()
    cell = torch.arange(HW, dtype=torch.int32, device=dev)
    if slab is not None:
        cell = cell + slab.own[0] * W

    i32t, bt = torch.int32, torch.bool
    dest = _fld(paf, PA_DEST_SH, 14)
    sb = _fld(pdf, PD_BLOCK_SH, 14)
    # name: (the cell's value, the inactive slot's default, dtype)
    cols = {
        "active": (present, False, bt),
        "pos": (cell, -1, i32t),
        "heading": (_fld(paf, PA_HEAD_SH, 3) - 1, -1, i32t),
        "dest": (torch.where(dest == DEST_NONE, -1, dest), -1, i32t),
        "base_speed": (_fld(paf, PA_BASE_SH, 4), 0, i32t),
        "current_speed": (_fld(paf, PA_CUR_SH, 4), 0, i32t),
        "stuck_ticks": (_fld(pbf, PB_STUCK_SH, 12), 0, i32t),
        "is_stuck": (_bit(paf, PA_STUCKF_SH), False, bt),
        "stranded_ticks": (_fld(pbf, PB_STRAND_SH, 12), 0, i32t),
        "parked": (_bit(paf, PA_PARKED_SH), False, bt),
        "in_collision": (_bit(paf, PA_COL_SH), False, bt),
        "in_malfunction": (_bit(paf, PA_MAL_SH), False, bt),
        "contraflow_ticks": (_fld(pbf, PB_CONTRA_SH, 8), 0, i32t),
        "contraflow_key": (_fld(pdf, PD_CFKEY_SH, 2), 0, i32t),
        "contraflow_steps": (_fld(pdf, PD_CFSTEPS_SH, 5), 0, i32t),
        "detour": (_bit(pdf, PD_CFMODE_SH), False, bt),
        "kind": (_fld(paf, PA_KIND_SH, 2), 0, torch.uint8),
        "depart_time": (_fld(pcf, PC_DEPART_SH, 20).to(torch.float32) * dt,
                        0.0, torch.float32),
        "steps_traveled": (_fld(pcf, PC_STEPS_SH, 12), 0, i32t),
        "service_phase": (_fld(pdf, PD_PHASE_SH, 2), 0, torch.uint8),
        "load": (pl.reshape(-1), 0.0, torch.float32),
        "service_timer": (_fld(pdf, PD_TIMER_SH, 8), 0, i32t),
        "service_block": (torch.where(sb == SVC_BLOCK_NONE, -1, sb), -1,
                          i32t)}
    tabs = [torch.zeros((V + 1,), dtype=dtype, device=dev).index_put(
        (slot,), vals.to(dtype))[:V] for vals, _, dtype in cols.values()]
    if slab is not None:
        tabs = slab.all_sum(tabs)
    active = tabs[0]
    return Vehicles(**{name: torch.where(active, t, fill) for (name, (
        _, fill, _)), t in zip(cols.items(), tabs)})


def planes_to_maps(planes, V: int):
    """veh_map (slot or -1) and stuck_map from the planes."""
    pa, pb, _, _, pe, _ = planes
    present = (pa & 1) == 1
    veh_map = torch.where(present, torch.clamp(pe, 0, V - 1), -1)
    stuck_map = torch.where(present, _fld(pb, PB_STUCK_SH, 12), 0)
    return veh_map, stuck_map


# ---------------------------------------------------------------------------
# Engine state and the tick
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineState(_Struct):
    """Dynamic state advanced by `step_engine`; static world structure
    rides alongside in the enclosing `World`."""
    pa: torch.Tensor   # int32 [H, W] vehicle core (u32 bits)
    pb: torch.Tensor   # int32 [H, W] timers
    pc: torch.Tensor   # int32 [H, W] trip bookkeeping
    pd: torch.Tensor   # int32 [H, W] service FSM + contraflow
    pe: torch.Tensor   # int32 [H, W] SoA slot id
    pl: torch.Tensor   # f32 [H, W] service load
    slot_used: torch.Tensor   # bool [V]
    stop_map: torch.Tensor
    rain_map: torch.Tensor
    density: torch.Tensor
    ped_map: torch.Tensor
    lights: Any
    blocks: Any
    rain: Any
    dem_cursor: Any
    metrics: Any
    overrides: Any
    peds: Any
    tick: torch.Tensor
    elapsed: torch.Tensor
    key: torch.Tensor
    rl: Any = None


def free_slots(slot_used: torch.Tensor, n: int) -> torch.Tensor:
    """First n free pool slot ids ascending, -1 beyond the free count
    (a stable sort of the used flags, as the JAX version does)."""
    V = slot_used.shape[0]
    used = slot_used.to(torch.int32)
    _, idx = torch.sort(used, stable=True)
    idx = idx.to(torch.int32)
    n_free = V - used.sum()
    take = idx[:n] if n <= V else torch.cat(
        [idx, torch.full((n - V,), V, dtype=torch.int32,
                         device=idx.device)])
    ar = torch.arange(n, device=idx.device)
    return torch.where(ar < n_free, take, -1)


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3-style finalizer over u32 values held in int64: each
    multiply is split at 16 bits so no product leaves int64."""
    def mul(a, c):
        lo = (a * (c & 0xFFFF)) & _M32
        hi = ((a * (c >> 16)) & 0xFFFF) << 16
        return (lo + hi) & _M32
    x = mul(x ^ (x >> 16), 0x7FEB352D)
    x = mul(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


# per-tick draw row (int64 [N_DRAWS]): the 4 tick_randoms seeds (u32),
# then the rain draws: spawn wanted, edge, position (the f32 uniform
# times 2^23, an exact integer), corner flip, radius; then the
# pedestrian step's 14 seeds (u32: 4 keep, 8 take, 2 spawn; zero while
# pedestrians are off).  The RL controller's key goes beside the rows
# (`tick_chain`)
D_SEEDS, D_RAIN, D_PED = 0, 4, 9
N_DRAWS = D_PED + 14


def tick_draws(cfg: Config, key: np.ndarray, n: int):
    """Walk the JAX key chain of n ticks on the host.  Returns (draws
    int64 [..., n, N_DRAWS] numpy, final keys [..., 2]); see
    `tick_chain`."""
    draws, _, key = tick_chain(cfg, key, n)
    return draws, key


def tick_chain(cfg: Config, key: np.ndarray, n: int):
    """Walk the JAX key chain of n ticks on the host (`step_engine`:
    split(key, 6), then split(key) for an RL controller, then split(key)
    for the pedestrians when they are on; `_post_move`: split(key);
    `step_rain`: split(k_rain, 5); `step_pedestrians`: split(k_ped, 3)).
    `key` uint32 [2], or [B, 2] for the worlds of a batch (each world its
    own chain, walked together).  Returns (draws int64 [..., n, N_DRAWS]
    numpy, the ticks' RL keys uint32 [..., n, 2] or None without an RL
    controller, final keys [..., 2])."""
    key = np.asarray(key, np.uint32)
    out = np.zeros(key.shape[:-1] + (n, N_DRAWS), np.int64)
    rl = cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM in fsm.RL_ALGOS
    rl_keys = np.zeros(key.shape[:-1] + (n, 2), np.uint32) if rl else None
    for t in range(n):
        ks = prng.split(key, 6)
        key, k_mal, k_rain = ks[..., 0, :], ks[..., 1, :], ks[..., 5, :]
        out[..., t, D_SEEDS:D_SEEDS + 4] = prng.bits(k_mal, (4,))
        if rl:
            kr = prng.split(key, 2)
            key, rl_keys[..., t, :] = kr[..., 0, :], kr[..., 1, :]
        if cfg.PEDESTRIANS_ENABLED:
            kp = prng.split(key, 2)
            key = kp[..., 0, :]
            kq = prng.split(kp[..., 1, :], 3)
            out[..., t, D_PED:D_PED + 4] = prng.bits(kq[..., 0, :], (4,))
            out[..., t, D_PED + 4:D_PED + 12] = prng.bits(kq[..., 1, :], (8,))
            out[..., t, D_PED + 12:D_PED + 14] = prng.bits(kq[..., 2, :],
                                                           (2,))
        key = prng.split(key, 2)[..., 0, :]
        if cfg.RAIN_ENABLED:
            kr = prng.split(k_rain, 5)
            out[..., t, D_RAIN] = prng.uniform(kr[..., 0, :]) < np.float32(
                cfg.RAIN_SPAWN_CHANCE)
            out[..., t, D_RAIN + 1] = prng.randint(kr[..., 1, :], 0, 4)
            # the uniform is a multiple of 2^-23: carried as that integer
            out[..., t, D_RAIN + 2] = np.asarray(
                prng.uniform(kr[..., 2, :]), np.float64) * (1 << 23)
            out[..., t, D_RAIN + 3] = prng.bernoulli(kr[..., 3, :])
            out[..., t, D_RAIN + 4] = prng.randint(
                kr[..., 4, :], cfg.RAIN_RADIUS_MIN, cfg.RAIN_RADIUS_MAX + 1)
    return out, rl_keys, key


def tick_randoms(cfg: Config, seeds: torch.Tensor, H: int, W: int,
                 row0: int = 0):
    """The tick's four random planes from 4 u32 seeds (int64 [4]) by
    counter hashing of each cell's flat index: malfunction roll,
    sideswipe roll (f32 in [0, 1)), speed re-roll (int32), conflict
    priority (int32 bits).  [H, W] from global row `row0` (a window of a
    split world hashes its cells' global indices)."""
    iota = torch.arange(row0 * W, (row0 + H) * W, dtype=torch.int64,
                        device=seeds.device).reshape(H, W)
    b = [_hash32((iota + seeds[i]) & _M32) for i in range(4)]
    unit = 1.0 / (1 << 24)
    r_mal = (b[0] >> 8).to(torch.float32) * unit
    r_side = (b[1] >> 8).to(torch.float32) * unit
    span = cfg.VEHICLE_MAX_SPEED - cfg.VEHICLE_MIN_SPEED + 1
    r_reroll = cfg.VEHICLE_MIN_SPEED + torch.clamp(
        ((b[2] >> 8).to(torch.float32) * unit * span).to(torch.int32),
        max=span - 1)
    return r_mal, r_side, r_reroll.to(torch.int32), _to_i32(b[3])


def soft_penalties(cfg: Config, pa, stop_map, density):
    """(soft2, hard): the dynamic entry cost round(2 * soft) of each cell
    (moving occupant: VEHICLE_OBSTACLE_PENALTY_VEHICLE scaled by density;
    stop cell: VEHICLE_OBSTACLE_PENALTY_STOP) and the hard blockers
    (stranded or parked occupants), as in the JAX `routing_planes`."""
    present = (pa & 1) == 1
    hard = present & (_bit(pa, PA_COL_SH) | _bit(pa, PA_MAL_SH)
                      | _bit(pa, PA_PARKED_SH))
    occ_moving = present & ~hard
    if cfg.VEHICLE_DYNAMIC_PENALTIES_ENABLED:
        vp = cfg.VEHICLE_OBSTACLE_PENALTY_VEHICLE * (
            1.0 + cfg.VEHICLE_DYNAMIC_PENALTY_SCALE * density)
    else:
        vp = torch.full(pa.shape, cfg.VEHICLE_OBSTACLE_PENALTY_VEHICLE,
                        dtype=torch.float32, device=pa.device)
    soft = torch.where(occ_moving, vp, 0.0) + torch.where(
        stop_map, cfg.VEHICLE_OBSTACLE_PENALTY_STOP, 0.0).to(torch.float32)
    return torch.round(2.0 * soft).to(torch.int32), hard


def routing_planes(cfg: Config, world, es: EngineState, slab=None):
    """(sdir4, wnd, density) from the current dynamic state; rebuilt once
    per PATHFINDING_COOLDOWN ticks by `run_chunk` (see the JAX
    `routing_planes`).  Cells that held pedestrians after the last tick
    are hard blockers.  Under hierarchical routing the key stack holds
    the hub and direct rows, and nothing here reads a world coordinate.
    `slab` (`parallel/spatial.Slab`): a rank's part of a split world: P
    + Q halo rows of `pa` (and of the pedestrian counts) exchanged,
    density, penalties, entry costs and K3 over the route window, K2
    over the decide window (the key stack's rows); sdir4 and wnd are the
    decide window's, density the own rows'."""
    grid = world.grid
    pa, ped_map, rows = es.pa, es.ped_map, None
    if slab is not None:
        # the pedestrian counts ride in the same exchange
        if cfg.PEDESTRIANS_ENABLED:
            pa, ped_map = slab.halo([es.pa, es.ped_map], slab.P + slab.Q)
        else:
            pa, = slab.halo([es.pa], slab.P + slab.Q)
        r0, (d0, d1) = slab.route[0], slab.dec
        rows = slice(d0 - r0, d1 - r0)
    present = (pa & 1) == 1
    density = density_map(present, grid.is_road, cfg.VEHICLE_AWARENESS_RANGE)
    soft2, hard = soft_penalties(cfg, pa, es.stop_map, density)
    if cfg.PEDESTRIANS_ENABLED:
        hard = hard | (ped_map > 0)
    sdir4 = build_sdir(cfg, world.cost_field, grid.allowed_dirs,
                       grid.is_road, soft2, hard, rows=rows)
    wnd = build_wavefront(cfg, grid.allowed_dirs, grid.is_road, hard)
    if slab is not None:
        wnd = wnd[rows].contiguous()
        density = slab.crop(density, slab.route, slab.own)
    return sdir4, wnd, density


# The pedestrian step's reach: an output cell reads the counts of the
# cells one step upstream and, through those sources' splits, the cell
# types and stop map two rows away.  A window's cut rows therefore damage
# the step's outputs on its two edge rows only (the split world runs it
# on the decide window widened by this much)
PED_REACH = 2


def trip_penalty(m) -> torch.Tensor:
    """GAT-DQN's global reward penalty 0.01 * avg trip duration + 1.0 *
    avg time per cell (the JAX `step_engine`), f32 [].  XLA's jitted
    compile drops the 1.0 and contracts the rest to one FMA."""
    avg_dur = 0.5 * (
        m.sum_duration_internal / torch.clamp(m.completed_internal, min=1)
        + m.sum_duration_through / torch.clamp(m.completed_through, min=1))
    avg_tpc = 0.5 * (
        m.sum_duration_internal / torch.clamp(m.sum_steps_internal, min=1)
        + m.sum_duration_through / torch.clamp(m.sum_steps_through, min=1))
    # fma(0.01f, avg_dur, avg_tpc): the f64 product of two f32 is exact
    c = float(np.float32(0.01))
    return (avg_dur.double() * c + avg_tpc.double()).to(torch.float32)


def step_engine(cfg: Config, world, es: EngineState, draws: torch.Tensor,
                sdir=None, spawn_slots: torch.Tensor = None,
                dense: tuple = None, rl_tick=None, slab=None) -> EngineState:
    """One tick on the plane representation (the JAX `step_engine`,
    dense or hierarchical routing, FSM or RL lights, pedestrians when
    PEDESTRIANS_ENABLED: their step, one `HE.step_pedestrians` launch,
    after the stop map, its crossers blocking decide + move).  `draws`:
    this tick's int64 [N_DRAWS] row from `tick_draws`; the caller
    advances the key.  `sdir`: this segment's `routing_planes`, or None
    to build them here.  `spawn_slots`: the tick's free pool slots, or
    None to compact them here.  `dense`: the (M, A) light-reduction
    matrices of `fsm.build_dense_reducers`, or None for the sparse
    forms.  `rl_tick`: under an RL controller, this tick's
    `controllers.RLTick` (from `controllers.plan_ticks`); the controller
    steps before the light reductions, as in JAX.

    `slab` (`parallel/spatial.Slab`): `es` is a rank's part of a split
    world (the planes and the pedestrian counts its own rows, the stop
    map the route window's, the rain map the decide window's); the
    light reductions and the RL flows are the group's sums, the stop map
    is built over the route window, K1 (K1-hier with the decide window's
    first world row) runs on the decide window after a P-row halo
    exchange and its own rows are kept.  The pedestrian step runs on the
    decide window widened by PED_REACH (its counts in the same
    exchange, the cell types and stop map cut from the route window):
    its blocked cells cover K1's window, its counts are kept on the own
    rows."""
    caps = cfg.capacities()
    W = cfg.WIDTH
    dt = float(cfg.TIME_PER_STEP_IN_SECONDS)
    grid = world.grid
    own = grid if slab is None else slab.grid_rows(grid, slab.own)
    tick = es.tick
    elapsed = es.elapsed + dt
    present = (es.pa & 1) == 1

    # ---- lights (commit first so decide reads the fresh stop map) --------
    lights, rl_state, rl_request = es.lights, es.rl, None
    if cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM in fsm.RL_ALGOS:
        stuck_map = torch.where(present, _fld(es.pb, PB_STUCK_SH, 12), 0)
        tp = (trip_penalty(es.metrics) if cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM
              in GAT_ALGOS else None)        # GAT-DQN's reward alone
        rl_state, lights, want, phase_req = rl_controller_step(
            cfg, es.rl, own, world.groups_static, lights, present,
            stuck_map, tp, rl_tick, slab=slab)
        rl_request = (want, phase_req)
    dense_m, dense_a = dense if dense is not None else (None, None)
    red = fsm.group_reductions(own, present, caps.max_groups,
                               gs=world.groups_static, dense_m=dense_m,
                               slab=slab)
    lights = fsm.run_controllers(cfg, own, world.groups_static, lights,
                                 present, rl_phase_request=rl_request,
                                 reductions=red[:4])
    lights = fsm.execute_phase_change(cfg, world.lights_static,
                                      world.groups_static, lights, red[4])
    lights = fsm.apply_light_overrides(lights, es.overrides.light_force)
    stop_map = fsm.build_stop_map(grid, world.lights_static, lights,
                                  dense_a=dense_a, slab=slab)

    peds, ped_map = es.peds, es.ped_map
    planes = (es.pa, es.pb, es.pc, es.pd, es.pe, es.pl)
    if slab is not None:
        # the decide window: P halo rows of the planes from the
        # neighbours; with pedestrians, the exchange widened by the
        # step's reach carries their count planes too
        width = slab.P + (PED_REACH if cfg.PEDESTRIANS_ENABLED else 0)
        pw = slab.window(width)
        counts = (list(peds.walk.unbind(0)) + list(peds.cross.unbind(0))
                  if cfg.PEDESTRIANS_ENABLED else [])
        ex = slab.halo(list(planes) + counts, width)
        planes = tuple(slab.crop(p, pw, slab.dec) for p in ex[:6])

    # ---- pedestrians: crossers on the roadway block vehicles ------------
    if cfg.PEDESTRIANS_ENABLED:
        if slab is None:
            walk, cross, ped_bit, ped_map = HE.step_pedestrians(
                cfg, peds.walk, peds.cross, grid.cell_type, stop_map,
                draws[D_PED:D_PED + 14], grid.n_side)
        else:
            # the step on the decide window widened by its reach, whose
            # cut rows do no damage inside it: what blocks K1 over the
            # decide window, the counts on the own rows
            walk, cross, ped_bit, ped_map = HE.step_pedestrians(
                cfg, torch.stack(ex[6:10]), torch.stack(ex[10:14]),
                slab.crop(grid.cell_type, slab.route, pw).contiguous(),
                slab.crop(stop_map, slab.route, pw).contiguous(),
                draws[D_PED:D_PED + 14], grid.n_side, row0=pw[0])
            walk, cross, ped_map = (slab.crop(x, pw, slab.own).contiguous()
                                    for x in (walk, cross, ped_map))
            ped_bit = slab.crop(ped_bit, pw, slab.dec).contiguous()
        peds = peds.replace(walk=walk, cross=cross)

    # ---- decide + move: K1, or under hierarchical routing K1-hier (the
    # windowed and the dense stack, selected in the kernel) --------------
    if sdir is None:
        sdir = routing_planes(cfg, world, es, slab)
    sdir4, wnd, density = sdir
    stop_d, inter_d, dest_d, row0 = (stop_map, grid.intersection,
                                     grid.dest_id, 0)
    if slab is not None:
        row0 = slab.dec[0]
        stop_d = slab.crop(stop_map, slab.route, slab.dec).contiguous()
        inter_d, dest_d = (slab.crop(x, slab.route, slab.dec).contiguous()
                           for x in (grid.intersection, grid.dest_id))
    if not cfg.PEDESTRIANS_ENABLED:
        ped_bit = torch.zeros(stop_d.shape, dtype=torch.bool,
                              device=es.pa.device)
    randoms = tick_randoms(cfg, draws[D_SEEDS:D_SEEDS + 4], stop_d.shape[0],
                           W, row0)
    out = HE.decide_move(
        cfg, sdir4, wnd, planes, stop_d, es.rain_map, ped_bit,
        inter_d, dest_d, randoms,
        hier=((world.local_sdir4, hier.kernel_consts(cfg))
              if cfg.ROUTING_HIER else None), row0=row0)
    if slab is not None:
        out = [slab.crop(p, slab.dec, slab.own) for p in out]
    flags = out[6]
    events = ((flags & HE.FLAG_NEW_MAL).sum().to(torch.int32),
              ((flags & HE.FLAG_NEW_COL) >> 1).sum().to(torch.int32))
    return _post_move(cfg, world, es, out[:6], lights, stop_map, density,
                      peds, ped_map, tick, elapsed, draws[D_RAIN:D_RAIN + 5],
                      events, spawn_slots=spawn_slots,
                      slab=slab).replace(rl=rl_state)


def _isum(x: torch.Tensor) -> torch.Tensor:
    return x.sum().to(torch.int32)


def _post_move(cfg: Config, world, es: EngineState, planes, lights,
               stop_map, density, peds, ped_map, tick, elapsed, rain_draws,
               events, spawn_slots=None, slab=None) -> EngineState:
    """Arrivals, service FSM, despawns, demand spawning, daily counters,
    rain and block resources (the JAX `_post_move`).  `events`: the
    tick's new malfunctions and collisions (int32 scalars).

    `slab` (`parallel/spatial.Slab`): `planes` are a rank's own rows; the
    per-cell work runs on them, and its reductions (`events` among them)
    and its gathers at destination cells and spawn origins (owner-masked)
    are summed over the group in one all-reduce; the destination-space
    service FSM, the tanks and the spawn choice then run on every rank
    alike, and a write at a cell is made by the rank that owns it.  The
    rain map is the decide window's."""
    caps = cfg.capacities()
    H, W = cfg.HEIGHT, cfg.WIDTH
    V = caps.max_vehicles
    dt = float(cfg.TIME_PER_STEP_IN_SECONDS)
    grid = world.grid if slab is None else slab.grid_rows(world.grid,
                                                          slab.own)
    dests = world.dests
    bs = world.blocks_static
    bst = es.blocks
    m = es.metrics
    slot_used = es.slot_used
    dev = es.pa.device
    f32, i32t = torch.float32, torch.int32

    pa, pb, pc, pd, pe, pl = planes
    h = pa.shape[0]             # the planes' rows: H, or the slab's own
    HW = h * W                  # their cells; index HW is a sink
    present = (pa & 1) == 1
    kind = _fld(pa, PA_KIND_SH, 2)

    def cells(c):
        """Global flat cells -> the planes' flat index (HW: not here)."""
        c = torch.clamp(c, 0, H * W - 1).long()
        return c if slab is None else slab.cells(c)

    def at(plane, ix):
        """The flat plane's values at indices `ix`, 0 at the sink."""
        flat = plane.reshape(-1)
        if slab is not None:
            flat = torch.cat([flat, flat.new_zeros(1)])
        return flat[ix]

    # ---- arrivals in plane space -----------------------------------------
    Dall = dests.pos.shape[0]
    B = bs.valid.shape[0]
    dpos = cells(dests.pos)
    dest14_p = _fld(pa, PA_DEST_SH, 14)
    at_dest_p = present & (grid.dest_id >= 0) & (dest14_p == grid.dest_id)
    phase_p = _fld(pd, PD_PHASE_SH, 2)
    dur_p = elapsed - _fld(pc, PC_DEPART_SH, 20).to(f32) * dt
    steps_p = _fld(pc, PC_STEPS_SH, 12).to(f32)
    done_i_p = at_dest_p & (kind == KIND_INTERNAL)
    done_t_p = at_dest_p & (kind == KIND_THROUGH)
    svc_done_p = at_dest_p & (kind >= KIND_FOOD) & (phase_p == 2) & \
        (grid.cell_type == C.HIGHWAY_EXIT)
    zf = torch.zeros((), dtype=f32, device=dev)
    # f32 sums of integer-valued terms (counts, multiples of the tick
    # length, steps) far below 2^24: exact in any summation order
    arr = torch.stack([
        done_i_p.to(f32), done_t_p.to(f32),
        torch.where(done_i_p, dur_p, zf), torch.where(done_t_p, dur_p, zf),
        torch.where(done_i_p, steps_p, zf),
        torch.where(done_t_p, steps_p, zf),
        svc_done_p.to(f32), torch.where(svc_done_p, dur_p, zf),
        torch.where(svc_done_p, steps_p, zf)]).sum(dim=(1, 2))

    # ---- the vehicles at the destination cells ---------------------------
    pa_d, pd_d, pe_d, pl_d = (at(p, dpos) for p in (pa, pd, pe, pl))

    # ---- despawns in plane space -----------------------------------------
    despawn = done_i_p | done_t_p | svc_done_p
    stuck_on = cfg.VEHICLE_STUCK_DESPAWN_ENABLED
    if stuck_on:
        stuck_v = _fld(pb, PB_STUCK_SH, 12)
        thr = torch.where(grid.intersection,
                          cfg.VEHICLE_STUCK_DESPAWN_THRESHOLD_INTERSECTION,
                          cfg.VEHICLE_STUCK_DESPAWN_THRESHOLD)
        kill = present & (stuck_v >= thr) & ~despawn
        killed = torch.stack([_isum(kill & (kind == KIND_INTERNAL)),
                              _isum(kill & (kind != KIND_INTERNAL))])
        despawn = despawn | kill
        # the pool slots the despawns free
        dflat = despawn.reshape(-1)
        freed = torch.zeros((V + 1,), dtype=torch.bool, device=dev
                            ).index_put((torch.where(
                                dflat, pe.reshape(-1), V).long(),),
                                dflat)[:V]
        despawn_d = at(despawn, dpos)
        pa, pb, pc, pd, pe = (torch.where(despawn, 0, p)
                              for p in (pa, pb, pc, pd, pe))
        pl = torch.where(despawn, 0.0, pl)

    # ---- the origins of the due spawns -----------------------------------
    dem = world.demand
    cursor = es.dem_cursor
    S = caps.max_spawns_per_tick
    T = dem.depart_tick.shape[0]
    sidx = torch.arange(S, device=dev)
    idxs = cursor + sidx
    j = torch.clamp(idxs, 0, T - 1).long()
    org_g = torch.clamp(dem.origin[j], 0, H * W - 1).long()
    org = cells(dem.origin[j])
    occupied = at(present & ~despawn, org)

    # ---- one reduction of everything above over a split world's ranks ----
    # (the f32 sums as the integers they are)
    parts = [torch.stack(list(events)), arr if slab is None
             else arr.to(i32t), pa_d, pd_d, pe_d, pl_d, occupied]
    if stuck_on:
        parts += [killed, despawn_d, freed]
    if slab is not None:
        parts = slab.all_sum(parts)
    events, arr, pa_d, pd_d, pe_d, pl_d, occupied = parts[:7]
    arr = arr.to(f32)
    n_svc_done = arr[6].to(i32t)
    m = m.replace(
        completed_internal=m.completed_internal + arr[0].to(i32t),
        completed_through=m.completed_through + arr[1].to(i32t)
        + n_svc_done,
        completed_service=m.completed_service + n_svc_done,
        sum_duration_internal=m.sum_duration_internal + arr[2],
        sum_duration_through=m.sum_duration_through + arr[3] + arr[7],
        sum_steps_internal=m.sum_steps_internal + arr[4].to(i32t),
        sum_steps_through=m.sum_steps_through + (arr[5] + arr[8]).to(i32t),
        malfunctions_total=m.malfunctions_total + events[0],
        collisions_total=m.collisions_total + events[1])

    # ---- service FSM (destination space) ---------------------------------
    rid_d = (torch.arange(Dall, dtype=i32t, device=dev)
             if dests.rid is None else dests.rid)
    is_here = dests.valid & ((pa_d & 1) == 1) & \
        (_fld(pa_d, PA_DEST_SH, 14) == rid_d)
    kind_d = _fld(pa_d, PA_KIND_SH, 2)
    is_svc = is_here & (kind_d >= KIND_FOOD)
    phase_d = _fld(pd_d, PD_PHASE_SH, 2)
    sb_raw = _fld(pd_d, PD_BLOCK_SH, 14)
    sb = torch.clamp(torch.where(sb_raw == SVC_BLOCK_NONE, 0, sb_raw),
                     0, B - 1).long()

    arrive_blk = is_svc & (phase_d == 0)
    shortage = food_shortage(bs, bst)
    surplus = waste_surplus(bs, bst)
    give = torch.where(arrive_blk & (kind_d == KIND_FOOD), torch.minimum(
        pl_d, torch.clamp(shortage[sb], min=0.0)), zf)
    take = torch.where(arrive_blk & (kind_d == KIND_WASTE), torch.minimum(
        cfg.SERVICE_VEHICLE_MAX_LOAD_WASTE - pl_d,
        torch.clamp(surplus[sb], min=0.0)), zf)
    # duplicate block indices (two vehicles serving one block in a tick)
    # fold in update order, as XLA's scatter-add does: one ordered add
    # for both tanks
    tanks = HE.ordered_add(torch.stack([bst.food, bst.waste]),
                           torch.stack([sb, sb]), torch.stack([give, -take]))
    food = torch.minimum(torch.clamp(tanks[0], min=0.0), bs.food_cap)
    waste = torch.minimum(torch.clamp(tanks[1], min=0.0), bs.waste_cap)
    bst = bst.replace(food=food, waste=waste)
    pl_d = pl_d - give + take
    parked_d = _bit(pa_d, PA_PARKED_SH) | arrive_blk
    phase_d = torch.where(arrive_blk, 1, phase_d)
    timer_d = torch.where(arrive_blk, cfg.SERVICE_VEHICLE_LOAD_TIME,
                          _fld(pd_d, PD_TIMER_SH, 8))

    servicing = is_svc & (phase_d == 1) & ~arrive_blk
    timer_d = torch.where(servicing, timer_d - 1, timer_d)
    finish = servicing & (timer_d <= 0)
    more = torch.where(kind_d == KIND_FOOD, pl_d > 0,
                       pl_d < cfg.SERVICE_VEHICLE_MAX_LOAD_WASTE)
    DF = (1 << 14) if cfg.ROUTING_HIER else world.cost_field.shape[0]
    svc_target = torch.where((bs.service_dest >= 0) & (bs.service_dest < DF),
                             bs.service_dest, bs.dest)
    blk_ok = (svc_target >= 0) & (svc_target < DF)
    neg1 = -1.0
    best_food = torch.argmax(torch.where(blk_ok, shortage, neg1))
    best_waste = torch.argmax(torch.where(blk_ok, surplus, neg1))
    has_food_blk = torch.where(blk_ok, shortage, neg1).max() > 0
    has_waste_blk = torch.where(blk_ok, surplus, neg1).max() > 0
    nxt_blk = torch.where(kind_d == KIND_FOOD, best_food, best_waste)
    has_blk = torch.where(kind_d == KIND_FOOD, has_food_blk, has_waste_blk)
    go_again = finish & more & has_blk
    go_exit = finish & ~go_again
    new_dest = torch.where(go_again, svc_target[nxt_blk],
                           torch.where(go_exit, world.nearest_exit,
                                       _fld(pa_d, PA_DEST_SH, 14)))
    new_sb = torch.where(go_again, nxt_blk.to(i32t), sb_raw)
    phase_d = torch.where(go_again, 0, torch.where(go_exit, 2, phase_d))
    parked_d = parked_d & ~finish

    pa_d_new = (pa_d & i32((~((1 << PA_PARKED_SH)
                              | (DEST_NONE << PA_DEST_SH))) & _M32)) \
        | (_u(parked_d) << PA_PARKED_SH) \
        | (torch.clamp(new_dest, 0, DEST_NONE) << PA_DEST_SH)
    pd_d_new = (phase_d | (torch.clamp(timer_d, 0, 255) << PD_TIMER_SH)
                | (new_sb << PD_BLOCK_SH))

    # ---- despawns: metrics and pool slots --------------------------------
    if stuck_on:
        killed, despawn_d, freed = parts[7:]
        m = m.replace(errored_internal=m.errored_internal + killed[0],
                      errored_through=m.errored_through + killed[1])
        slot_used = slot_used & ~freed
    else:
        despawn_d = is_here & (
            (kind_d <= KIND_THROUGH)
            | ((kind_d >= KIND_FOOD) & (phase_d == 2) & (dests.kind == 1)))
        su = torch.cat([slot_used, slot_used.new_zeros(1)])
        su[torch.where(despawn_d, torch.clamp(pe_d, 0, V - 1), V).long()] = \
            False
        slot_used = su[:V]

    # ---- demand spawning -------------------------------------------------
    due = (idxs < T) & dem.valid[j] & (dem.depart_tick[j] <= tick + 1)
    due = torch.cummin(due.to(i32t), 0).values.bool()   # sorted prefix
    if not cfg.ENABLE_TRAFFIC:
        due = due & False
    if spawn_slots is None:
        spawn_slots = free_slots(slot_used, S)
    slots = spawn_slots
    can = due & (slots >= 0)
    earlier_same = (org_g[None, :] == org_g[:, None]) \
        & (sidx[None, :] < sidx[:, None]) & (can & ~occupied)[None, :]
    place = can & ~occupied & ~earlier_same.any(dim=1)
    dropped = (can & ~place) | (due & (slots < 0))
    tkind = dem.kind[j].to(i32t)

    shortage2 = food_shortage(bs, bst)
    surplus2 = waste_surplus(bs, bst)
    sp_food_blk = torch.argmax(torch.where(blk_ok, shortage2, neg1))
    sp_waste_blk = torch.argmax(torch.where(blk_ok, surplus2, neg1))
    sp_blk = torch.where(tkind == KIND_FOOD, sp_food_blk, sp_waste_blk)
    tdest = torch.where(tkind <= KIND_THROUGH, dem.dest[j],
                        svc_target[sp_blk])
    tdest = torch.where(tdest < 0, DEST_NONE,
                        torch.clamp(tdest, max=DEST_NONE - 1))

    scell = torch.where(place, org, HW)
    spawn_pa = 1 | (tkind << PA_KIND_SH) | (tdest << PA_DEST_SH)
    spawn_pc = torch.clamp(tick + 1, 0, (1 << 20) - 1).expand(S)
    spawn_pd = torch.where(tkind >= KIND_FOOD, sp_blk.to(i32t),
                           SVC_BLOCK_NONE) << PD_BLOCK_SH
    spawn_pl = torch.where(tkind == KIND_FOOD,
                           float(cfg.SERVICE_VEHICLE_MAX_LOAD_FOOD),
                           0.0).to(f32)
    zS = torch.zeros((S,), dtype=i32t, device=dev)

    # ---- ONE combined scatter per plane: service rows + despawn clears +
    # spawns; the index sets are disjoint by construction (a spawn needs
    # its cell free, a row whose cell a spawn claims goes to the sink).
    # A split world's rank writes the cells of its own rows alone: the
    # others' indices are the sink
    sp_mask = torch.zeros((HW + 1,), dtype=torch.bool,
                          device=dev).index_put((scell,), place)
    claimed = sp_mask[dpos]
    row = torch.where((is_svc | despawn_d) & ~claimed, dpos, HW)
    zrow = torch.where(despawn_d & ~claimed, dpos, HW)
    idx = torch.cat([row, scell])
    idxz = torch.cat([zrow, scell])
    zD = torch.zeros((Dall,), dtype=i32t, device=dev)

    def put(plane, ix, vals):
        flat = torch.cat([plane.reshape(-1), plane.new_zeros(1)])
        flat[ix] = vals.to(plane.dtype)
        return flat[:HW].reshape(h, W)

    dz = despawn_d
    pa = put(pa, idx, torch.cat([torch.where(dz, 0, pa_d_new), spawn_pa]))
    pd = put(pd, idx, torch.cat([torch.where(dz, 0, pd_d_new), spawn_pd]))
    pl = put(pl, idx, torch.cat([torch.where(dz, 0.0, pl_d), spawn_pl]))
    pb = put(pb, idxz, torch.cat([zD, zS]))
    pc = put(pc, idxz, torch.cat([zD, spawn_pc]))
    pe = put(pe, idxz, torch.cat([zD, torch.clamp(slots, 0, V - 1)]))
    su = torch.cat([slot_used, slot_used.new_zeros(1)])
    su[torch.where(place, slots, V).long()] = True
    slot_used = su[:V]
    cursor = cursor + _isum(due)
    m = m.replace(
        created_internal=m.created_internal + _isum(
            can & (tkind == KIND_INTERNAL)),
        created_through=m.created_through + _isum(
            can & (tkind == KIND_THROUGH)),
        created_service=m.created_service + _isum(
            can & (tkind >= KIND_FOOD)),
        errored_internal=m.errored_internal + _isum(
            dropped & (tkind == KIND_INTERNAL)),
        errored_through=m.errored_through + _isum(
            dropped & (tkind != KIND_INTERNAL)))

    # ---- daily counters --------------------------------------------------
    off = (cfg.SIMULATION_STARTING_TIME_OF_DAY_HOURS * 3600
           + cfg.SIMULATION_STARTING_TIME_OF_DAY_MINUTES * 60)
    new_day = torch.div(off + elapsed, 86400, rounding_mode="floor").to(i32t)
    rolled = new_day > m.day
    tick_created = _isum(can & (tkind <= KIND_THROUGH))
    tick_finished = (arr[0] + arr[1]).to(i32t) + n_svc_done
    m = m.replace(
        last_daily_difference=torch.where(
            rolled, m.daily_finished - m.daily_created,
            m.last_daily_difference),
        daily_diff_sum=torch.where(
            rolled, m.daily_diff_sum + m.daily_finished - m.daily_created,
            m.daily_diff_sum),
        days_completed=torch.where(rolled, m.days_completed + 1,
                                   m.days_completed),
        daily_created=torch.where(rolled, tick_created,
                                  m.daily_created + tick_created),
        daily_finished=torch.where(rolled, tick_finished,
                                   m.daily_finished + tick_finished),
        day=new_day)

    # ---- rain, blocks ----------------------------------------------------
    rain, rain_map = step_rain(cfg, H, W, es.rain, rain_draws,
                               force_spawn=es.overrides.spawn_rain,
                               rows=None if slab is None else slab.dec)
    bst = step_blocks(cfg, bs, bst, tick)

    return es.replace(
        pa=pa, pb=pb, pc=pc, pd=pd, pe=pe, pl=pl, slot_used=slot_used,
        stop_map=stop_map, rain_map=rain_map, density=density,
        ped_map=ped_map, peds=peds,
        lights=lights, blocks=bst, rain=rain, dem_cursor=cursor, metrics=m,
        overrides=Overrides(
            light_force=torch.full_like(es.overrides.light_force, -1),
            spawn_rain=torch.zeros((), dtype=torch.bool, device=dev)),
        tick=tick + 1, elapsed=elapsed)
