# Frozen copy of trafficsimulation_tpu_torch/agents/demand.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
"""Time-of-day demand: the pre-generated trip tables (the JAX package's
`agents/demand.py`; its docstring maps them to the reference).  Trip
counts, kinds and zones are static (`trip_layout`); departure times,
origins and destinations are drawn from the key, on the host, and the
tables are built on the device of the block tables.

The departure times are f32 in the JAX order.  Under `jax.jit` (world
init) XLA's CPU backend fuses `z0 + u * span` into one multiply-add and
divides by the constant tick length as a multiply by its reciprocal; the
JAX sim's host-side regeneration runs the same code eagerly, op by op,
with neither.  `fused` selects which of the two a caller reproduces.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import codes as C
from .. import prng
from ..config import ABBR, Config
from ..core.state import Demand

KIND_INTERNAL, KIND_THROUGH, KIND_FOOD, KIND_WASTE = 0, 1, 2, 3
I32, F32 = torch.int32, torch.float32


def largest_remainder(total: int, shares) -> list:
    """`compute_quotas` (`dynamic_traffic_generator.py:319-331`)."""
    float_counts = [total * s for s in shares]
    floors = [math.floor(x) for x in float_counts]
    rem = total - sum(floors)
    fracs = sorted(enumerate(float_counts),
                   key=lambda iv: iv[1] - math.floor(iv[1]), reverse=True)
    for i in range(rem):
        floors[fracs[i][0]] += 1
    return floors


@dataclass(frozen=True)
class TripLayout:
    """Static per-slot tables (numpy; shapes fixed by the config)."""
    zone_start: np.ndarray   # i32 [T] zone start hour
    zone_end: np.ndarray     # i32 [T]
    kind: np.ndarray         # u8 [T]
    o_code: np.ndarray       # u8 [T] origin block type (internal only)
    d_code: np.ndarray       # u8 [T] destination block type
    j_idx: np.ndarray        # i32 [T] service slot index within zone
    n_svc: np.ndarray        # i32 [T] service quota of the zone
    size: int


def trip_layout(cfg: Config) -> TripLayout:
    zs, ze, kind, oc, dc, jj, nn = [], [], [], [], [], [], []
    shares = [z.through_distribution for z in cfg.TIME_ZONES]
    food_q = largest_remainder(cfg.TOTAL_SERVICE_VEHICLES_FOOD, shares)
    waste_q = largest_remainder(cfg.TOTAL_SERVICE_VEHICLES_WASTE, shares)

    def add(zone, k, o=0, d=0, j=0, n=0):
        zs.append(zone.start_hour)
        ze.append(zone.end_hour)
        kind.append(k)
        oc.append(o)
        dc.append(d)
        jj.append(j)
        nn.append(n)

    for zi, zone in enumerate(cfg.TIME_ZONES):
        for (o, d, frac) in zone.internal_distribution:
            cnt = round(cfg.INTERNAL_POPULATION_TRAFFIC_PER_DAY * frac)
            ocode = C.NAME_TO_TYPE[ABBR[o]]
            dcode = C.NAME_TO_TYPE[ABBR[d]]
            for _ in range(cnt):
                add(zone, KIND_INTERNAL, ocode, dcode)
        nf, nw = food_q[zi], waste_q[zi]
        for j in range(1, nf + 1):
            add(zone, KIND_FOOD, j=j, n=nf)
        for j in range(1, nw + 1):
            add(zone, KIND_WASTE, j=j, n=nw)
        thr = round(cfg.PASSING_POPULATION_TRAFFIC_PER_DAY *
                    zone.through_distribution)
        for _ in range(max(0, thr - (nf + nw))):
            add(zone, KIND_THROUGH)

    return TripLayout(
        zone_start=np.asarray(zs, np.int32),
        zone_end=np.asarray(ze, np.int32),
        kind=np.asarray(kind, np.uint8),
        o_code=np.asarray(oc, np.uint8),
        d_code=np.asarray(dc, np.uint8),
        j_idx=np.asarray(jj, np.int32),
        n_svc=np.asarray(nn, np.int32),
        size=len(kind))


def _weighted_pick(u: torch.Tensor, weights: torch.Tensor, n: int):
    """n indices ~ weights (cumsum + searchsorted) from n uniforms u:
    (idx i32 [n], ok)."""
    cum = torch.cumsum(weights.to(F32), 0)
    total = cum[-1]
    idx = torch.searchsorted(cum, u * total, right=True)
    idx = idx.clamp(0, weights.shape[0] - 1).to(I32)
    return idx, (total > 0).expand(n)


# a day's draws from its key (`day_draws`): the departure ticks, then
# the uniforms of the origin block, destination block, highway entrance
# and exit picks
DAY_DRAWS = ("depart_tick", "u_origin", "u_dest", "u_entrance", "u_exit")


def day_draws(cfg: Config, layout: TripLayout, key, day: int,
              fused: bool = True) -> dict:
    """The host part of `generate_day`: what its key draws (numpy, the
    `DAY_DRAWS`), the departure ticks computed in f32 as XLA does; a
    stack of keys [..., 2] gives each draw its leading dims."""
    T = layout.size
    dt = cfg.TIME_PER_STEP_IN_SECONDS
    off = (cfg.SIMULATION_STARTING_TIME_OF_DAY_HOURS * 3600
           + cfg.SIMULATION_STARTING_TIME_OF_DAY_MINUTES * 60)
    kt, ko, kd, ke, kx = np.moveaxis(
        prng.split(np.asarray(key, np.uint32), 5), -2, 0)

    # departure times on the host: f32 as XLA computes them
    f32 = np.float32
    zsec0 = layout.zone_start.astype(np.int64) * 3600
    zsec1 = layout.zone_end.astype(np.int64) * 3600
    z0 = (day * 86400 + zsec0 - off).astype(np.int32).astype(f32)
    span = (zsec1 - zsec0).astype(np.int32).astype(f32)
    is_svc = layout.kind >= KIND_FOOD
    u = prng.uniform(kt, (T,))
    t_rand = prng._fma32(u, span, z0) if fused else z0 + u * span
    t_svc = z0 + layout.j_idx.astype(f32) * span / (
        layout.n_svc + 1).astype(f32)
    t = np.where(is_svc, t_svc, t_rand).astype(f32)
    # jitted, XLA divides by the constant dt as a multiply by its f32
    # reciprocal; eagerly, dt is an operand and the division is exact
    tdt = t * f32(1.0 / dt) if fused else t / f32(dt)
    return dict(depart_tick=np.ceil(tdt).astype(np.int32),
                u_origin=prng.uniform(ko, (T,)), u_dest=prng.uniform(kd, (T,)),
                u_entrance=prng.uniform(ke, (T,)),
                u_exit=prng.uniform(kx, (T,)))


def generate_day(cfg: Config, layout: TripLayout, key, day: int,
                 current_tick, blk_valid, blk_btype, blk_dest, blk_entrance,
                 dest_valid, dest_kind, entrance_pos, entrance_valid,
                 n_field_dests: int, dest_rid=None,
                 fused: bool = True) -> Demand:
    """One day's trip table, sorted by departure tick with invalid trips
    last (the JAX `generate_day`).  `dest_rid`: the routing-id column of
    hierarchical routing; through trips then store the exit's rid.
    `fused`: the f32 of the jitted JAX call (see the module docstring).
    `key` is the day's key, or its draws (`day_draws`) as tensors on the
    block tables' device: the rest is a function of tensors, which runs
    under vmap."""
    dev = blk_valid.device
    T = layout.size
    if not isinstance(key, dict):
        key = {k: torch.from_numpy(v).to(dev) for k, v in
               day_draws(cfg, layout, key, day, fused).items()}
    depart_tick = key["depart_tick"]
    valid = depart_tick > current_tick
    kind = torch.from_numpy(layout.kind).to(dev)

    blk_field_ok = blk_valid & (blk_dest >= 0) & (blk_dest < n_field_dests)
    B = blk_valid.shape[0]
    type_rows = list(C.ZONE_TYPES)
    cums = torch.stack([torch.cumsum((blk_field_ok & (blk_btype == tc))
                                     .to(F32), 0) for tc in type_rows])
    totals = cums[:, -1]

    def pick_block(u, codes: np.ndarray):
        row = np.zeros(T, np.int64)
        for i, tc in enumerate(type_rows):
            row = np.where(codes == tc, i, row)
        row = torch.from_numpy(row).to(dev)
        tot = totals[row]
        r = u * tot
        idx_by_row = torch.stack([torch.searchsorted(cums[i], r, right=True)
                                  for i in range(len(type_rows))])
        idx = idx_by_row.gather(0, row[None])[0]
        return idx.clamp(0, B - 1).to(I32), tot > 0

    ob, ob_ok = pick_block(key["u_origin"], layout.o_code)
    db, db_ok = pick_block(key["u_dest"], layout.d_code)
    ent_idx, ent_ok = _weighted_pick(key["u_entrance"], entrance_valid, T)
    exit_w = dest_valid & (dest_kind == 1) & (
        torch.arange(dest_valid.shape[0], device=dev) < n_field_dests)
    exd, exd_ok = _weighted_pick(key["u_exit"], exit_w, T)

    origin = torch.where(kind == KIND_INTERNAL, blk_entrance[ob.long()],
                         entrance_pos[ent_idx.clamp(
                             0, entrance_pos.shape[0] - 1).long()])
    exd_id = exd if dest_rid is None else dest_rid[exd.long()].to(I32)
    dest = torch.where(kind == KIND_INTERNAL, blk_dest[db.long()],
                       torch.where(kind == KIND_THROUGH, exd_id, -2))
    valid = valid & torch.where(
        kind == KIND_INTERNAL, ob_ok & db_ok,
        torch.where(kind == KIND_THROUGH, ent_ok & exd_ok, ent_ok))

    order = torch.argsort(torch.where(valid, depart_tick, 2**30),
                          stable=True)
    return Demand(depart_tick=depart_tick[order], origin=origin[order],
                  dest=dest[order], kind=kind[order], valid=valid[order],
                  cursor=torch.zeros((), dtype=I32, device=dev),
                  day=torch.tensor(day, dtype=I32, device=dev))


def generate_days(cfg: Config, layout: TripLayout, key, start_day: int,
                  n_days: int, current_tick, blk_valid, blk_btype, blk_dest,
                  blk_entrance, dest_valid, dest_kind, entrance_pos,
                  entrance_valid, n_field_dests: int,
                  dest_rid=None, fused: bool = True) -> Demand:
    """`n_days` consecutive day tables, re-sorted so that every invalid
    trip lands at the end (the spawn cursor walks the valid prefix).
    `key` is the key, or the days' draws (`days_draws`) as tensors: a
    function of tensors then, which runs under vmap."""
    if isinstance(key, dict):
        keys = [{k: v[i] for k, v in key.items()} for i in range(n_days)]
    else:
        keys = prng.split(np.asarray(key, np.uint32), n_days)
    days = [generate_day(cfg, layout, keys[i], start_day + i, current_tick,
                         blk_valid, blk_btype, blk_dest, blk_entrance,
                         dest_valid, dest_kind, entrance_pos, entrance_valid,
                         n_field_dests, dest_rid, fused)
            for i in range(n_days)]

    def cat(f):
        return torch.cat([f(d) for d in days])

    depart = cat(lambda d: d.depart_tick)
    valid = cat(lambda d: d.valid)
    order = torch.argsort(torch.where(valid, depart, 2**30), stable=True)
    dev = depart.device
    return Demand(depart_tick=depart[order],
                  origin=cat(lambda d: d.origin)[order],
                  dest=cat(lambda d: d.dest)[order],
                  kind=cat(lambda d: d.kind)[order],
                  valid=valid[order],
                  cursor=torch.zeros((), dtype=I32, device=dev),
                  day=torch.tensor(start_day + n_days - 1, dtype=I32,
                                   device=dev))


def days_draws(cfg: Config, layout: TripLayout, key, start_day: int,
               n_days: int, fused: bool = True) -> dict:
    """The host part of `generate_days`: each day's `day_draws`, stacked
    [n_days, T] (numpy); a stack of keys [B, 2] gives [B, n_days, T]."""
    keys = prng.split(np.asarray(key, np.uint32), n_days)
    days = [day_draws(cfg, layout, keys[..., i, :], start_day + i, fused)
            for i in range(n_days)]
    return {k: np.stack([d[k] for d in days], axis=-2) for k in DAY_DRAWS}
