"""Pedestrians as per-cell count planes (the JAX package's
`agents/pedestrians.py`; its module docstring gives the design and the
semantics).

The crowd is eight `[4, H, W]`-shaped int32 count planes, `walk[d]` and
`cross[d]` by heading d (N = +y, E = +x, S, W).  A tick: keep-heading /
start-crossing splits of the walkers, the sequential redistribution of
the re-pickers over the walkable directions, the crossers' straight step
over the roadway, lifetime thinning of the walkers and Bernoulli spawns
on sidewalk cells.  Fractional splits round stochastically, floor(n * p
+ u), with per-cell hashed uniforms.

The tick's 14 u32 seeds (4 keep, 8 take, 2 spawn uniforms) are drawn on
the host with JAX's key chain by `ops.engine.tick_draws`.  The floats
follow what XLA's CPU compiler makes of the JAX function under `jit`,
found by holding this version to it: the keep split's floor(n * p + u)
is one fused multiply-add (`_fma_f32`) where the split moves walkers
and crossers, but a multiply then an add where `rest = n - k` takes it
(XLA recomputes k in each fusion that reads it and contracts the
multiply-add in some of them); the redistribution's and the thinning's
are a multiply then an add; `1.0 / cnt` and `lam / n_side` are true
divisions.  The step runs as one launch of `hopper_engine.
step_pedestrians` on the card (`csrc/pedestrians.cu`);
`step_pedestrians_plain` below is its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import codes as C
from ..config import Config
from ..core.state import Pedestrians
from ..ops.engine import _hash32
from ..ops.routing import _shift_plane
from .rain import _fma_f32

PED_KEEP_HEADING = 0.8
PED_MEAN_LIFE_TICKS = 550        # mean of the pool design's randint(100, 1000)
_M32 = 0xFFFFFFFF


def init_pedestrians(H: int, W: int, enabled: bool = True,
                     device="cpu") -> Pedestrians:
    """Count planes; a [4, 1, 1] stub when pedestrians are disabled, as
    the JAX package carries it."""
    if not enabled:
        H = W = 1
    z = torch.zeros((4, H, W), dtype=torch.int32, device=device)
    return Pedestrians(walk=z, cross=z.clone())


def total_pedestrians(peds: Pedestrians) -> torch.Tensor:
    return peds.walk.sum() + peds.cross.sum()


def spawn_rate(cfg: Config) -> np.float32:
    """Expected spawns a tick, f32 (the JAX `lam`)."""
    ticks_per_day = 86400 // cfg.TIME_PER_STEP_IN_SECONDS
    return np.float32(cfg.PEDESTRIANS_PER_DAY / ticks_per_day)


def _ahead(a: torch.Tensor, d: int) -> torch.Tensor:
    """Value of plane a at the neighbour in heading d (zero beyond the
    edge); headings are the direction indices N = +y, E, S, W."""
    return _shift_plane(a, d, 0)


def _move(a: torch.Tensor, d: int) -> torch.Tensor:
    """Plane a's content moved one cell along heading d, zero-filled."""
    return _shift_plane(a, (d + 2) % 4, 0)


def _sround(n: torch.Tensor, p: torch.Tensor, u: torch.Tensor,
            fused: bool = False):
    """Stochastically rounded n * p: floor(n * p + u), the multiply-add
    fused or rounded twice, clamped to [0, n]."""
    nf = n.to(torch.float32)
    v = _fma_f32(nf, p, u) if fused else nf * p + u
    return torch.minimum(torch.clamp(torch.floor(v).to(torch.int32), min=0),
                         n)


def uniform_planes(seeds: torch.Tensor, H: int, W: int):
    """One (0, 1) f32 plane per u32 seed (int64 [n]) by counter hashing:
    hash32(y * W + x + seed) >> 8, times 2^-24."""
    iota = torch.arange(H * W, dtype=torch.int64,
                        device=seeds.device).reshape(H, W)
    unit = 1.0 / (1 << 24)
    return [(_hash32((iota + seeds[i]) & _M32) >> 8).to(torch.float32) * unit
            for i in range(seeds.shape[0])]


def step_pedestrians_plain(cfg: Config, walk: torch.Tensor,
                           cross: torch.Tensor, cell_type: torch.Tensor,
                           stop_map: torch.Tensor, seeds: torch.Tensor):
    """One tick on the count planes (the JAX `step_pedestrians`).
    walk, cross int32 [4, H, W]; cell_type u8 [H, W]; stop_map bool
    [H, W]; seeds int64 [14] (u32 values: 4 keep, 8 take, 2 spawn).
    Returns (walk', cross', ped_block bool [H, W], ped_count int32
    [H, W])."""
    H, W = cell_type.shape[-2:]
    i32, f32 = torch.int32, torch.float32
    walkable = ((cell_type == C.SIDEWALK) | (cell_type == C.BLOCK_ENTRANCE)
                | (cell_type == C.TRAFFIC_LIGHT))
    roady = ((cell_type == C.CONTROLLED_ROAD) | (cell_type == C.R1)
             | (cell_type == C.R2) | (cell_type == C.R3)
             | (cell_type == C.INTERSECTION))
    cross_entry = (cell_type == C.CONTROLLED_ROAD) & stop_map

    u = uniform_planes(seeds, H, W)
    u_keep, u_take, u_spawn = u[0:4], u[4:12], u[12:14]
    aw = [_ahead(walkable, d) for d in range(4)]
    ar = [_ahead(roady, d) for d in range(4)]
    ac = [_ahead(cross_entry, d) for d in range(4)]
    zero = torch.zeros_like(walk[0])
    new_walk = [zero] * 4
    new_cross = [zero] * 4

    # walking: keep heading / start crossing / redistribute
    n_alt = sum(a.to(i32) for a in aw)
    has_alt = n_alt > 0
    pool = zero
    p_keep = torch.tensor(PED_KEEP_HEADING, dtype=f32, device=walk.device)
    for d in range(4):
        n = walk[d]
        p = torch.where(aw[d] | ac[d], p_keep, 0.0)
        k = _sround(n, p, u_keep[d], fused=True)
        k_walk = torch.where(aw[d], k, 0)
        rest = n - _sround(n, p, u_keep[d])
        new_walk[d] = new_walk[d] + _move(k_walk, d)
        new_cross[d] = new_cross[d] + _move(k - k_walk, d)
        pool = pool + torch.where(has_alt, rest, 0)
        new_walk[d] = new_walk[d] + torch.where(has_alt, 0, rest)
    # the re-pickers over the walkable directions in order, each taking
    # its share of what is left (the last takes all)
    rem = n_alt
    m = pool
    for d in range(4):
        cnt = torch.clamp(rem, min=1).to(f32)
        take = torch.where(aw[d] & (rem > 0), _sround(m, 1.0 / cnt, u_take[d]),
                           0)
        take = torch.where(rem == 1, m, take) * aw[d]
        new_walk[d] = new_walk[d] + _move(take, d)
        m = m - take
        rem = rem - aw[d].to(i32)

    # crossing: straight ahead over the roadway until a sidewalk
    for d in range(4):
        c = cross[d]
        moved = torch.where(aw[d] | ar[d], c, 0)
        landed = _move(moved, d)
        on_road = torch.where(roady, landed, 0)
        new_cross[d] = new_cross[d] + on_road + (c - moved)
        new_walk[d] = new_walk[d] + (landed - on_road)

    # lifetime thinning (walkers only)
    p_die = torch.tensor(np.float32(1.0 / PED_MEAN_LIFE_TICKS), device=walk.device)
    for d in range(4):
        new_walk[d] = new_walk[d] - _sround(new_walk[d], p_die, u_take[4 + d])

    # spawns: Bernoulli per sidewalk cell
    if cfg.PEDESTRIANS_ENABLED:
        side = cell_type == C.SIDEWALK
        n_side = torch.clamp(side.to(i32).sum(), min=1)
        p_cell = torch.tensor(spawn_rate(cfg), device=walk.device) \
            / n_side.to(f32)
        born = side & (u_spawn[0] < p_cell)
        h = (u_spawn[1] * 4.0).to(i32)
        for d in range(4):
            new_walk[d] = new_walk[d] + (born & (h == d)).to(i32)

    walk2 = torch.stack(new_walk)
    cross2 = torch.stack(new_cross)
    csum = cross2.sum(0, dtype=i32)
    return walk2, cross2, csum > 0, walk2.sum(0, dtype=i32) + csum
