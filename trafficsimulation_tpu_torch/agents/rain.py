"""Rain clouds as vectorized disc rasterization (the JAX package's
`agents/rain.py`).

The five random scalars of a tick (spawn wanted, edge, position, corner
flip, radius) arrive as one int64 row drawn on the host by
`ops.engine.tick_draws` with JAX's key chain.  The float math keeps the
JAX op order; XLA on the CPU evaluates `dx * dx + dy * dy` as one fused
multiply-add, fma(dx, dx, dy * dy), which `_fma_f32` reproduces.  The
clouds' tick loop (move, exit, cooldown, spawn) is one launch of
`hopper_engine.rain_ticks` on the card (`csrc/rain.cu`); its plain
version is `cloud_ticks_plain`.
"""

from __future__ import annotations

import torch

from ..config import Config

from ..core.state import RainState
from ..ops import hopper_engine as HE


def init_rain_state(cfg: Config, device) -> RainState:
    R = cfg.RAIN_OCCURRENCES_MAX
    z = torch.zeros((R,), dtype=torch.float32, device=device)
    return RainState(active=torch.zeros((R,), dtype=torch.bool,
                                        device=device),
                     cx=z, cy=z.clone(), vx=z.clone(), vy=z.clone(),
                     radius=z.clone(),
                     cooldown=torch.zeros((), dtype=torch.int32,
                                          device=device))


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """f32 a * b + c rounded once: the f64 product of two f32 values is
    exact, so one f64 add and one rounding to f32 give the fused
    result."""
    return (a.double() * b.double() + c.double()).float()


def step_rain(cfg: Config, H: int, W: int, rain: RainState,
              draws: torch.Tensor, force_spawn=None, rows: tuple = None):
    """Advance clouds one tick.  `draws`: int64 [5] (spawn wanted, edge,
    position as its f32 value times 2^23, corner flip, radius).  Returns
    (rain', rain_map [H, W] bool); with `rows` (lo, hi), the rain map's
    rows [lo, hi) alone (a window of a split world)."""
    rain, maps = step_rain_ticks(cfg, H, W, rain, draws[None],
                                 force_spawn=force_spawn, rows=rows)
    return rain, maps[0]


def _spawn_params(cfg: Config, H: int, W: int, draws: torch.Tensor):
    """Per row of `draws` [n, 5] the cloud a spawn would place: start
    (x0, y0), velocity (vx, vy) and radius, f32 [n] each."""
    f32 = torch.float32
    edge, flip = draws[:, 1], draws[:, 3] != 0
    off = float(cfg.RAIN_SPAWN_OFFSET)
    ns = edge < 2                               # the N (0) or S (1) edge
    upos = draws[:, 2].to(f32) * float(2.0 ** -23)    # exact
    x0 = torch.where(ns, upos * W, torch.where(edge == 2, W - off, off))
    y0 = torch.where(ns, torch.where(edge == 0, H - off, off), upos * H)
    # the corner aimed at: from N / S, x = 0 if flipped else W and the
    # far side's y; from E, x = 0, from W, x = W, y = H if flipped else 0
    xt = W * torch.where(ns, ~flip, edge == 3).to(f32)
    yt = H * torch.where(ns, edge == 1, flip).to(f32)
    dx, dy = xt - x0, yt - y0
    ln = torch.clamp(torch.sqrt(_fma_f32(dx, dx, dy * dy)), min=1.0)
    return x0, y0, dx / ln, dy / ln, draws[:, 4].to(f32)


def step_rain_ticks(cfg: Config, H: int, W: int, rain: RainState,
                    draws: torch.Tensor, force_spawn=None, rows: tuple = None):
    """Advance clouds n ticks, `draws` int64 [n, 5] (a row per tick, as
    `step_rain` takes it); `force_spawn` applies to the first tick.
    Returns (rain', the rain map after each tick, bool [n, H, W], or
    [n, hi - lo, W]: rows [lo, hi) of it, with `rows`).  The
    spawn parameters depend on the draws alone and the disc raster on
    each tick's clouds alone, so both run for all n ticks at once; the
    clouds' motion, exits and the spawn decisions go tick by tick, in
    one launch of `hopper_engine.rain_ticks` on the card."""
    dev = rain.cx.device
    n = draws.shape[0]
    y0, y1 = (0, H) if rows is None else rows
    if not cfg.RAIN_ENABLED:
        return rain, torch.zeros((n, y1 - y0, W), dtype=torch.bool,
                                 device=dev)
    f32 = torch.float32

    def table(x, y, vx, vy, rad):
        # position, velocity, the exit bounds (x, y below -rad, x above
        # W + rad, y above H + rad) and the radius, a column per cloud
        return torch.stack([x, y, vx, vy, -rad, -rad, W + rad, H + rad, rad])

    spawn = table(*_spawn_params(cfg, H, W, draws))      # [9, n]
    want = draws[:, 0] != 0
    if force_spawn is not None:
        want = torch.cat([want[:1] | force_spawn, want[1:]])
    # a spawn needs a zero cooldown: a tick without one asks for -1
    want_cd = torch.where(want, 0, -1).to(torch.int32)
    seen, seen_a, cooldown = HE.rain_ticks(
        table(rain.cx, rain.cy, rain.vx, rain.vy, rain.radius), rain.active,
        rain.cooldown, spawn, want_cd,
        cfg.RAIN_COOLDOWN // cfg.TIME_PER_STEP_IN_SECONDS)
    clouds = seen[-1]                                    # [9, R]
    sp = torch.floor(seen[:, :2])
    sr = seen[:, 8]
    ys = torch.arange(y0, y1, dtype=f32, device=dev)[:, None]
    xs = torch.arange(W, dtype=f32, device=dev)[None, :]
    ddx = xs - sp[:, 0, :, None, None]                   # [n, R, 1, W]
    ddy = ys - sp[:, 1, :, None, None]                   # [n, R, H, 1]
    d2 = ddx * ddx + ddy * ddy                           # [n, R, H, W]
    covered = (d2 <= (sr * sr)[..., None, None]) & seen_a[..., None, None]
    return RainState(active=seen_a[-1], cx=clouds[0], cy=clouds[1],
                     vx=clouds[2], vy=clouds[3], radius=clouds[8],
                     cooldown=cooldown), covered.any(dim=1)


def cloud_ticks_plain(clouds, active, cooldown, spawn, want_cd, cool: int):
    """Plain version of `hopper_engine.rain_ticks` for one world: the
    cloud table [9, R] moved, its exits, the cooldown and the spawns
    tick by tick (the JAX `step_rain`'s order).  Returns the table and
    the active flags after each tick ([n, 9, R], [n, R]) and the final
    cooldown."""
    seen_c, seen_a = [], []
    for t in range(spawn.shape[1]):
        clouds = torch.cat([clouds[:2] + clouds[2:4], clouds[2:]])
        out = ((clouds[:2] < clouds[4:6])
               | (clouds[:2] > clouds[6:8])).any(dim=0)
        exited = active & out
        active = active ^ exited
        # the cooldown starts when the last cloud leaves
        cooldown = torch.where(exited.any() > active.any(), cool,
                               torch.clamp(cooldown - 1, min=0))
        # the first free slot takes the tick's cloud
        free = ~active
        do = free & (free.cumsum(0) == 1) & (cooldown == want_cd[t])
        active = active | do
        clouds = torch.where(do, spawn[:, t:t + 1], clouds)
        seen_c.append(clouds)
        seen_a.append(active)
    return torch.stack(seen_c), torch.stack(seen_a), cooldown.to(torch.int32)
