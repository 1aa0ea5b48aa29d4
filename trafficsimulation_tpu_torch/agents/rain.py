"""Rain clouds as vectorized disc rasterization (the JAX package's
`agents/rain.py`).

The five random scalars of a tick (spawn wanted, edge, position, corner
flip, radius) arrive as one int64 row drawn on the host by
`ops.engine.tick_draws` with JAX's key chain.  The float math keeps the
JAX op order; XLA on the CPU evaluates `dx * dx + dy * dy` as one fused
multiply-add, fma(dx, dx, dy * dy), which `_fma_f32` reproduces.
"""

from __future__ import annotations

import torch

from trafficsimulation_tpu.config import Config

from ..core.state import RainState


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
              draws: torch.Tensor, force_spawn=None):
    """Advance clouds one tick.  `draws`: int64 [5] (spawn wanted, edge,
    position as f32 bits, corner flip, radius).  Returns (rain',
    rain_map [H, W] bool)."""
    dev = rain.cx.device
    if not cfg.RAIN_ENABLED:
        return rain, torch.zeros((H, W), dtype=torch.bool, device=dev)
    R = cfg.RAIN_OCCURRENCES_MAX
    f32 = torch.float32

    cx = rain.cx + rain.vx
    cy = rain.cy + rain.vy
    exited = rain.active & (
        (cx < -rain.radius) | (cx > W + rain.radius) |
        (cy < -rain.radius) | (cy > H + rain.radius))
    active = rain.active & ~exited
    none_left = ~active.any()
    cooldown = torch.where(
        exited.any() & none_left,
        cfg.RAIN_COOLDOWN // cfg.TIME_PER_STEP_IN_SECONDS,
        torch.clamp(rain.cooldown - 1, min=0)).to(torch.int32)

    want = draws[0] != 0
    if force_spawn is not None:
        want = want | force_spawn
    can = (active.sum() < R) & (cooldown == 0) & want
    slot = torch.argmin(active.to(torch.int32))      # first inactive slot
    edge = draws[1]
    off = float(cfg.RAIN_SPAWN_OFFSET)
    upos = draws[2].to(torch.int32).view(f32)
    x0 = torch.where(edge == 0, upos * W, torch.where(
        edge == 1, upos * W, torch.where(edge == 2, W - off, off)))
    y0 = torch.where(edge == 0, H - off,
                     torch.where(edge == 1, off, upos * H))
    flip = draws[3] != 0
    xt = torch.where(edge == 0, torch.where(flip, 0.0, float(W)),
                     torch.where(edge == 1, torch.where(flip, 0.0, float(W)),
                                 torch.where(edge == 2, 0.0, float(W))))
    yt = torch.where(edge == 2, torch.where(flip, float(H), 0.0),
                     torch.where(edge == 3, torch.where(flip, float(H), 0.0),
                                 torch.where(edge == 0, 0.0, float(H))))
    dx, dy = xt - x0, yt - y0
    ln = torch.clamp(torch.sqrt(_fma_f32(dx, dx, dy * dy)), min=1.0)
    radius = draws[4].to(f32)

    # the slot's row as a mask: indexing with a device scalar would make
    # the host wait for the device
    sel = torch.arange(R, device=dev) == slot
    do = sel & can & ~(active & sel).any()
    active = active | do
    cx = torch.where(do, x0, cx)
    cy = torch.where(do, y0, cy)
    vx = torch.where(do, dx / ln, rain.vx)
    vy = torch.where(do, dy / ln, rain.vy)
    rad = torch.where(do, radius, rain.radius)

    ys = torch.arange(H, dtype=f32, device=dev)[:, None]
    xs = torch.arange(W, dtype=f32, device=dev)[None, :]
    icx = torch.floor(cx)
    icy = torch.floor(cy)
    ddx = xs[None] - icx[:, None, None]
    ddy = ys[None] - icy[:, None, None]
    d2 = ddx * ddx + ddy * ddy                           # [R, H, W]
    covered = (d2 <= (rad * rad)[:, None, None]) & active[:, None, None]
    rain_map = covered.any(dim=0)
    return RainState(active=active, cx=cx, cy=cy, vx=vx, vy=vy, radius=rad,
                     cooldown=cooldown), rain_map
