"""Hierarchical two-level routing (the JAX package's `ops/hier.py`; its
docstring gives the design and the declared deviation).

Every destination gets a routing id rid = tile * LMAX + l in the tile
that holds it (or a neighbour), an exact static next-move byte for each
cell of its tile's 3x3 window (the windowed stack `local_sdir4`), and a
hub row per 2x2-tile region in the dense, dynamically rebuilt stack;
exits and overflow destinations get dense rows of their own ("direct"
rids >= NT * LMAX).  A cell takes the windowed byte where its tile lies
in the destination's window and the byte offers a move, else the dense
row's.  On the card the tick's selects run inside K1-hier
(`hopper_engine.decide_move` with `hier=(local4, kernel_consts(cfg))`);
`hier_select` is their plain version, two K6 launches
(`hopper_engine.select_rows`) on a card.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..config import Config
from . import hopper_engine as HE

RID_BITS = 14             # width of the planes' dest field
RID_SPACE = 1 << RID_BITS


@dataclasses.dataclass(frozen=True)
class HierParams:
    ts: int        # tile side (a power of two)
    ts_sh: int     # log2(ts)
    lmax: int
    nty: int
    ntx: int
    nt: int
    direct_base: int   # nt * lmax; rids from here on are direct rows
    nry: int
    nrx: int
    nr: int        # regions (hubs)


@functools.lru_cache(maxsize=32)
def hier_params(cfg: Config) -> HierParams:
    ts = cfg.HIER_TILE
    lmax = cfg.HIER_LMAX
    if ts < 1 or ts & (ts - 1) or cfg.HEIGHT % ts or cfg.WIDTH % ts:
        raise ValueError("HIER_TILE must be a power of two dividing HEIGHT "
                         "and WIDTH for ROUTING_HIER")
    if lmax % 4:
        raise ValueError("HIER_LMAX must be a multiple of 4")
    nty, ntx = cfg.HEIGHT // ts, cfg.WIDTH // ts
    nt = nty * ntx
    direct_base = nt * lmax
    if direct_base >= RID_SPACE:
        raise ValueError(f"tile id space {direct_base} exceeds the "
                         f"{RID_BITS}-bit dest field")
    nry, nrx = (nty + 1) // 2, (ntx + 1) // 2
    return HierParams(ts=ts, ts_sh=ts.bit_length() - 1, lmax=lmax,
                      nty=nty, ntx=ntx, nt=nt, direct_base=direct_base,
                      nry=nry, nrx=nrx, nr=nry * nrx)


@functools.lru_cache(maxsize=32)
def _magic(d: int, xmax: int) -> tuple:
    """(m, sh) with floor(x / d) == (x * m) >> sh for 0 <= x <= xmax in
    int32 (m = 1 for a power of two), checked over the whole range (the
    JAX `_magic_div`)."""
    if d & (d - 1) == 0:
        return 1, d.bit_length() - 1
    sh = 20
    m = -(-(1 << sh) // d)
    if xmax * (m * d - (1 << sh)) >= (1 << sh) or xmax * m >= (1 << 31):
        raise ValueError(f"no exact int32 magic division by {d} up to "
                         f"{xmax}")
    return m, sh


def _magic_div(x: torch.Tensor, d: int, xmax: int) -> torch.Tensor:
    """floor(x / d) for 0 <= x <= xmax as one int32 multiply and shift."""
    m, sh = _magic(d, xmax)
    return (x * m) >> sh


@functools.lru_cache(maxsize=32)
def kernel_consts(cfg: Config) -> tuple:
    """The constants of K1-hier's row select (`HierConsts` in
    csrc/decide_move.cuh), in its order: (ts_sh, lmax, lmax_m, lmax_sh,
    ntx, ntx_m, ntx_sh, direct_base, nrx, nr); each division by LMAX or
    by the tile columns is the multiplier and shift of `_magic`, so the
    kernel computes `hier_rows` without dividing."""
    hp = hier_params(cfg)
    return (hp.ts_sh, hp.lmax, *_magic(hp.lmax, hp.direct_base - 1),
            hp.ntx, *_magic(hp.ntx, hp.nt - 1), hp.direct_base, hp.nrx,
            hp.nr)


def hier_rows(cfg: Config, dest: torch.Tensor, row0: int = 0):
    """(p, r) from the rid plane `dest` (int32 [H, W]): p the windowed
    stack's plane, -1 where the cell lies outside the destination's 3x3
    window or the rid is direct; r the dense row (the region's hub for a
    tiled rid, its own row for a direct one).  `row0`: the world's row
    of the plane's first row (a window of a split world,
    `parallel/spatial.py`), whose tiles are the world's."""
    hp = hier_params(cfg)
    H, W = dest.shape[-2:]
    yy = torch.arange(row0, row0 + H, dtype=torch.int32,
                      device=dest.device)[:, None]
    xx = torch.arange(W, dtype=torch.int32, device=dest.device)[None, :]
    tiled = dest < hp.direct_base
    d_t = torch.where(tiled, dest, 0)
    td = _magic_div(d_t, hp.lmax, hp.direct_base - 1)
    l = d_t - td * hp.lmax
    ty = _magic_div(td, hp.ntx, hp.nt - 1)
    tx = td - ty * hp.ntx
    dy = ty - (yy >> hp.ts_sh)
    dx = tx - (xx >> hp.ts_sh)
    in_win = tiled & (dy.abs() <= 1) & (dx.abs() <= 1)
    p = torch.where(in_win, ((dy + 1) * 3 + (dx + 1)) * hp.lmax + l, -1)
    hub = (ty >> 1) * hp.nrx + (tx >> 1)
    r = torch.where(tiled, hub, hp.nr + (dest - hp.direct_base))
    return p.to(torch.int32), r.to(torch.int32)


def hier_select(cfg: Config, dense4: torch.Tensor, local4: torch.Tensor,
                dest: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """The next-move byte plane under hierarchical routing: the exact
    windowed byte where it exists and offers a move, else the dense
    (hub or direct) row's; `row0` as in `hier_rows`.  Two K6 launches
    on the card; K1-hier's `HierSelect` computes the same at one cell."""
    p, r = hier_rows(cfg, dest, row0)
    nd_loc = HE.select_rows(local4, p)
    nd_den = HE.select_rows(dense4, r)
    use_loc = (p >= 0) & ((nd_loc & 7) != 7)
    return torch.where(use_loc, nd_loc, nd_den)
