"""Road-band sampling (the JAX package's `gen/bands.py`), on the host.

A band is (start, end, road_class, dir_idx) on one axis; horizontal
bands are indexed by y (dir E or W), vertical ones by x (dir N or S).
The JAX scan draws a handful of scalars per band from its key chain, so
the port walks the same chain in numpy (`prng`) and keeps the band
tables as numpy arrays; `per_coord_tables` turns them into the
per-coordinate lookup tables that rasterisation reads.

f32 follows XLA: `mean + std * normal` is one fused multiply-add of the
erfinv draw and the folded constant SQRT2 * std (`prng.normal_erfinv`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import prng
from ..codes import RC_R1, RC_R2, RC_R3, N_IDX, E_IDX, S_IDX, W_IDX
from ..config import Config

f32 = np.float32


@dataclasses.dataclass
class Bands:
    start: np.ndarray    # i32 [MB]
    end: np.ndarray      # i32 [MB]
    rclass: np.ndarray   # i32 [MB] RC_R1/RC_R2/RC_R3
    dir: np.ndarray      # i32 [MB] direction index (R1: -1)
    valid: np.ndarray    # bool [MB]


def _thickness_table(cfg: Config):
    return (0, cfg.ROAD_THICKNESS_R1, cfg.ROAD_THICKNESS_R2,
            cfg.ROAD_THICKNESS_R3)


def _draw_p(key, mean: float, std: float):
    return prng._fma32(prng.normal_erfinv(key), prng.SQRT2 * f32(std),
                       f32(mean))


def choose_road_type(key, cfg: Config) -> int:
    """`_choose_road_type`: R1 with p_r1 ~ N(mean, std) clipped, R2 with
    p_r2, else R3."""
    k1, k2, k3 = prng.split(key, 3)
    p_r1 = np.clip(_draw_p(k1, cfg.R1_CHANCE_MEAN, cfg.R1_CHANCE_STD),
                   f32(0), f32(1))
    p_r2 = np.clip(np.minimum(f32(1.0) - p_r1,
                              _draw_p(k2, cfg.R2_CHANCE_MEAN,
                                      cfg.R2_CHANCE_STD)), f32(0), f32(1))
    r = prng.uniform(k3)
    if r < p_r1:
        return RC_R1
    return RC_R2 if r < f32(p_r1 + p_r2) else RC_R3


def sample_axis_bands(key, cfg: Config, start_coord: int, end_coord: int,
                      horizontal: bool, max_bands: int) -> Bands:
    """Random bands between start_coord and end_coord with the forced
    ring bands first and last (the JAX `sample_axis_bands`)."""
    thick_tab = _thickness_table(cfg)
    dir_pair = (E_IDX, W_IDX) if horizontal else (N_IDX, S_IDX)
    keys = prng.split(np.asarray(key, np.uint32), max_bands + 1)
    bs, be, rc, bd, bv = (np.zeros(max_bands, np.int32) for _ in range(5))
    bv = bv.astype(bool)
    current, last_r3, done = start_coord, -1, False
    for i in range(max_bands):
        kt, kd, ks = prng.split(keys[i], 3)
        rclass = choose_road_type(kt, cfg)
        bstart = current
        bend = min(bstart + thick_tab[rclass] - 1, end_coord)
        rand_dir = dir_pair[0] if prng.bernoulli(kd) else dir_pair[1]
        bdir = ((last_r3 + 2) % 4 if rclass == RC_R3 and last_r3 >= 0
                else rand_dir)
        next_pos = bend + 1
        block_end = next_pos + int(prng.randint(
            ks, cfg.MIN_BLOCK_SPACING, cfg.MAX_BLOCK_SPACING + 1)) - 1
        bs[i], be[i], rc[i], bd[i], bv[i] = bstart, bend, rclass, bdir, \
            not done
        if not done:
            current = block_end + 1
            last_r3 = bdir if rclass == RC_R3 else -1
        done = done or next_pos > end_coord or block_end > end_coord

    ring_rc = {"R1": RC_R1, "R2": RC_R2, "R3": RC_R3}[cfg.RING_ROAD_TYPE]
    forced_thick = cfg.road_thickness(cfg.RING_ROAD_TYPE)
    kf, kl = prng.split(keys[max_bands], 2)
    if cfg.RING_ROAD_TYPE == "R3":
        first_dir = E_IDX if horizontal else S_IDX
        last_dir = W_IDX if horizontal else N_IDX
    else:
        first_dir = dir_pair[0] if prng.bernoulli(kf) else dir_pair[1]
        last_dir = dir_pair[0] if prng.bernoulli(kl) else dir_pair[1]

    slots = np.arange(max_bands)
    is_first = slots == 0
    is_last = slots == max(int(bv.sum()) - 1, 1)
    bs = np.where(is_first, start_coord,
                  np.where(is_last, end_coord - forced_thick + 1, bs))
    be = np.where(is_first, start_coord + forced_thick - 1,
                  np.where(is_last, end_coord, be))
    rc = np.where(is_first | is_last, ring_rc, rc)
    bd = np.where(is_first, first_dir, np.where(is_last, last_dir, bd))
    bv = bv | is_first | is_last
    overlaps_last = (be >= end_coord - forced_thick + 1) & ~is_last
    bv = bv & ~(overlaps_last & ~is_first)
    i32 = np.int32
    return Bands(start=bs.astype(i32), end=be.astype(i32),
                 rclass=rc.astype(i32), dir=bd.astype(i32), valid=bv)


def ensure_minimum_highways(key, cfg: Config, bands: Bands, total_size: int,
                            inset: int) -> Bands:
    """Insert R1 bands until the non-ring R1 quota is met, removing the
    bands a new highway's exclusion range overlaps (the JAX
    `ensure_minimum_highways`, 20 attempts)."""
    thick = cfg.ROAD_THICKNESS_R1
    start_min, start_max = inset, total_size - thick - inset
    if start_min > start_max:
        start_min, start_max = 0, total_size - thick
    ring_is_r1 = cfg.RING_ROAD_TYPE == "R1"
    b = dataclasses.replace(bands, **{f.name: getattr(bands, f.name).copy()
                                      for f in dataclasses.fields(bands)})
    key = np.asarray(key, np.uint32)

    def count_r1():
        c = b.valid & (b.rclass == RC_R1)
        if ring_is_r1:
            starts = np.where(b.valid, b.start, 2**30)
            ends = np.where(b.valid, b.end, -1)
            c = c & (b.start != starts.min()) & (b.end != ends.max())
        return int(c.sum())

    for _ in range(20):
        key, kh = prng.split(key, 2)
        if count_r1() >= cfg.MIN_R1_BANDS:
            continue
        hw_start = int(prng.randint(kh, start_min, start_max + 1))
        hw_end = hw_start + thick - 1
        skip_lo = hw_start - cfg.MIN_BLOCK_SPACING
        skip_hi = hw_end + cfg.MIN_BLOCK_SPACING
        kill = b.valid & ~((b.end < skip_lo) | (b.start > skip_hi))
        b.valid = b.valid & ~kill
        free = int(np.argmin(b.valid))
        if not b.valid[free]:
            b.start[free], b.end[free] = hw_start, hw_end
            b.rclass[free], b.dir[free] = RC_R1, -1
            b.valid[free] = True
    return b


def per_coord_tables(bands: Bands, size: int) -> dict:
    """Per-coordinate lookup tables of a band list (numpy [size]):
    cover, rclass, offset, bsize, dir, is_first, is_last, and the first
    and last band's starts.  At most one band covers a coordinate."""
    coords = np.arange(size, dtype=np.int32)[:, None]
    covered = (coords >= bands.start[None]) & (coords <= bands.end[None]) \
        & bands.valid[None]
    any_cover = covered.any(axis=1)
    band_idx = covered.argmax(axis=1)
    first_band = int(np.argmin(np.where(bands.valid, bands.start, 2**30)))
    last_band = int(np.argmax(np.where(bands.valid, bands.end, -(2**30))))
    i32 = np.int32
    return dict(
        cover=any_cover,
        rclass=np.where(any_cover, bands.rclass[band_idx], 0).astype(i32),
        offset=np.where(any_cover, coords[:, 0] - bands.start[band_idx],
                        0).astype(i32),
        bsize=np.where(any_cover, bands.end[band_idx]
                       - bands.start[band_idx] + 1, 0).astype(i32),
        dir=np.where(any_cover, bands.dir[band_idx], -1).astype(i32),
        is_first=any_cover & (band_idx == first_band),
        is_last=any_cover & (band_idx == last_band),
        first_start=int(bands.start[first_band]),
        last_start=int(bands.start[last_band]),
    )
