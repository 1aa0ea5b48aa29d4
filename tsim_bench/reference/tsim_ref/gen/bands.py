# Frozen copy of trafficsimulation_tpu_torch/gen/bands.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
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


def choose_road_type(key, cfg: Config) -> np.ndarray:
    """`_choose_road_type` for a stack of keys [..., 2]: R1 with p_r1 ~
    N(mean, std) clipped, R2 with p_r2, else R3 (int32 [...])."""
    k1, k2, k3 = np.moveaxis(prng.split(key, 3), -2, 0)
    p_r1 = np.clip(_draw_p(k1, cfg.R1_CHANCE_MEAN, cfg.R1_CHANCE_STD),
                   f32(0), f32(1))
    p_r2 = np.clip(np.minimum(f32(1.0) - p_r1,
                              _draw_p(k2, cfg.R2_CHANCE_MEAN,
                                      cfg.R2_CHANCE_STD)), f32(0), f32(1))
    r = prng.uniform(k3)
    return np.where(r < p_r1, RC_R1, np.where(
        r < (p_r1 + p_r2).astype(f32), RC_R2, RC_R3)).astype(np.int32)


def sample_axis_bands_batch(keys, cfg: Config, start_coord: int,
                            end_coord: int, horizontal: bool,
                            max_bands: int) -> Bands:
    """`sample_axis_bands` for a stack of keys [B, 2], fields [B,
    max_bands].  The scan draws from the same keys whatever the bands
    (every band's draws are taken), so the draws of all worlds and bands
    come first, then the scan's state walks the bands with the worlds
    side by side."""
    keys = np.asarray(keys, np.uint32)
    B = keys.shape[0]
    thick_tab = np.asarray(_thickness_table(cfg), np.int64)
    dir_pair = (E_IDX, W_IDX) if horizontal else (N_IDX, S_IDX)
    kall = prng.split(keys, max_bands + 1)             # [B, MB + 1, 2]
    kt, kd, ks = np.moveaxis(prng.split(kall[:, :max_bands], 3), -2, 0)
    rclass = choose_road_type(kt, cfg).reshape(B, max_bands)
    rand_dir = np.where(prng.uniform(kd) < f32(0.5), dir_pair[0],
                        dir_pair[1]).reshape(B, max_bands)
    spacing = np.asarray(prng.randint(
        ks, cfg.MIN_BLOCK_SPACING, cfg.MAX_BLOCK_SPACING + 1),
        np.int64).reshape(B, max_bands)
    bs, be, rc, bd = (np.zeros((B, max_bands), np.int64) for _ in range(4))
    bv = np.zeros((B, max_bands), bool)
    current = np.full(B, start_coord, np.int64)
    last_r3 = np.full(B, -1, np.int64)
    done = np.zeros(B, bool)
    for i in range(max_bands):
        rci = rclass[:, i]
        bstart = current
        bend = np.minimum(bstart + thick_tab[rci] - 1, end_coord)
        bdir = np.where((rci == RC_R3) & (last_r3 >= 0), (last_r3 + 2) % 4,
                        rand_dir[:, i])
        next_pos = bend + 1
        block_end = next_pos + spacing[:, i] - 1
        bs[:, i], be[:, i], rc[:, i], bd[:, i] = bstart, bend, rci, bdir
        bv[:, i] = ~done
        current = np.where(done, current, block_end + 1)
        last_r3 = np.where(done, last_r3,
                           np.where(rci == RC_R3, bdir, -1))
        done = done | (next_pos > end_coord) | (block_end > end_coord)

    ring_rc = {"R1": RC_R1, "R2": RC_R2, "R3": RC_R3}[cfg.RING_ROAD_TYPE]
    forced_thick = cfg.road_thickness(cfg.RING_ROAD_TYPE)
    kf, kl = np.moveaxis(prng.split(kall[:, max_bands], 2), -2, 0)
    if cfg.RING_ROAD_TYPE == "R3":
        first_dir = np.full(B, E_IDX if horizontal else S_IDX)
        last_dir = np.full(B, W_IDX if horizontal else N_IDX)
    else:
        first_dir = np.where(prng.uniform(kf) < f32(0.5), dir_pair[0],
                             dir_pair[1])
        last_dir = np.where(prng.uniform(kl) < f32(0.5), dir_pair[0],
                            dir_pair[1])

    slots = np.arange(max_bands)[None]
    is_first = slots == 0
    is_last = slots == np.maximum(bv.sum(axis=1) - 1, 1)[:, None]
    bs = np.where(is_first, start_coord,
                  np.where(is_last, end_coord - forced_thick + 1, bs))
    be = np.where(is_first, start_coord + forced_thick - 1,
                  np.where(is_last, end_coord, be))
    rc = np.where(is_first | is_last, ring_rc, rc)
    bd = np.where(is_first, first_dir[:, None],
                  np.where(is_last, last_dir[:, None], bd))
    bv = bv | is_first | is_last
    overlaps_last = (be >= end_coord - forced_thick + 1) & ~is_last
    bv = bv & ~(overlaps_last & ~is_first)
    i32 = np.int32
    return Bands(start=bs.astype(i32), end=be.astype(i32),
                 rclass=rc.astype(i32), dir=bd.astype(i32), valid=bv)


def ensure_minimum_highways_batch(keys, cfg: Config, bands: Bands,
                                  total_size: int, inset: int) -> Bands:
    """Insert R1 bands until the non-ring R1 quota is met, removing the
    bands a new highway's exclusion range overlaps (the JAX
    `ensure_minimum_highways`, 20 attempts), for a stack of keys [B, 2]
    and bands [B, MB], the worlds side by side (each attempt draws from
    its key whether or not the world needs a highway)."""
    thick = cfg.ROAD_THICKNESS_R1
    start_min, start_max = inset, total_size - thick - inset
    if start_min > start_max:
        start_min, start_max = 0, total_size - thick
    ring_is_r1 = cfg.RING_ROAD_TYPE == "R1"
    b = dataclasses.replace(bands, **{f.name: getattr(bands, f.name).copy()
                                      for f in dataclasses.fields(bands)})
    key = np.asarray(keys, np.uint32)
    rows = np.arange(key.shape[0])

    def count_r1():
        c = b.valid & (b.rclass == RC_R1)
        if ring_is_r1:
            starts = np.where(b.valid, b.start, 2**30)
            ends = np.where(b.valid, b.end, -1)
            c = c & (b.start != starts.min(axis=1, keepdims=True)) \
                & (b.end != ends.max(axis=1, keepdims=True))
        return c.sum(axis=1)

    for _ in range(20):
        key, kh = np.moveaxis(prng.split(key, 2), -2, 0)
        need = count_r1() < cfg.MIN_R1_BANDS
        hw_start = np.asarray(prng.randint(kh, start_min, start_max + 1),
                              np.int64).reshape(-1)
        hw_end = hw_start + thick - 1
        skip_lo = (hw_start - cfg.MIN_BLOCK_SPACING)[:, None]
        skip_hi = (hw_end + cfg.MIN_BLOCK_SPACING)[:, None]
        kill = b.valid & ~((b.end < skip_lo) | (b.start > skip_hi)) \
            & need[:, None]
        b.valid = b.valid & ~kill
        free = np.argmin(b.valid, axis=1)
        put = need & ~b.valid[rows, free]
        r, f = rows[put], free[put]
        b.start[r, f], b.end[r, f] = hw_start[put], hw_end[put]
        b.rclass[r, f], b.dir[r, f] = RC_R1, -1
        b.valid[r, f] = True
    return b


def per_coord_tables(bands: Bands, size: int) -> dict:
    """Per-coordinate lookup tables of a band list (numpy [size]):
    cover, rclass, offset, bsize, dir, is_first, is_last, and the first
    and last band's starts (ints).  At most one band covers a
    coordinate.  Bands with a leading batch dim [B, MB] give tables
    [B, size] and starts [B]."""
    one = bands.start.ndim == 1
    if one:
        bands = Bands(**{f.name: getattr(bands, f.name)[None]
                         for f in dataclasses.fields(bands)})
    coords = np.arange(size, dtype=np.int32)[None, :, None]
    covered = (coords >= bands.start[:, None]) \
        & (coords <= bands.end[:, None]) & bands.valid[:, None]
    any_cover = covered.any(axis=2)
    band_idx = covered.argmax(axis=2)
    rows = np.arange(bands.start.shape[0])
    first_band = np.argmin(np.where(bands.valid, bands.start, 2**30), axis=1)
    last_band = np.argmax(np.where(bands.valid, bands.end, -(2**30)), axis=1)

    def at(a):
        return np.take_along_axis(a, band_idx, axis=1)
    i32 = np.int32
    out = dict(
        cover=any_cover,
        rclass=np.where(any_cover, at(bands.rclass), 0).astype(i32),
        offset=np.where(any_cover, coords[..., 0] - at(bands.start),
                        0).astype(i32),
        bsize=np.where(any_cover, at(bands.end) - at(bands.start) + 1,
                       0).astype(i32),
        dir=np.where(any_cover, at(bands.dir), -1).astype(i32),
        is_first=any_cover & (band_idx == first_band[:, None]),
        is_last=any_cover & (band_idx == last_band[:, None]),
        first_start=bands.start[rows, first_band].astype(i32),
        last_start=bands.start[rows, last_band].astype(i32),
    )
    if one:
        out = {k: v[0] for k, v in out.items()}
        out["first_start"] = int(out["first_start"])
        out["last_start"] = int(out["last_start"])
    return out
