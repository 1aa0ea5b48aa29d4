"""Zoning, dead-end elimination, R2 upgrades, block entrances and service
cells (the JAX package's `gen/zoning.py`; its docstring gives the
reference stages and the parity notes).  Segment min / max / sum run on
integers, so the scatter-reduces below are exact in any order."""

from __future__ import annotations

import numpy as np
import torch

from .. import codes as C
from .. import prng
from ..config import Config
from ..ops.engine import _hash32, _M32
from ..ops.labels import (BIG, compact_labels, connected_components,
                          connected_components_keyed, seg_max, seg_min,
                          seg_sum, set_last)
from .raster import shift_from

U8 = torch.uint8
I32 = torch.int32


def _isin(x: torch.Tensor, codes) -> torch.Tensor:
    return torch.isin(x, torch.tensor(codes, dtype=x.dtype, device=x.device))


def _flat_xy(H: int, W: int, device):
    flat = torch.arange(H * W, dtype=I32, device=device)
    return flat, flat % W, torch.div(flat, W, rounding_mode="floor")


def zone_cum(cfg: Config) -> np.ndarray:
    """Cumulative block-type weights in f32, summed left to right."""
    w = np.asarray([w for _, w in cfg.CITY_BLOCK_CHANCE], np.float32)
    return np.cumsum(w / w.sum(dtype=np.float32), dtype=np.float32)


def apply_zoning(key, cfg: Config, cell: torch.Tensor, max_blocks: int):
    """Flood-fill `Nothing` regions into typed blocks: (cell, block_id
    map i32 [H, W], block_type u8 [B], inner_count i32 [B], valid
    [B])."""
    H, W = cell.shape
    dev = cell.device
    labels = connected_components(cell == C.NOTHING)
    ids_map, roots, _ = compact_labels(labels, max_blocks)
    flat_ids = ids_map.reshape(-1)
    seg = torch.where(flat_ids >= 0, flat_ids, max_blocks)
    _, xs, ys = _flat_xy(H, W, dev)
    nseg = max_blocks + 1
    minx = seg_min(xs, seg, nseg, BIG)[:max_blocks]
    maxx = seg_max(xs, seg, nseg, -1)[:max_blocks]
    miny = seg_min(ys, seg, nseg, BIG)[:max_blocks]
    maxy = seg_max(ys, seg, nseg, -1)[:max_blocks]
    count = seg_sum(torch.ones_like(seg), seg, nseg)[:max_blocks]
    valid = roots >= 0
    small = (maxx - minx + 1 < 3) | (maxy - miny + 1 < 3)

    names = [n for n, _ in cfg.CITY_BLOCK_CHANCE]
    codes = torch.tensor([C.NAME_TO_TYPE[n] for n in names], dtype=U8,
                         device=dev)
    cum = torch.from_numpy(zone_cum(cfg)).to(dev)
    u = torch.from_numpy(prng.uniform(key, (max_blocks,))).to(dev)
    draw = (u[:, None] >= cum[None, :]).sum(dim=1)
    btype = codes[draw.clamp(0, len(names) - 1)]
    btype = torch.where(small, C.EMPTY, btype)
    btype = torch.where(valid, btype, C.NOTHING)
    painted = torch.where(ids_map >= 0,
                          btype[ids_map.clamp(0, max_blocks - 1).long()],
                          cell)
    return painted, ids_map, btype, count.to(I32), valid


def eliminate_dead_ends(cell: torch.Tensor, allowed: torch.Tensor):
    """Removable road cells with fewer than 2 road-like neighbours become
    Sidewalk, until none is left (a parallel fixpoint)."""
    while True:
        roady = _isin(cell, C.ROAD_LIKE)
        deg = sum(shift_from(roady, d).to(I32) for d in range(4))
        dead = _isin(cell, C.REMOVABLE_DEAD_END) & (deg < 2)
        if not bool(dead.any()):
            return cell, allowed
        cell = torch.where(dead, C.SIDEWALK, cell)
        allowed = torch.where(dead, 0, allowed)


def upgrade_r2_to_intersections(cfg: Config, cell, allowed, horiz_band,
                                in_ring_corner):
    """R2 cells flanked by >= 2 sidewalks become intersections where a
    perpendicular sub-block-road-type neighbour crosses them."""
    sub_code = C.NAME_TO_TYPE[cfg.SUBBLOCK_ROAD_TYPE]
    sw = cell == C.SIDEWALK
    sw_count = sum(shift_from(sw, d).to(I32) for d in range(4))
    is_sub = cell == sub_code
    perp_h = shift_from(is_sub, C.N_IDX) | shift_from(is_sub, C.S_IDX)
    perp_v = shift_from(is_sub, C.E_IDX) | shift_from(is_sub, C.W_IDX)
    has_cross = torch.where(horiz_band, perp_h, perp_v)
    upgrade = (cell == C.R2) & (sw_count >= 2) & has_cross
    if cfg.RING_ROAD_TYPE == "R2":
        upgrade = upgrade & ~in_ring_corner
    cell = torch.where(upgrade, C.INTERSECTION, cell)
    allowed = torch.where(upgrade, 15, allowed)
    return cell, allowed, upgrade


def prune_intersection_dirs(cell, allowed):
    """An intersection keeps an arrow only toward a road-like neighbour
    that is an intersection or accepts the flow."""
    road_like = _isin(cell, C.ROAD_LIKE)
    inter = cell == C.INTERSECTION
    out = allowed
    for d in range(4):
        b = C.DIR_BITS[d]
        ok = shift_from(road_like, d) & (shift_from(inter, d) | (
            (shift_from(allowed, d) & b) != 0))
        out = torch.where(inter & ~ok, out & (0xFF ^ b), out)
    return out


def _ring_block(block_ids):
    ring = torch.full_like(block_ids, -1)
    src = torch.where(block_ids >= 0, block_ids, -1)
    for d in range(4):
        ring = torch.maximum(ring, shift_from(src, d))
    return torch.where(block_ids >= 0, -1, ring)


def place_entrances(cfg: Config, cell, allowed, block_ids, btype,
                    max_blocks: int, key=None):
    """One BlockEntrance per typed block at the middle of its longest
    road-touching perimeter run, (x, y)-ordered; ties between runs broken
    by a hash of the run root salted from `key` (the JAX
    `place_entrances`).  Returns (cell, allowed, entrance_flat [B]
    i32)."""
    H, W = cell.shape
    HW = H * W
    dev = cell.device
    ring_block = _ring_block(block_ids)
    blk_is_zone = _isin(btype, C.ZONE_TYPES)
    safe_rb = ring_block.clamp(0, max_blocks - 1).long()
    ring_ok = (ring_block >= 0) & blk_is_zone[safe_rb]

    touchy = _isin(cell, (C.R1, C.R2, C.R3, C.INTERSECTION,
                          C.HIGHWAY_ENTRANCE, C.CONTROLLED_ROAD))
    touches = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for d in range(4):
        touches = touches | shift_from(touchy, d)
    cand = ring_ok & touches & (cell == C.SIDEWALK)

    lvl = min(cfg.BLOCK_ENTRANCE_ROAD_LEVEL, 2)
    if lvl > 0:
        good = _isin(cell, (C.R1,) if lvl == 2 else (C.R1, C.R2))
        passes = torch.zeros_like(cand)
        for d in range(4):
            passes = passes | shift_from(good, d)
        seg = torch.where(cand & passes, safe_rb, max_blocks).reshape(-1)
        has_pref = seg_sum(torch.ones_like(seg), seg,
                           max_blocks + 1)[:max_blocks] > 0
        cand = cand & (passes | ~has_pref[safe_rb])

    runs = connected_components_keyed(cand, torch.where(cand, ring_block,
                                                        -1))
    flat_runs = runs.reshape(-1)
    rseg = torch.where(flat_runs >= 0, flat_runs, HW)
    flat, xs, ys = _flat_xy(H, W, dev)
    run_len_tab = seg_sum((flat_runs >= 0).to(I32), rseg, HW + 1)
    cand_flat = cand.reshape(-1)
    my_run = flat_runs.clamp(0, HW).long()
    my_len = torch.where(cand_flat, run_len_tab[my_run], 0)
    bseg = torch.where(cand_flat, ring_block.reshape(-1), max_blocks)
    bseg = bseg.clamp(0, max_blocks).long()

    best_len = seg_max(my_len, bseg, max_blocks + 1, 0)
    is_best_len = cand_flat & (my_len == best_len[bseg]) & (my_len > 0)
    if key is not None:
        salt = int(prng.bits(key, ()))
        tiekey = (_hash32((flat_runs.to(torch.int64) & _M32) ^ salt)
                  >> 2).to(I32)
    else:
        tiekey = flat_runs
    best_tk = seg_min(torch.where(is_best_len, tiekey, BIG), bseg,
                      max_blocks + 1, BIG)
    in_best = is_best_len & (tiekey == best_tk[bseg]) & (best_tk[bseg] < BIG)

    # middle cell of the (x, y)-ordered run: rank every candidate by
    # (run, x, y); the pairs are unique, so the order is total
    runkey = torch.where(cand_flat, my_run, HW).to(torch.int64)
    order = torch.argsort(runkey * HW + (xs * H + ys).to(torch.int64))
    rank = torch.empty(HW, dtype=I32, device=dev)
    rank[order] = flat
    run_rank0 = seg_min(torch.where(cand_flat, rank, BIG), rseg, HW + 1, BIG)
    pos = rank - run_rank0[my_run]
    at_mid = in_best & (pos == torch.div(my_len, 2, rounding_mode="floor"))
    entrance_flat = seg_min(torch.where(at_mid, flat, BIG), bseg,
                            max_blocks + 1, BIG)[:max_blocks]
    entrance_flat = torch.where(entrance_flat >= BIG, -1, entrance_flat)

    ent_mask = set_last(torch.zeros(HW, dtype=torch.bool, device=dev),
                        torch.where(entrance_flat >= 0, entrance_flat, 0),
                        entrance_flat >= 0).reshape(H, W)
    cell = torch.where(ent_mask, C.BLOCK_ENTRANCE, cell)
    allowed = torch.where(ent_mask, 0, allowed)
    return cell, allowed, entrance_flat


def place_service_cells(cell, block_ids, btype, entrance_flat,
                        max_blocks: int):
    """Per block, the road cell nearest its entrance (Manhattan) that
    touches the block's sidewalk ring and is not in front of the
    entrance: service_flat [B] i32, -1 where there is none."""
    H, W = cell.shape
    HW = H * W
    dev = cell.device
    ring_block = torch.where(cell == C.SIDEWALK, _ring_block(block_ids), -1)
    road_mask = _isin(cell, (C.R1, C.R2, C.R3))
    cand_block = torch.full_like(ring_block, -1)
    for d in range(4):
        cand_block = torch.maximum(cand_block, shift_from(ring_block, d))
    cand_block = torch.where(road_mask, cand_block, -1)

    ent_mask = set_last(torch.zeros(HW, dtype=torch.bool, device=dev),
                        torch.where(entrance_flat >= 0, entrance_flat,
                                    HW - 1),
                        entrance_flat >= 0).reshape(H, W)
    near_ent = torch.zeros_like(ent_mask)
    for d in range(4):
        near_ent = near_ent | shift_from(ent_mask, d)
    cand_block = torch.where(near_ent, -1, cand_block)

    flat, xs, ys = _flat_xy(H, W, dev)
    cb = cand_block.reshape(-1)
    safe_b = cb.clamp(0, max_blocks - 1).long()
    e = entrance_flat[safe_b]
    valid = (cb >= 0) & (e >= 0)
    dist = (xs - e % W).abs() + (ys - torch.div(e, W, rounding_mode="floor")
                                 ).abs()
    seg = torch.where(valid, safe_b, max_blocks)
    min_dist = seg_min(torch.where(valid, dist, BIG), seg, max_blocks + 1,
                       BIG)
    at_min = valid & (dist == min_dist[seg])
    service_flat = seg_min(torch.where(at_min, flat, BIG), seg,
                           max_blocks + 1, BIG)[:max_blocks]
    return torch.where(service_flat >= BIG, -1, service_flat)


def add_entrance_directions(cell, allowed):
    """Roads next to a BlockEntrance gain an arrow into it; the entrance
    gets the arrows back toward them."""
    is_ent = cell == C.BLOCK_ENTRANCE
    road_like = _isin(cell, C.ROAD_LIKE)
    out = allowed
    for d in range(4):
        od = (d + 2) % 4
        out = torch.where(road_like & shift_from(is_ent, d) & ~is_ent,
                          out | C.DIR_BITS[d], out)
        out = torch.where(is_ent & shift_from(road_like & ~is_ent, od),
                          out | C.DIR_BITS[od], out)
    return out
