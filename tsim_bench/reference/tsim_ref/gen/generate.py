# Frozen copy of trafficsimulation_tpu_torch/gen/generate.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
"""The procedural generation pipeline (the JAX package's
`gen/generate.py`): bands, rasterisation, optional sub-block roads,
zoning, dead ends, R2 upgrades, entrances, lights and groups, the
destination table and the cost field of its first MAX_FIELD_DESTS rows.

The band scans and every other draw from the key run on the host
(`city_draws`); every plane stage runs on `device` (the card unless the
caller asks for the CPU) as a function of those draws and nothing else
(`city_from_draws`), so that a batch of cities runs it once under
`torch.func.vmap` (`sim.init_worlds`)."""

from __future__ import annotations

import numpy as np
import torch

from .. import codes as C
from .. import prng
from ..config import Config
from ..core.state import (BlockStatic, DestStatic, Grid, GroupStatic,
                          LightStatic)
from ..ops.labels import nonzero_fixed, set_last
from ..ops.routing import compute_cost_fields
from .bands import (Bands, ensure_minimum_highways_batch, per_coord_tables,
                    sample_axis_bands_batch)
from .lights import build_lights_and_groups
from .raster import rasterize
from .zoning import (_isin, add_entrance_directions, apply_zoning,
                     eliminate_dead_ends, place_entrances,
                     place_service_cells, prune_intersection_dirs,
                     upgrade_r2_to_intersections)

U8, I32 = torch.uint8, torch.int32


def _routing_road_class(cell, orig_type, ring_corner):
    """road_type_map: R1, intersections, entrances and exits (and the
    ring-corner R2) -> 1, R2 -> 2, R3 -> 3, else 0; controlled roads by
    their original type."""
    base = torch.where(_isin(cell, (C.INTERSECTION, C.HIGHWAY_ENTRANCE,
                                    C.HIGHWAY_EXIT, C.BLOCK_ENTRANCE)), 1, 0)
    t = torch.where(cell == C.CONTROLLED_ROAD, orig_type, cell)
    base = torch.where(t == C.R1, 1, base)
    base = torch.where(t == C.R2, torch.where(ring_corner, 1, 2), base)
    base = torch.where(t == C.R3, 3, base)
    return base.to(U8)


def city_draws(cfg: Config, key) -> dict:
    """The host part of `generate_city`: everything the city draws from
    its uint32 [2] key, as numpy arrays: both axes' band lists (`hb_*`,
    `vb_*`) and their per-coordinate tables (`ht_*`, `vt_*`), the zoning
    uniforms and the entrance tie-break salt (the copy leaves out
    CARVE_SUBBLOCK_ROADS, off in the benchmark's configurations).  A stack of keys [B, 2] gives every
    array a leading B: the worlds' draws side by side."""
    keys = np.asarray(key, np.uint32)
    one = keys.ndim == 1
    keys = keys.reshape(-1, 2)
    caps = cfg.capacities()
    H, W = cfg.HEIGHT, cfg.WIDTH
    kh, kv, khm, kvm, kz, kent = np.moveaxis(prng.split(keys, 6), -2, 0)

    hbands = sample_axis_bands_batch(kh, cfg, cfg.interior_y_min,
                                     cfg.interior_y_max, True,
                                     caps.max_bands)
    vbands = sample_axis_bands_batch(kv, cfg, cfg.interior_x_min,
                                     cfg.interior_x_max, False,
                                     caps.max_bands)
    inset = cfg.interior_x_min + cfg.HIGHWAY_OFFSET
    hbands = ensure_minimum_highways_batch(khm, cfg, hbands, H, inset)
    vbands = ensure_minimum_highways_batch(kvm, cfg, vbands, W, inset)
    out = {}
    for tag, bands, n in (("h", hbands, H), ("v", vbands, W)):
        for f in ("start", "end", "valid"):
            out[f"{tag}b_{f}"] = getattr(bands, f)
        for k, v in per_coord_tables(bands, n).items():
            out[f"{tag}t_{k}"] = v
    if cfg.CARVE_SUBBLOCK_ROADS:
        raise ValueError("the reference leaves out CARVE_SUBBLOCK_ROADS")
    out["zone_u"] = prng.uniform(kz, (caps.max_blocks,))
    out["ent_salt"] = np.asarray(prng.bits(kent, ()), np.int64)
    return {k: np.asarray(v)[0] if one else np.asarray(v)
            for k, v in out.items()}


def draws_to(draws: dict, device) -> dict:
    """The draws of `city_draws` as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in draws.items()}


def city_cost_field(cfg: Config, grid: Grid, dests: DestStatic):
    """The cost field of the city's first MAX_FIELD_DESTS destinations,
    f32 [..., DF, 4, H, W] (leading batch dims allowed)."""
    caps = cfg.capacities()
    DF = min(caps.max_dests, cfg.MAX_FIELD_DESTS or caps.max_dests)
    return compute_cost_fields(cfg, grid.allowed_dirs, grid.road_class,
                               dests.pos[..., :DF], dests.valid[..., :DF],
                               is_road=grid.is_road)


def city_from_draws(cfg: Config, draws: dict):
    """The device part of `generate_city` without the cost field: (grid,
    lights_static, groups_static, blocks_static, dests) from the tensors
    of `city_draws`, on their device.  A function of tensors, which runs
    under vmap."""
    dev = draws["zone_u"].device
    caps = cfg.capacities()
    H, W = cfg.HEIGHT, cfg.WIDTH
    HW = H * W

    def bands(tag):
        return Bands(start=draws[f"{tag}b_start"], end=draws[f"{tag}b_end"],
                     rclass=None, dir=None, valid=draws[f"{tag}b_valid"])

    def tables(tag):
        return {k[3:]: v for k, v in draws.items()
                if k.startswith(f"{tag}t_")}
    hbands, vbands = bands("h"), bands("v")

    ras = rasterize(cfg, tables("h"), tables("v"), dev)
    cell, allowed = ras["cell_type"], ras["allowed_dirs"]
    cell, block_ids, btype, inner_count, bvalid = apply_zoning(
        draws["zone_u"], cfg, cell, caps.max_blocks)
    cell, allowed = eliminate_dead_ends(cell, allowed)
    cell, allowed, _ = upgrade_r2_to_intersections(
        cfg, cell, allowed, ras["horiz_band"], ras["ring_corner"])
    cell, allowed, entrance_flat = place_entrances(
        cfg, cell, allowed, block_ids, btype, caps.max_blocks,
        key=draws["ent_salt"])
    allowed = prune_intersection_dirs(cell, allowed)
    allowed = add_entrance_directions(cell, allowed)

    lg = build_lights_and_groups(cfg, caps, cell, allowed,
                                 hbands=hbands, vbands=vbands)
    cell = lg["cell_type"]

    # destinations: block entrances, highway exits, block service cells
    B, E = caps.max_blocks, caps.max_exits
    exit_flat = nonzero_fixed(cell == C.HIGHWAY_EXIT, E).to(I32)
    ent_valid = entrance_flat >= 0
    service_flat = place_service_cells(cell, block_ids, btype,
                                       entrance_flat, B)
    svc_valid = (service_flat >= 0) & ent_valid
    dest_pos = torch.cat([torch.where(ent_valid, entrance_flat, 0),
                          torch.where(exit_flat >= 0, exit_flat, 0),
                          torch.where(svc_valid, service_flat, 0)])
    dest_valid = torch.cat([ent_valid, exit_flat >= 0, svc_valid])
    dest_kind = torch.cat([torch.zeros(B, dtype=U8, device=dev),
                           torch.ones(E, dtype=U8, device=dev),
                           torch.full((B,), 2, dtype=U8, device=dev)])
    ar_b = torch.arange(B, dtype=I32, device=dev)
    dest_block = torch.cat([ar_b, torch.full((E,), -1, dtype=I32,
                                             device=dev), ar_b])
    dest_block = torch.where(dest_valid, dest_block, -1)

    # valid destinations first (a stable sort keeps entrances and exits
    # ahead of service cells)
    D_ALL = 2 * B + E
    order = torch.argsort((~dest_valid).to(I32), stable=True)
    inv = torch.argsort(order, stable=True).to(I32)
    dest_pos, dest_valid = dest_pos[order], dest_valid[order]
    dest_kind, dest_block = dest_kind[order], dest_block[order]
    ent_dest_id = torch.where(ent_valid, inv[:B], -1)
    svc_dest_id = torch.where(svc_valid, inv[B + E:], -1)
    hw_pos = nonzero_fixed(cell == C.HIGHWAY_ENTRANCE,
                           caps.max_entrances_hw).to(I32)
    dests = DestStatic(valid=dest_valid, pos=dest_pos, kind=dest_kind,
                       block=dest_block, hw_pos=hw_pos, hw_valid=hw_pos >= 0)
    dest_plane = set_last(
        torch.full((HW,), -1, dtype=I32, device=dev),
        torch.where(dest_valid, dest_pos, HW - 1),
        torch.where(dest_valid, torch.arange(D_ALL, dtype=I32, device=dev),
                    -1))

    road_class = _routing_road_class(cell, lg["orig_type"],
                                     ras["ring_corner"])
    is_road = _isin(cell, C.ROAD_LIKE)
    grid = Grid(cell_type=cell, orig_type=lg["orig_type"],
                allowed_dirs=allowed, road_class=road_class,
                is_road=is_road, intersection=cell == C.INTERSECTION,
                group_id=lg["group_plane"], block_id=block_ids,
                light_id=lg["light_id_plane"],
                dest_id=dest_plane.reshape(H, W),
                queue_group=lg["queue_group"],
                queue_bucket=lg["queue_bucket"])
    lights_static = LightStatic(
        valid=lg["light_valid"], pos=lg["light_pos"],
        group=lg["light_group"], axis=lg["light_axis"],
        assign_road=lg["assign_road"], assign_light=lg["assign_light"],
        assign_valid=lg["assign_valid"], srun_lo=lg["srun_lo"],
        srun_hi=lg["srun_hi"], srun_light=lg["srun_light"],
        sextra_cell=lg["sextra_cell"], sextra_light=lg["sextra_light"])

    # compact queue-cell and run lists (padding: seg -1, range [0, 0))
    qgf = lg["queue_group"].reshape(-1)
    qbf = lg["queue_bucket"].reshape(-1).to(I32)
    Q = caps.max_queue_cells
    qidx = nonzero_fixed(qgf >= 0, Q, HW)
    qcell = qidx.clamp(0, HW - 1)
    qvalid = qidx < HW
    ridx = nonzero_fixed(lg["run_end"], Q, HW)
    rcell = ridx.clamp(0, HW - 1)
    rvalid = ridx < HW

    def run_col(plane, fill):
        return torch.where(rvalid, plane.reshape(-1)[rcell], fill)

    groups_static = GroupStatic(
        valid=lg["group_valid"], neighbor=lg["group_neighbor"],
        intermediates=lg["group_intermediates"], bbox=lg["group_bbox"],
        intersection_size=lg["intersection_size"],
        penalty_score=lg["penalty_score"], queue_cells=qcell.to(I32),
        queue_qgroup=torch.where(qvalid, qgf[qcell], -1),
        queue_qbucket=torch.where(qvalid, qbf[qcell], 0),
        run_lo=run_col(lg["run_lo_plane"], 0),
        run_hi=run_col(lg["run_hi_plane"], 0),
        run_seg=run_col(lg["run_seg_plane"], -1))

    needs_food = _isin(btype, [C.NAME_TO_TYPE[n]
                               for n in cfg.CITY_BLOCK_THAT_NEED_FOOD])
    produces_waste = _isin(btype, [C.NAME_TO_TYPE[n] for n in
                                   cfg.CITY_BLOCK_THAT_PRODUCE_WASTE])
    blk_valid = bvalid & _isin(btype, C.ZONE_TYPES)
    inner_f = inner_count.to(torch.float32)
    blocks_static = BlockStatic(
        valid=blk_valid, btype=btype, inner_count=inner_count,
        entrance=entrance_flat, dest=ent_dest_id, service_dest=svc_dest_id,
        food_cap=cfg.FOOD_CAPACITY_PER_CELL * inner_f,
        waste_cap=cfg.WASTE_CAPACITY_PER_CELL * inner_f,
        needs_food=needs_food & blk_valid,
        produces_waste=produces_waste & blk_valid)

    return grid, lights_static, groups_static, blocks_static, dests
