# Frozen copy of trafficsimulation_tpu_torch/gen/raster.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
"""Rasterise the road bands into the lattice planes (the JAX package's
`gen/raster.py`; its docstring maps each stage to the reference): wall,
sidewalk ring and interior, band overlap classification with optimised
intersections, right-hand lane directions, the ring-corner overrides,
sidewalk edging and the boundary highway entrances and exits."""

from __future__ import annotations

import torch

from .. import codes as C
from ..config import Config
from ..ops.routing import _shift_plane
from .bands import Bands, per_coord_tables

U8 = torch.uint8


def shift_from(mask: torch.Tensor, d: int) -> torch.Tensor:
    """Value of `mask` at the neighbour in direction d (N = +y, E = +x);
    0 / False outside the grid."""
    return _shift_plane(mask, d, False if mask.dtype == torch.bool else 0)


def _table(t: dict, key: str, device) -> torch.Tensor:
    return torch.as_tensor(t[key], device=device)


def rasterize(cfg: Config, hbands: Bands, vbands: Bands, device) -> dict:
    """cell_type u8 [H, W], allowed_dirs u8, road_class u8, intersection,
    interior, ring_corner and horiz_band bool planes, and the band tables
    (ht, vt).  `hbands` and `vbands` may also be their per-coordinate
    tables (`per_coord_tables`) as tensors: a function of tensors then,
    which runs under vmap."""
    H, W = cfg.HEIGHT, cfg.WIDTH
    # indexed by y and by x
    ht = hbands if isinstance(hbands, dict) else per_coord_tables(hbands, H)
    vt = vbands if isinstance(vbands, dict) else per_coord_tables(vbands, W)
    ys = torch.arange(H, dtype=torch.int32, device=device)[:, None]
    xs = torch.arange(W, dtype=torch.int32, device=device)[None, :]

    def hcol(k):
        return _table(ht, k, device)[:, None].expand(H, W)

    def vrow(k):
        return _table(vt, k, device)[None, :].expand(H, W)

    # ---- stage 1: wall, sidewalk ring, interior -------------------------
    cell = torch.full((H, W), C.WALL, dtype=U8, device=device)
    ws, sr = cfg.WALL_THICKNESS, cfg.SIDEWALK_RING_WIDTH
    in_ring_band_y = ((ys >= ws) & (ys < ws + sr)) | \
                     ((ys > H - ws - 1 - sr) & (ys <= H - ws - 1))
    in_ring_band_x = ((xs >= ws) & (xs < ws + sr)) | \
                     ((xs > W - ws - 1 - sr) & (xs <= W - ws - 1))
    in_frame_x = (xs >= ws) & (xs <= W - ws - 1)
    in_frame_y = (ys >= ws) & (ys <= H - ws - 1)
    ring = (in_ring_band_y & in_frame_x) | (in_ring_band_x & in_frame_y)
    cell = torch.where(ring, C.SIDEWALK, cell)
    ixmin, ixmax = cfg.interior_x_min, cfg.interior_x_max
    iymin, iymax = cfg.interior_y_min, cfg.interior_y_max
    interior = (xs >= ixmin) & (xs <= ixmax) & (ys >= iymin) & (ys <= iymax)
    cell = torch.where(interior, C.NOTHING, cell)

    # ---- stage 2: band overlap classification ---------------------------
    hc, vc = hcol("cover"), vrow("cover")
    h_rc, v_rc = hcol("rclass"), vrow("rclass")
    h_off, v_off = hcol("offset"), vrow("offset")
    h_sz, v_sz = hcol("bsize"), vrow("bsize")
    h_dir, v_dir = hcol("dir"), vrow("dir")

    both = hc & vc
    both_r1 = (h_rc == C.RC_R1) & (v_rc == C.RC_R1)
    process_both = both & (both_r1 | interior)

    ft = cfg.road_thickness(cfg.RING_ROAD_TYPE)
    bottom = (ys >= iymin) & (ys < iymin + ft)
    top = (ys > iymax - ft) & (ys <= iymax)
    left = (xs >= ixmin) & (xs < ixmin + ft)
    right = (xs > ixmax - ft) & (xs <= ixmax)
    corner_region = (bottom | top) & (left | right)
    corner = process_both & corner_region
    inter_cand = process_both & ~corner

    single_multi = ((h_sz == 1) & (v_sz > 1)) | ((v_sz == 1) & (h_sz > 1))
    multi_is_h = h_sz > 1
    multi_off = torch.where(multi_is_h, h_off, v_off)
    multi_sz = torch.where(multi_is_h, h_sz, v_sz)
    inner = (multi_off != 0) & (multi_off != multi_sz - 1)
    revert = (inter_cand & single_multi & inner
              if cfg.OPTIMISED_INTERSECTIONS else torch.zeros_like(inter_cand))
    intersection = inter_cand & ~revert

    # ---- road-cell planes ------------------------------------------------
    h_only = hc & ~vc
    v_only = vc & ~hc
    road_h = h_only & ((h_rc == C.RC_R1) | interior)
    road_v = v_only & ((v_rc == C.RC_R1) | interior)
    use_h = road_h | corner | (revert & multi_is_h)
    use_v = road_v | (revert & ~multi_is_h)
    is_road_cell = use_h | use_v
    r_rc = torch.where(use_h, h_rc, v_rc)
    r_off = torch.where(use_h, h_off, v_off)
    r_sz = torch.where(use_h, h_sz, v_sz)
    r_dir = torch.where(use_h, h_dir, v_dir)
    horiz = use_h

    # ---- lane directions -------------------------------------------------
    inter_at = [shift_from(intersection, d) for d in range(4)]
    bitN, bitE, bitS, bitW = 1, 2, 4, 8
    zero = torch.zeros((H, W), dtype=U8, device=device)

    def bit_if(cond, b):
        return torch.where(cond, b, zero)

    dirs_r3 = (1 << torch.clamp(r_dir, min=0)).to(U8)
    dirs_r2 = torch.where(horiz, torch.where(r_off == 0, bitE, bitW),
                          torch.where(r_off == 0, bitS, bitN)).to(U8)
    half = torch.div(r_sz, 2, rounding_mode="floor")
    eb = r_off < half
    dirs_r1_h = torch.where(
        eb,
        bitE | bit_if((r_off > 0) & ~inter_at[C.S_IDX], bitS)
        | bit_if((r_off < half - 1) & ~inter_at[C.N_IDX], bitN),
        bitW | bit_if((r_off < r_sz - 1) & ~inter_at[C.N_IDX], bitN)
        | bit_if((r_off > half) & ~inter_at[C.S_IDX], bitS))
    dirs_r1_v = torch.where(
        eb,
        bitS | bit_if((r_off > 0) & ~inter_at[C.W_IDX], bitW)
        | bit_if((r_off < half - 1) & ~inter_at[C.E_IDX], bitE),
        bitN | bit_if((r_off < r_sz - 1) & ~inter_at[C.E_IDX], bitE)
        | bit_if((r_off > half) & ~inter_at[C.W_IDX], bitW))
    dirs_r1 = torch.where(horiz, dirs_r1_h, dirs_r1_v)
    dirs = torch.where(r_rc == C.RC_R3, dirs_r3,
                       torch.where(r_rc == C.RC_R2, dirs_r2, dirs_r1))

    # ---- ring corner overrides -------------------------------------------
    if cfg.RING_ROAD_TYPE == "R2":
        in_bottom, in_top = hcol("is_first"), hcol("is_last")
        in_left, in_right = vrow("is_first"), vrow("is_last")
        lrow_b = ys - ht["first_start"]
        lrow_t = ys - ht["last_start"]
        lcol_l = xs - vt["first_start"]
        lcol_r = xs - vt["last_start"]

        def corner_dirs(mapping, lrow, lcol):
            m = zero
            for (rr, cc), dname in mapping.items():
                b = C.DIR_BITS[C.DIR_NAMES.index(dname)]
                m = torch.where((lrow == rr) & (lcol == cc), b, m)
            return m

        sel_bl = in_bottom & in_left
        sel_br = in_bottom & in_right
        sel_tr = in_top & in_right
        sel_tl = in_top & in_left
        ov = zero
        ov = torch.where(sel_bl, corner_dirs(
            {(0, 0): "E", (0, 1): "E", (1, 0): "S", (1, 1): "N"},
            lrow_b, lcol_l), ov)
        ov = torch.where(sel_br, corner_dirs(
            {(0, 0): "E", (0, 1): "N", (1, 0): "W", (1, 1): "N"},
            lrow_b, lcol_r), ov)
        ov = torch.where(sel_tr, corner_dirs(
            {(0, 0): "S", (0, 1): "N", (1, 0): "W", (1, 1): "W"},
            lrow_t, lcol_r), ov)
        ov = torch.where(sel_tl, corner_dirs(
            {(0, 0): "S", (0, 1): "E", (1, 0): "S", (1, 1): "W"},
            lrow_t, lcol_l), ov)
        in_any_corner = sel_bl | sel_br | sel_tr | sel_tl
        dirs = torch.where(in_any_corner & (ov != 0), ov, dirs)

    # ---- roads and intersections into the type plane --------------------
    road_only = is_road_cell & ~intersection
    type_of_rc = torch.tensor([C.NOTHING, C.R1, C.R2, C.R3], dtype=U8,
                              device=device)
    cell = torch.where(road_only, type_of_rc[r_rc.clamp(0, 3).long()], cell)
    cell = torch.where(intersection, C.INTERSECTION, cell)
    allowed = torch.where(road_only, dirs, zero)
    allowed = torch.where(intersection, 15, allowed)

    # ---- sidewalk edging -------------------------------------------------
    roadpos = road_only | intersection
    r1ish = road_only & (r_rc == C.RC_R1)
    near_road = torch.zeros((H, W), dtype=torch.bool, device=device)
    near_r1 = torch.zeros_like(near_road)
    for d in range(4):
        near_road = near_road | shift_from(roadpos, d)
        near_r1 = near_r1 | shift_from(r1ish, d)
    carve = (near_road & (cell == C.NOTHING)) | (near_r1 & (cell == C.WALL))
    cell = torch.where(carve, C.SIDEWALK, cell)

    # ---- boundary highway entrances / exits -----------------------------
    boundary = (xs == 0) | (xs == W - 1) | (ys == 0) | (ys == H - 1)
    inward = ((xs == 0) & ((allowed & bitE) != 0)) | \
             ((xs == W - 1) & ((allowed & bitW) != 0)) | \
             ((ys == 0) & ((allowed & bitN) != 0)) | \
             ((ys == H - 1) & ((allowed & bitS) != 0))
    hw = boundary & (cell == C.R1)
    cell = torch.where(hw & inward, C.HIGHWAY_ENTRANCE, cell)
    cell = torch.where(hw & ~inward, C.HIGHWAY_EXIT, cell)

    road_class = torch.where(road_only | hw, r_rc.to(U8), zero)
    road_class = torch.where(intersection, C.RC_R4, road_class)
    return dict(cell_type=cell, allowed_dirs=allowed, road_class=road_class,
                intersection=intersection, interior=interior,
                ring_corner=corner, horiz_band=horiz, ht=ht, vt=vt)
