"""Sub-block L-shaped road carving (the JAX package's `gen/subblocks.py`,
reference `_carve_subblock_roads`, default-off): in each large enough
`Nothing` blob, with probability SUBBLOCK_CHANGE, an L-road through a
random pivot with one inbound and one outbound leg, each walked until it
meets the road network.  The legs of all blobs walk and paint together,
one step at a time."""

from __future__ import annotations

import torch

from .. import codes as C
from .. import prng
from ..config import Config
from ..ops.labels import (BIG, compact_labels, connected_components,
                          seg_max, seg_min, set_last)
from .raster import shift_from
from .zoning import _isin

I32 = torch.int32


def carve_subblock_roads(cfg: Config, key, cell, allowed, max_blocks: int):
    if not cfg.CARVE_SUBBLOCK_ROADS:
        return cell, allowed
    H, W = cell.shape
    HW = H * W
    dev = cell.device
    sp = cfg.MIN_SUBBLOCK_SPACING
    sub_code = C.NAME_TO_TYPE[cfg.SUBBLOCK_ROAD_TYPE]
    B = max_blocks

    nothing = cell == C.NOTHING
    ids_map, roots, _ = compact_labels(connected_components(nothing), B)
    flat_ids = ids_map.reshape(-1)
    seg = torch.where(flat_ids >= 0, flat_ids, B)
    flat = torch.arange(HW, dtype=I32, device=dev)
    xs, ys = flat % W, torch.div(flat, W, rounding_mode="floor")
    inb = flat_ids >= 0
    minx = seg_min(torch.where(inb, xs, BIG), seg, B + 1, BIG)[:B]
    maxx = seg_max(torch.where(inb, xs, -1), seg, B + 1, -1)[:B]
    miny = seg_min(torch.where(inb, ys, BIG), seg, B + 1, BIG)[:B]
    maxy = seg_max(torch.where(inb, ys, -1), seg, B + 1, -1)[:B]
    big_enough = (roots >= 0) & (maxx - minx + 1 >= sp * 2 + 1) & \
        (maxy - miny + 1 >= sp * 2 + 1)
    k_ch, k_px, k_py, k_hd, k_vd, k_leg = prng.split(key, 6)

    def draw(x):
        return torch.from_numpy(x).to(dev)

    carve = big_enough & (draw(prng.uniform(k_ch, (B,)))
                          < torch.tensor(cfg.SUBBLOCK_CHANGE,
                                         dtype=torch.float32))

    def rint(k, lo, hi):
        span = torch.clamp(hi - lo + 1, min=1).to(torch.float32)
        return lo + torch.floor(draw(prng.uniform(k, (B,))) * span).to(I32)

    px = rint(k_px, minx + sp, maxx - sp).clamp(0, W - 1)
    py = rint(k_py, miny + sp, maxy - sp).clamp(0, H - 1)
    hd = torch.where(draw(prng.bernoulli(k_hd, 0.5, (B,))), C.E_IDX,
                     C.W_IDX).to(I32)
    vd = torch.where(draw(prng.bernoulli(k_vd, 0.5, (B,))), C.N_IDX,
                     C.S_IDX).to(I32)
    inbound_vert = draw(prng.bernoulli(k_leg, 0.5, (B,)))

    dxs = torch.as_tensor(C.DIR_DX, device=dev)
    dys = torch.as_tensor(C.DIR_DY, device=dev)
    bits = torch.tensor(C.DIR_BITS, dtype=torch.uint8, device=dev)
    opp = torch.tensor([2, 3, 0, 1], dtype=torch.int64, device=dev)
    vdl, hdl = vd.long(), hd.long()
    v_arrow = bits[torch.where(inbound_vert, opp[vdl], vdl)]
    h_arrow = bits[torch.where(inbound_vert, hdl, opp[hdl])]

    road_like = _isin(cell, C.ROAD_LIKE).reshape(-1)
    passable = (nothing | (cell == C.SIDEWALK)).reshape(-1)

    def at(plane, y, x):
        return plane[(y.clamp(0, H - 1) * W + x.clamp(0, W - 1)).long()]

    def walk_leg(dy, dx):
        """Steps from the pivot to the first road-like cell through
        Nothing / Sidewalk per blob, -1 where the leg fails."""
        ln = torch.full((B,), -1, dtype=I32, device=dev)
        alive = carve
        for s in range(max(H, W)):
            ny, nx = py + (s + 1) * dy, px + (s + 1) * dx
            ok = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W)
            hit = alive & ok & at(road_like, ny, nx)
            ln = torch.where(hit, s, ln)
            alive = alive & ok & at(passable, ny, nx) & ~hit
        return ln

    len_v = walk_leg(dys[vdl], dxs[vdl])
    len_h = walk_leg(dys[hdl], dxs[hdl])
    ok_leg = carve & (len_v >= 0) & (len_h >= 0) & at(passable, py, px)

    cellf, dirsf = cell.reshape(-1), allowed.reshape(-1)
    make_int = bool(cfg.SUBBLOCK_ROADS_HAVE_INTERSECTIONS)

    def paint_leg(cf, df, dy, dx, length, arrow):
        for s in range(max(H, W)):
            ny, nx = py + (s + 1) * dy, px + (s + 1) * dx
            on = ok_leg & (s <= length) & (ny >= 0) & (ny < H) & \
                (nx >= 0) & (nx < W)
            t = torch.where(on, ny.clamp(0, H - 1) * W + nx.clamp(0, W - 1),
                            HW)
            tc = t.clamp(0, HW - 1).long()
            junction = s == length
            cval = torch.where(junction & make_int, C.INTERSECTION,
                               torch.where(junction, cf[tc], sub_code))
            dval = torch.where(junction & make_int, 15,
                               torch.where(junction, df[tc] | arrow, arrow))
            cf = set_last(cf, t, cval)
            df = set_last(df, t, dval)
        return cf, df

    cellf, dirsf = paint_leg(cellf, dirsf, dys[vdl], dxs[vdl], len_v,
                             v_arrow)
    cellf, dirsf = paint_leg(cellf, dirsf, dys[hdl], dxs[hdl], len_h,
                             h_arrow)
    out_arrow = torch.where(inbound_vert, bits[hdl], bits[vdl])
    tp = torch.where(ok_leg, py * W + px, HW)
    cellf = set_last(cellf, tp, torch.full_like(tp, sub_code))
    dirsf = set_last(dirsf, tp, out_arrow)
    cell, allowed = cellf.reshape(H, W), dirsf.reshape(H, W)

    is_sub = cell == sub_code
    near = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for d in range(4):
        near = near | shift_from(is_sub, d)
    cell = torch.where(near & (cell == C.NOTHING), C.SIDEWALK, cell)
    return cell, allowed
