"""Traffic-light placement, intersection light groups and queue labels
(the JAX package's `gen/lights.py`; its docstring maps the stages to the
reference and states the parity notes).

The scatters that the JAX code writes with `.at[idx].set` can hit one
cell from several updates of a step; `ops.labels.set_last` applies them
in XLA's CPU order (the last one wins) on either device.  The only f32
segment sums (lane penalties, multiples of 0.5) are exact in any order.
"""

from __future__ import annotations

import torch

from .. import codes as C
from ..config import Capacities, Config
from ..ops.labels import (BIG, compact_labels, connected_components,
                          nonzero_fixed, seg_max, seg_min, seg_sum,
                          set_last)
from .raster import shift_from
from .zoning import _isin

# queue bucket codes
NS_IN, NS_OUT, EW_IN, EW_OUT = 0, 1, 2, 3
I32 = torch.int32


def _shift_fill(x, dy: int, dx: int, fill):
    """x moved by (dy, dx) rows / columns with `fill` entering."""
    H, W = x.shape
    out = x
    if dy:
        pad = torch.full((abs(dy), W), fill, dtype=x.dtype, device=x.device)
        out = (torch.cat([pad, out[:-dy]], 0) if dy > 0
               else torch.cat([out[-dy:], pad], 0))
    if dx:
        pad = torch.full((H, abs(dx)), fill, dtype=x.dtype, device=x.device)
        out = (torch.cat([pad, out[:, :-dx]], 1) if dx > 0
               else torch.cat([out[:, -dx:], pad], 1))
    return out


def run_decompose(lab: torch.Tensor):
    """Axis-aligned run decomposition of a label plane (the JAX
    `run_decompose`): (run_end bool [H, W], lo, hi) with [lo, hi) the
    run's range in the padded prefix buffers (H-runs in an [H, W+1]
    section, V-runs in an [H+1, W] section after it)."""
    H, W = lab.shape
    labeled = lab >= 0
    same_up = labeled & (lab == _shift_fill(lab, 1, 0, -1))
    same_dn = labeled & (lab == _shift_fill(lab, -1, 0, -1))
    vish = labeled & (same_up | same_dn)
    hish = labeled & ~vish
    same_w = hish & (lab == _shift_fill(lab, 0, 1, -1)) & \
        _shift_fill(hish, 0, 1, False)

    def chain_len(s, dy, dx):
        d = s.to(I32)
        step, n = 1, (H if dy else W)
        while step < n:
            up = _shift_fill(d, step * dy, step * dx, 0)
            d = d + torch.where(d == step, up, 0)
            step *= 2
        return d

    v_len = chain_len(same_up, 1, 0) + 1
    h_len = chain_len(same_w, 0, 1) + 1
    v_end = vish & ~same_dn
    h_end = hish & ~_shift_fill(same_w, 0, -1, False)
    yy = torch.arange(H, dtype=I32, device=lab.device)[:, None]
    xx = torch.arange(W, dtype=I32, device=lab.device)[None, :]
    off_v = H * (W + 1)
    lo = torch.where(v_end, off_v + (yy - v_len + 1) * W + xx,
                     yy * (W + 1) + (xx - h_len + 1))
    hi = torch.where(v_end, off_v + (yy + 1) * W + xx, yy * (W + 1) + xx + 1)
    return v_end | h_end, lo, hi


def _band_bounds(bands, n: int, device):
    """Per coordinate the covering band's (lo, hi), -1 where none."""
    st = torch.as_tensor(bands.start, device=device)[:, None]
    en = torch.as_tensor(bands.end, device=device)[:, None]
    va = torch.as_tensor(bands.valid, device=device)[:, None]
    coords = torch.arange(n, dtype=I32, device=device)
    cover = va & (st <= coords) & (coords <= en)
    lo = torch.where(cover, st, -1).amax(dim=0)
    hi = torch.where(cover, en, -1).amax(dim=0)
    return lo.to(I32), hi.to(I32)


def _blocks_all_lanes_planes(inter, hbands, vbands):
    """`blocks_all_lanes` as two per-cell planes (the JAX
    `_blocks_all_lanes_planes`): blocks_v for a vertical ray stopping at
    the cell, blocks_h for a horizontal one."""
    H, W = inter.shape
    dev = inter.device
    ii = inter.to(I32)
    vlo, vhi = _band_bounds(vbands, W, dev)
    hlo, hhi = _band_bounds(hbands, H, dev)
    ar_w = torch.arange(W, dtype=I32, device=dev)
    ar_h = torch.arange(H, dtype=I32, device=dev)
    vx0 = torch.where(vlo >= 0, vlo, ar_w)[None, :].expand(H, W)
    vx1 = torch.where(vhi >= 0, vhi, ar_w)[None, :].expand(H, W)
    hy0 = torch.where(hlo >= 0, hlo, ar_h)[:, None].expand(H, W)
    hy1 = torch.where(hhi >= 0, hhi, ar_h)[:, None].expand(H, W)
    multi_v = vx1 > vx0
    multi_h = hy1 > hy0
    Pr = torch.nn.functional.pad(torch.cumsum(ii, 1, dtype=I32), (1, 0))
    Pc = torch.nn.functional.pad(torch.cumsum(ii, 0, dtype=I32), (0, 0, 1, 0))
    cov_v = (Pr.gather(1, (vx1 + 1).long()) - Pr.gather(1, vx0.long())) \
        == (vx1 - vx0 + 1)
    cov_h = (Pc.gather(0, (hy1 + 1).long()) - Pc.gather(0, hy0.long())) \
        == (hy1 - hy0 + 1)
    inter_vx0 = inter.gather(1, vx0.long())
    inter_hy0 = inter.gather(0, hy0.long())
    blocks_v = torch.where(multi_v, cov_v, inter_vx0 & (multi_h | inter_hy0))
    blocks_h = torch.where(multi_h, cov_h, inter_hy0 & (multi_v | inter_vx0))
    return blocks_v, blocks_h


def build_lights_and_groups(cfg: Config, caps: Capacities, cell, allowed,
                            hbands=None, vbands=None) -> dict:
    """Controlled roads, lights and their assignments, intersection
    groups, light axes, queue labels (backward and optional forward
    scans), run decompositions, group features and neighbour groups (the
    JAX `build_lights_and_groups`, same keys)."""
    H, W = cell.shape
    HW = H * W
    dev = cell.device
    ys = torch.arange(H, dtype=I32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=I32, device=dev)[None, :].expand(H, W)

    # ---- 1. controlled roads ---------------------------------------------
    convertible = _isin(cell, C.ROAD_LIKE_NO_INTERSECTION)
    inter = cell == C.INTERSECTION
    points_in = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for d in range(4):
        points_in = points_in | (((allowed & C.DIR_BITS[d]) != 0)
                                 & shift_from(inter, d))
    controlled = convertible & points_in
    orig_type = cell
    cell = torch.where(controlled, C.CONTROLLED_ROAD, cell)

    # ---- 2. light placement per (cell, dir) ------------------------------
    assign_valid, assign_target = [], []
    light_mask = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for d in range(4):
        rd = (d + 1) % 4
        ord_ = (rd + 2) % 4
        has_d = controlled & ((allowed & C.DIR_BITS[d]) != 0)
        p1_type = shift_from(cell, rd)
        p1_allowed = shift_from(allowed, rd)
        p1_orig = shift_from(orig_type, rd)
        p1_sw = p1_type == C.SIDEWALK
        p1_lane = ((p1_type == C.CONTROLLED_ROAD) | (p1_orig == orig_type)) \
            & ((p1_allowed & allowed) != 0)
        p2_sw = shift_from(shift_from(cell, rd), rd) == C.SIDEWALK
        t1 = has_d & p1_sw
        t2 = has_d & ~p1_sw & p1_lane & p2_sw
        light_mask = light_mask | shift_from(t1, ord_)
        light_mask = light_mask | shift_from(shift_from(t2, ord_), ord_)
        dy, dx = int(C.DIR_DY[rd]), int(C.DIR_DX[rd])
        tgt = torch.where(t1, (ys + dy) * W + xs + dx,
                          torch.where(t2, (ys + 2 * dy) * W + xs + 2 * dx,
                                      -1))
        assign_valid.append(t1 | t2)
        assign_target.append(tgt)

    av = torch.stack(assign_valid).reshape(-1)
    at = torch.stack(assign_target).reshape(-1)
    aroad = torch.arange(HW, dtype=I32, device=dev).repeat(4)
    A = caps.max_lights * 4
    aidx = nonzero_fixed(av, A)
    a_ok = aidx >= 0
    aidx_c = aidx.clamp(0, 4 * HW - 1)
    a_road = torch.where(a_ok, aroad[aidx_c], -1)
    a_tgt = torch.where(a_ok, at[aidx_c], -1)

    # ---- 3. light table ----------------------------------------------------
    L = caps.max_lights
    lpos = nonzero_fixed(light_mask, L).to(I32)
    l_ok = lpos >= 0
    light_id_plane = set_last(
        torch.full((HW,), -1, dtype=I32, device=dev),
        torch.where(l_ok, lpos, HW - 1),
        torch.where(l_ok, torch.arange(L, dtype=I32, device=dev), -1))
    cell = torch.where(light_mask, C.TRAFFIC_LIGHT, cell)
    a_light = torch.where(a_ok, light_id_plane[a_tgt.clamp(0, HW - 1).long()],
                          -1)

    # ---- 4. intersection groups --------------------------------------------
    group_plane, roots, _ = compact_labels(connected_components(inter),
                                           caps.max_groups)
    G = caps.max_groups
    gp_flat = group_plane.reshape(-1)
    gseg = torch.where(gp_flat >= 0, gp_flat, G)
    fx, fy = xs.reshape(-1), ys.reshape(-1)
    ing = gseg < G
    gminx = seg_min(torch.where(ing, fx, BIG), gseg, G + 1, BIG)[:G]
    gmaxx = seg_max(torch.where(ing, fx, -1), gseg, G + 1, -1)[:G]
    gminy = seg_min(torch.where(ing, fy, BIG), gseg, G + 1, BIG)[:G]
    gmaxy = seg_max(torch.where(ing, fy, -1), gseg, G + 1, -1)[:G]
    gcount = seg_sum(ing.to(I32), gseg, G + 1)[:G]
    g_valid = roots >= 0

    lx = torch.where(l_ok, lpos % W, 0)
    ly = torch.where(l_ok, torch.div(lpos, W, rounding_mode="floor"), 0)
    l_group = torch.full((L,), -1, dtype=I32, device=dev)

    def gp_at(y, x):
        return gp_flat[(y.clamp(0, H - 1) * W + x.clamp(0, W - 1)).long()]

    for sy in (-1, 1):
        for sx in (-1, 1):
            g = gp_at(ly + sy, lx + sx)
            gs = g.clamp(0, G - 1).long()
            is_corner = (((lx == gminx[gs] - 1) | (lx == gmaxx[gs] + 1))
                         & ((ly == gminy[gs] - 1) | (ly == gmaxy[gs] + 1)))
            l_group = torch.where(l_ok & (g >= 0) & is_corner, g, l_group)

    g_has_light = seg_max((l_group >= 0).to(I32),
                          torch.where(l_group >= 0, l_group, G - 1), G,
                          0) > 0
    g_valid = g_valid & g_has_light

    # ---- 5. light axis ------------------------------------------------------
    a_g = torch.where(a_light >= 0,
                      l_group[a_light.clamp(0, L - 1).long()], -1)
    a_road_c = a_road.clamp(0, HW - 1)
    rc_y = torch.div(a_road_c, W, rounding_mode="floor")
    rc_x = a_road_c % W
    road_dirs = allowed.reshape(-1)[a_road_c.long()]
    ns_q = torch.zeros((A,), dtype=torch.bool, device=dev)
    ew_q = torch.zeros_like(ns_q)
    for d in range(4):
        nb_g = gp_at(rc_y + int(C.DIR_DY[d]), rc_x + int(C.DIR_DX[d]))
        qual = a_ok & ((road_dirs & C.DIR_BITS[d]) != 0) & (nb_g >= 0) \
            & (nb_g == a_g)
        if d in (C.N_IDX, C.S_IDX):
            ns_q = ns_q | qual
        else:
            ew_q = ew_q | qual
    al_safe = torch.where(a_light >= 0, a_light, L - 1)
    has_l = a_light >= 0
    l_ns = seg_max((ns_q & has_l).to(I32), al_safe, L, 0) > 0
    l_ew = seg_max((ew_q & has_l).to(I32), al_safe, L, 0) > 0
    l_axis = torch.where(l_ns, 0, torch.where(l_ew, 1, -1)).to(I32)
    l_axis = torch.where(l_ok & (l_group >= 0), l_axis, -1)

    # ---- 6. backward ray scan -> queue labels --------------------------------
    R = cfg.TRAFFIC_LIGHT_RANGE + 1
    queue_group = torch.full((HW,), -1, dtype=I32, device=dev)
    queue_bucket = torch.full((HW,), -1, dtype=torch.int8, device=dev)
    light_of_cell = torch.full((HW,), -1, dtype=I32, device=dev)
    orig_flat = orig_type.reshape(-1)
    allowed_flat = allowed.reshape(-1)
    a_orig = orig_flat[a_road_c.long()]
    lpos_a = lpos[al_safe.long()]
    a_ly = torch.where(has_l, torch.div(lpos_a, W, rounding_mode="floor"),
                       -1)
    a_lx = torch.where(has_l, lpos_a % W, -1)

    def label(st, alive_put, cy, cx, pf):
        """Write (group, bucket, light) at the ray cells that take one."""
        queue_group, queue_bucket, light_of_cell = st
        cdirs = allowed_flat[pf.long()]
        is_ns = (cdirs & (1 | 4)) != 0
        is_ew = (cdirs & (2 | 8)) != 0
        bucket = torch.where(
            is_ns, torch.where(cy < a_ly, NS_IN, NS_OUT),
            torch.where(is_ew, torch.where(cx < a_lx, EW_IN, EW_OUT), -1))
        put = alive_put & (bucket >= 0)
        tgt = torch.where(put, pf, HW - 1)
        tl = tgt.long()
        queue_group = set_last(queue_group, tgt,
                               torch.where(put, a_g, queue_group[tl]))
        queue_bucket = set_last(queue_bucket, tgt, torch.where(
            put, bucket.to(torch.int8), queue_bucket[tl]))
        light_of_cell = set_last(light_of_cell, tgt,
                                 torch.where(put, a_light, light_of_cell[tl]))
        return queue_group, queue_bucket, light_of_cell

    reach_d_planes = []
    for d in range(4):
        srcs = a_ok & ((road_dirs & C.DIR_BITS[d]) != 0)
        r = (seg_max(srcs.to(I32), torch.where(srcs, a_road, HW - 1), HW, 0)
             > 0).reshape(H, W)
        legal = [(allowed & C.DIR_BITS[m]) != 0 for m in range(4)]
        for _ in range(cfg.TRAFFIC_LIGHT_RANGE + 4):
            grow = torch.zeros_like(r)
            for m in range(4):
                grow = grow | (legal[m] & shift_from(r, m))
            r = r | grow
        reach_d_planes.append(r.reshape(-1))

    st = (queue_group, queue_bucket, light_of_cell)
    for d in range(4):
        alive = a_ok & ((road_dirs & C.DIR_BITS[d]) != 0)
        py, px = rc_y, rc_x
        for _ in range(R):
            py = py - int(C.DIR_DY[d])
            px = px - int(C.DIR_DX[d])
            inb = (py >= 0) & (py < H) & (px >= 0) & (px < W)
            cy, cx = py.clamp(0, H - 1), px.clamp(0, W - 1)
            pf = cy * W + cx
            alive = alive & inb & (orig_flat[pf.long()] == a_orig) \
                & reach_d_planes[d][pf.long()]
            st = label(st, alive, cy, cx, pf)

    # ---- 6b. optional forward scan ---------------------------------------
    if cfg.FORWARD_TRAFFIC_LIGHT_RANGE:
        mode = cfg.FORWARD_TRAFFIC_LIGHT_INTERSECTIONS
        cell_flat = cell.reshape(-1)
        for d in range(4):
            alive = a_ok & ((road_dirs & C.DIR_BITS[d]) != 0)
            depth = torch.zeros_like(a_road)
            py, px = rc_y, rc_x
            for _ in range(2 * R):
                py = py + int(C.DIR_DY[d])
                px = px + int(C.DIR_DX[d])
                inb = (py >= 0) & (py < H) & (px >= 0) & (px < W)
                cy, cx = py.clamp(0, H - 1), px.clamp(0, W - 1)
                pf = cy * W + cx
                pfl = pf.long()
                is_int = cell_flat[pfl] == C.INTERSECTION
                same = orig_flat[pfl] == a_orig
                flows_on = (allowed_flat[pfl] & C.DIR_BITS[d]) != 0
                in_range = depth <= cfg.TRAFFIC_LIGHT_RANGE
                label_int = is_int & (mode != "Skip")
                label_road = same & flows_on
                st = label(st, alive & inb & in_range
                           & (label_int | label_road), cy, cx, pf)
                consumed = torch.where(
                    is_int, int(mode == "Include in Range"),
                    torch.where(label_road, 1, 0))
                depth = depth + torch.where(alive & inb, consumed, 0)
                alive = alive & inb & (is_int | same) & in_range
    queue_group, queue_bucket, light_of_cell = st

    # ---- 6c. intersection cells take bucket 4 -----------------------------
    is_int_cell = gp_flat >= 0
    queue_group = torch.where(is_int_cell, gp_flat, queue_group)
    queue_bucket = torch.where(is_int_cell, 4, queue_bucket).to(torch.int8)

    # ---- 6d. run decomposition of the queue labels ------------------------
    lab = torch.where(queue_group >= 0,
                      queue_group * 5 + queue_bucket.to(I32), -1).reshape(H, W)
    run_end, run_lo_plane, run_hi_plane = run_decompose(lab)

    # ---- 6e. stop-cell runs per light -------------------------------------
    put_a = a_ok & has_l
    lab_l = torch.full((HW,), -1, dtype=I32, device=dev)
    lab_l = set_last(lab_l, torch.where(put_a, a_road, HW - 1),
                     torch.where(put_a, a_light, lab_l[a_road_c.long()]))
    lab_l = set_last(lab_l, torch.where(l_ok, lpos, HW - 1),
                     torch.where(l_ok, torch.arange(L, dtype=I32, device=dev),
                                 lab_l[lpos.clamp(0, HW - 1).long()]))
    extra = put_a & (lab_l[a_road_c.long()] != a_light)
    sextra_cell = torch.where(extra, a_road, -1)
    sextra_light = torch.where(extra, a_light, -1)
    s_end, s_lo_plane, s_hi_plane = run_decompose(lab_l.reshape(H, W))
    sidx = nonzero_fixed(s_end, a_road.shape[0])
    s_ok = sidx >= 0
    sidx_c = sidx.clamp(0, HW - 1)
    srun_lo = torch.where(s_ok, s_lo_plane.reshape(-1)[sidx_c], 0)
    srun_hi = torch.where(s_ok, s_hi_plane.reshape(-1)[sidx_c], 0)
    srun_light = torch.where(s_ok, lab_l[sidx_c], -1)

    # ---- 7. group scalar features ------------------------------------------
    pen_tab = torch.tensor([0.0, cfg.VEHICLE_ROAD_TYPES_PENALTY_R1,
                            cfg.VEHICLE_ROAD_TYPES_PENALTY_R2,
                            cfg.VEHICLE_ROAD_TYPES_PENALTY_R3, 0.0],
                           dtype=torch.float32, device=dev)
    type_to_rc = torch.zeros((C.NUM_CELL_TYPES,), dtype=torch.int64,
                             device=dev)
    type_to_rc[C.R1], type_to_rc[C.R2], type_to_rc[C.R3] = 1, 2, 3
    lane_pen = pen_tab[type_to_rc[orig_flat.long()]]
    is_lane = (queue_group >= 0) & (queue_bucket < 4)
    qg = torch.where(is_lane, queue_group, G)
    pen_sum = seg_sum(torch.where(is_lane, lane_pen, 0.0), qg, G + 1)[:G]
    pen_cnt = seg_sum(is_lane.to(torch.float32), qg, G + 1)[:G]
    penalty_score = torch.where(pen_cnt > 0,
                                pen_sum / torch.clamp(pen_cnt, min=1.0), 0.0)
    intersection_size = gcount.to(torch.float32) / 16.0

    # ---- 8. neighbour groups (straight-ray walk from the bbox centre) ------
    ccx = torch.div(gminx + gmaxx, 2, rounding_mode="floor").clamp(0, W - 1)
    ccy = torch.div(gminy + gmaxy, 2, rounding_mode="floor").clamp(0, H - 1)
    M_INTER = 8
    neighbor = torch.full((G, 4), -1, dtype=I32, device=dev)
    intermediates = torch.full((G, M_INTER), -1, dtype=I32, device=dev)
    gids = torch.arange(G, dtype=I32, device=dev)
    gidl = gids.long()
    if hbands is not None and vbands is not None:
        blocks_v, blocks_h = _blocks_all_lanes_planes(inter, hbands, vbands)
        blocks_v, blocks_h = blocks_v.reshape(-1), blocks_h.reshape(-1)
    else:
        blocks_v = blocks_h = None
    ext_x = gmaxx - gminx + 1
    ext_y = gmaxy - gminy + 1
    for d in range(4):
        vert = d in (C.N_IDX, C.S_IDX)
        my_ext = ext_x if vert else ext_y
        nb_ext = ext_x if vert else ext_y
        bplane = blocks_v if vert else blocks_h
        found = torch.full((G,), -1, dtype=I32, device=dev)
        inters = torch.full((G, M_INTER), -1, dtype=I32, device=dev)
        icnt = torch.zeros((G,), dtype=I32, device=dev)
        last = torch.full((G,), -1, dtype=I32, device=dev)
        for s in range(max(H, W)):
            py = ccy + (s + 1) * int(C.DIR_DY[d])
            px = ccx + (s + 1) * int(C.DIR_DX[d])
            inb = (py >= 0) & (py < H) & (px >= 0) & (px < W)
            pidx = (py.clamp(0, H - 1) * W + px.clamp(0, W - 1)).long()
            g = gp_flat[pidx]
            fresh = inb & (g >= 0) & (g != gids) & (g != last) & (found < 0)
            if bplane is not None:
                blocks = bplane[pidx]
            else:
                blocks = nb_ext[g.clamp(0, G - 1).long()] >= my_ext
            found = torch.where(fresh & blocks, g, found)
            put = fresh & ~blocks & (icnt < M_INTER)
            slot = icnt.clamp(0, M_INTER - 1).long()
            inters[gidl, slot] = torch.where(put, g, inters[gidl, slot])
            icnt = icnt + put.to(I32)
            last = torch.where(inb & (g >= 0), g, last)
        neighbor[:, d] = torch.where(g_valid, found, -1)
        for k in range(M_INTER):
            cand = inters[:, k]
            has = g_valid & (cand >= 0)
            free = torch.argmax((intermediates < 0).to(I32), dim=1)
            cur = intermediates[gidl, free]
            intermediates[gidl, free] = torch.where(has & (cur < 0), cand,
                                                    cur)

    return dict(
        cell_type=cell,
        orig_type=orig_type,
        light_pos=torch.where(l_ok, lpos, -1),
        light_valid=l_ok,
        light_group=torch.where(l_ok, l_group, -1),
        light_axis=l_axis,
        light_id_plane=light_id_plane.reshape(H, W),
        assign_road=a_road,
        assign_light=a_light,
        assign_valid=a_ok & has_l,
        srun_lo=srun_lo,
        srun_hi=srun_hi,
        srun_light=srun_light,
        sextra_cell=sextra_cell,
        sextra_light=sextra_light,
        group_plane=group_plane,
        group_valid=g_valid,
        group_neighbor=neighbor,
        group_intermediates=intermediates,
        group_bbox=torch.stack([gminx, gmaxx, gminy, gmaxy], dim=1),
        intersection_size=intersection_size,
        penalty_score=penalty_score,
        queue_group=queue_group.reshape(H, W),
        queue_bucket=queue_bucket.reshape(H, W),
        light_of_cell=light_of_cell.reshape(H, W),
        run_end=run_end,
        run_lo_plane=run_lo_plane,
        run_hi_plane=run_hi_plane,
        run_seg_plane=torch.where(run_end, lab, -1),
    )
