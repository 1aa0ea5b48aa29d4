"""Hierarchical routing build (the JAX package's `gen/hier.py`): the
routing-id assignment and its tables on the host in numpy (the port's
own copies of `assign_hier_np` and `hier_tables_np`), and the two field
builds on the device: the dense hub / direct key rows and the windowed
static stack.

The windowed stack runs the dense path's value iteration, key encoding
and next-move encode over each tile's 3x3 window with zero dynamic
penalties.  JAX scans the tiles one by one; here `TILES_PER_BATCH`
windows iterate together (each window converges to its own fixpoint, see
`routing.compute_cost_fields`), and the encode is the sdir build
(`engine.build_sdir`: K2 on the card, its plain version on the CPU)
followed by an unpack of the packed words to bytes."""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..ops import engine, routing
from ..ops.hier import RID_SPACE, hier_params

TILES_PER_BATCH = 32
# dense key rows value-iterated together: at 1024^2 the two ping-pong
# f32 buffers [32, 4, H, W] take 1 GiB (the JAX package chunks at 16)
DENSE_ROWS_PER_CHUNK = 32


def assign_hier_np(cfg: Config, pos, valid, kind) -> dict:
    """Routing ids on the host (the JAX `assign_hier_np`): rid [D],
    hub_dest [NR], direct_dest [ND] and tile_dest [NT, LMAX], numpy."""
    hp = hier_params(cfg)
    TS, LMAX = hp.ts, hp.lmax
    W = cfg.WIDTH
    pos, valid, kind = np.asarray(pos), np.asarray(valid), np.asarray(kind)
    D = pos.shape[0]
    y, x = pos // W, pos % W
    ty, tx = y // TS, x // TS
    tid = ty * hp.ntx + tx

    rid = np.full(D, -1, np.int32)
    assign_tile = np.full(D, -1, np.int64)
    counts = np.zeros(hp.nt, np.int64)
    tiled_sel = np.nonzero(valid & (kind != 1))[0]
    # pass 1: own tile while slots remain
    for i in tiled_sel:
        t = tid[i]
        if counts[t] < LMAX:
            assign_tile[i] = t
            counts[t] += 1
    # pass 2: spill to the adjacent tile with the most free slots
    overflow = []
    for i in tiled_sel:
        if assign_tile[i] >= 0:
            continue
        best, bestfree = -1, 0
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ny, nx = ty[i] + dy, tx[i] + dx
                if 0 <= ny < hp.nty and 0 <= nx < hp.ntx:
                    t = ny * hp.ntx + nx
                    free = LMAX - counts[t]
                    if free > bestfree:
                        best, bestfree = t, free
        if best >= 0:
            assign_tile[i] = best
            counts[best] += 1
        else:
            overflow.append(i)      # all 9 tiles full: a direct dense row

    tile_dest = np.full((hp.nt, LMAX), -1, np.int64)
    fill = np.zeros(hp.nt, np.int64)
    for i in tiled_sel:
        t = assign_tile[i]
        if t < 0:
            continue
        tile_dest[t, fill[t]] = i
        rid[i] = t * LMAX + fill[t]
        fill[t] += 1

    direct = list(np.nonzero(valid & (kind == 1))[0]) + overflow
    # 16383 (DEST_NONE) is reserved as the no-destination sentinel
    assert hp.direct_base + len(direct) < RID_SPACE - 1, \
        f"direct rows {len(direct)} overflow the rid space"
    for j, i in enumerate(direct):
        rid[i] = hp.direct_base + j

    # hubs: per 2x2-tile region, the block-entrance destination of the
    # region nearest its centre (else any member); empty regions keep -1
    hub_dest = np.full(hp.nr, -1, np.int64)
    reg_of_tile = (np.arange(hp.nt) // hp.ntx // 2) * hp.nrx \
        + (np.arange(hp.nt) % hp.ntx) // 2
    for r in range(hp.nr):
        members = tile_dest[np.nonzero(reg_of_tile == r)[0]].reshape(-1)
        members = members[members >= 0]
        if members.size == 0:
            continue
        cy = (2 * (r // hp.nrx) + 1) * TS
        cx = (2 * (r % hp.nrx) + 1) * TS
        ents = members[kind[members] == 0]
        cand = ents if ents.size else members
        hub_dest[r] = cand[np.argmin((y[cand] - cy) ** 2
                                     + (x[cand] - cx) ** 2)]

    return {"rid": rid, "hub_dest": hub_dest,
            "direct_dest": np.asarray(direct, np.int64),
            "tile_dest": tile_dest}


def hier_tables_np(cfg: Config, assign: dict, pos, H, W) -> dict:
    """Window-relative destination positions and the dense rows' cells
    (the JAX `hier_tables_np`), numpy: tile_dest_wpos / tile_dest_valid
    [NT, LMAX], tile_coords [NT, 2], dense_pos / dense_valid [NR +
    padded direct count]."""
    hp = hier_params(cfg)
    TS, WS = hp.ts, 3 * hp.ts
    pos = np.asarray(pos)
    y, x = pos // W, pos % W
    td = assign["tile_dest"]
    tv = td >= 0
    tds = np.where(tv, td, 0)
    tyx = np.stack([np.arange(hp.nt) // hp.ntx,
                    np.arange(hp.nt) % hp.ntx], axis=1)
    # a tile's window origin in the planes padded by TS is (ty, tx) * TS
    wy = y[tds] + TS - tyx[:, 0:1] * TS
    wx = x[tds] + TS - tyx[:, 1:2] * TS
    assert ((wy >= 0) & (wy < WS) & (wx >= 0) & (wx < WS))[tv].all()

    hub, direct = assign["hub_dest"], assign["direct_dest"]
    nd_pad = max(8, -(-max(1, len(direct)) // 8) * 8)
    dense_pos = np.zeros(hp.nr + nd_pad, np.int64)
    dense_valid = np.zeros(hp.nr + nd_pad, bool)
    dense_pos[:hp.nr] = np.where(hub >= 0, pos[np.where(hub >= 0, hub, 0)],
                                 0)
    dense_valid[:hp.nr] = hub >= 0
    dense_pos[hp.nr:hp.nr + len(direct)] = pos[direct]
    dense_valid[hp.nr:hp.nr + len(direct)] = True
    i32 = np.int32
    return {"tile_dest_wpos": (wy * WS + wx).astype(i32),
            "tile_dest_valid": tv,
            "tile_coords": tyx.astype(i32),
            "dense_pos": dense_pos.astype(i32),
            "dense_valid": dense_valid}


def build_dense_keys(cfg: Config, grid, dense_pos: torch.Tensor,
                     dense_valid: torch.Tensor) -> torch.Tensor:
    """The dense hub / direct rows as the dense path's key stack
    [D, 4, H, W] int32 (`compute_cost_fields` + `field_to_keys`), built
    DENSE_ROWS_PER_CHUNK rows at a time to bound the value iteration's
    buffers.  Each row is its own fixpoint, so the chunking does not
    change the keys."""
    D = dense_pos.shape[0]
    H, W = grid.allowed_dirs.shape
    out = torch.empty((D, 4, H, W), dtype=torch.int32,
                      device=grid.allowed_dirs.device)
    for r0 in range(0, D, DENSE_ROWS_PER_CHUNK):
        r1 = min(D, r0 + DENSE_ROWS_PER_CHUNK)
        F = routing.compute_cost_fields(cfg, grid.allowed_dirs,
                                        grid.road_class, dense_pos[r0:r1],
                                        dense_valid[r0:r1],
                                        is_road=grid.is_road)
        out[r0:r1] = engine.field_to_keys(cfg, F, grid.road_class)
        del F
    return out


def unpack_sdir4(words: torch.Tensor, D: int) -> torch.Tensor:
    """The packed stack [ceil(D/4), H, W] int32 back to its D byte rows,
    uint8 [D, H, W] (the inverse of `engine.pack_sdir4`)."""
    D4, H, W = words.shape
    rows = torch.stack([(words >> (8 * k)) & 0xFF for k in range(4)], dim=1)
    return rows.reshape(D4 * 4, H, W)[:D].to(torch.uint8)


def build_local_stack(cfg: Config, grid, tile_dest_wpos: torch.Tensor,
                      tile_dest_valid: torch.Tensor,
                      tile_coords: torch.Tensor) -> torch.Tensor:
    """The windowed static next-move planes, packed 4 per word: int32
    [ceil(9 * LMAX / 4), H, W]; plane ((dy+1)*3 + (dx+1)) * LMAX + l at a
    cell holds the byte toward destination (tile(cell) + (dy, dx), l)
    (the JAX `build_local_stack`)."""
    hp = hier_params(cfg)
    TS, LMAX = hp.ts, hp.lmax
    H, W = cfg.HEIGHT, cfg.WIDTH
    WS = 3 * TS
    dev = grid.allowed_dirs.device
    pad = torch.nn.functional.pad
    allowed_p = pad(grid.allowed_dirs, (TS, TS, TS, TS))
    road_p = pad(grid.is_road, (TS, TS, TS, TS))
    rclass_p = pad(grid.road_class, (TS, TS, TS, TS))
    zsoft = torch.zeros((WS, WS), dtype=torch.int32, device=dev)
    zhard = torch.zeros((WS, WS), dtype=torch.bool, device=dev)
    stack = torch.full((9 * LMAX, H + 2 * TS, W + 2 * TS), 7,
                       dtype=torch.uint8, device=dev)
    coords = tile_coords.cpu().numpy()
    NT = coords.shape[0]

    def window(plane, t):
        oy, ox = int(coords[t, 0]) * TS, int(coords[t, 1]) * TS
        return plane[oy:oy + WS, ox:ox + WS]

    for t0 in range(0, NT, TILES_PER_BATCH):
        ts = range(t0, min(NT, t0 + TILES_PER_BATCH))
        al = torch.stack([window(allowed_p, t) for t in ts])
        rd = torch.stack([window(road_p, t) for t in ts])
        rc = torch.stack([window(rclass_p, t) for t in ts])
        F = routing.compute_cost_fields(
            cfg, al, rc, tile_dest_wpos[t0:t0 + len(ts)],
            tile_dest_valid[t0:t0 + len(ts)], is_road=rd)
        K0 = engine.field_to_keys(cfg, F, rc)
        del F
        for j, t in enumerate(ts):
            sd = unpack_sdir4(engine.build_sdir(cfg, K0[j], al[j], rd[j],
                                                zsoft, zhard), LMAX)
            oy, ox = int(coords[t, 0]) * TS, int(coords[t, 1]) * TS
            for wy in range(3):
                for wx in range(3):
                    base = ((2 - wy) * 3 + (2 - wx)) * LMAX
                    y0, x0 = oy + wy * TS, ox + wx * TS
                    stack[base:base + LMAX, y0:y0 + TS, x0:x0 + TS] = \
                        sd[:, wy * TS:(wy + 1) * TS, wx * TS:(wx + 1) * TS]
        del K0
    return engine.pack_sdir4(stack[:, TS:TS + H, TS:TS + W])
