"""The tick's hand-written Hopper kernels, each beside its plain PyTorch
version (the counterpart of the JAX package's `ops/pallas_engine.py`).

  K1 `decide_move`         <- pallas_engine.decide_move_pallas (+ _kernel,
                              decide_move_core): every tick
  K2 `build_sdir`          <- pallas_engine.build_sdir_pallas (_sdir_body):
                              once per routing segment of one world
  K3 `build_wavefront`     <- pallas_engine.build_wavefront_pallas
                              (wavefront_core): once per routing segment
  K4 `prefix_planes`       <- pallas_engine.prefix_planes_pallas
                              (_prefix_kernel): every tick
  K5 `build_sdir_batched`  <- pallas_engine.build_sdir_pallas_batched
                              (_sdir_kernel_batched): once per routing
                              segment of a shared-geometry batch
  K6 `select_rows`         <- pallas_engine.select_rows_pallas: every
                              select of the tick under hierarchical
                              routing (`ops/hier.hier_select`)
  K7 `decide_move_tiled`   <- pallas_engine.decide_move_tiled: K1's
                              function over halo-tiled windows; on no
                              path (`step_engine` never picks it, as
                              JAX's `pick_tile` never returns a tile)
  K9 `mega_segment`        <- megakernel.run_segment_mega (_mega_kernel):
                              one launch per routing segment under the
                              megakernel gate (`ops/megakernel.py`)
  `ordered_add`            the service FSM's f32 scatter-add into the
                           block tanks, in update order (no TPU kernel:
                           the JAX package leaves it to XLA's scatter)
  `rain_ticks`             the rain clouds' tick loop (no TPU kernel: the
                           JAX package steps rain in XLA ops per tick)

Dispatch: a wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel (built from `csrc/` by `ops/build.py`)
or raises.  There is no fallback from one to the other.  `launches`
counts, per kernel, the wrapper calls that launched it.

Batches.  K1, K3, K4, `ordered_add` and `rain_ticks` take a leading
batch of worlds
(`*_batched`; one launch per batch, the geometry shared); the
single-world wrappers are the B = 1 call.  The single-world wrappers
are `torch.autograd.Function`s with a `vmap` rule, the counterpart of
the batching rules that `jax.vmap` finds for the Pallas kernels: under
`torch.func.vmap` (the shared-geometry batch, `parallel/mesh.py`) each
launches its batched kernel once for the whole batch.  A vmapped
`build_sdir` whose key stack and legality planes are shared goes to
K5, which reads the key stack once for the batch; any other batching
of an input the kernel shares maps the single-world wrapper over the
worlds, as JAX's `custom_vmap` rule for the sdir build does.

Packed u32 planes are carried as int32 with the same bits: every right
shift below is masked to the field it extracts, so the sign fill of the
arithmetic shift never reaches a result.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import codes as C
from ..config import Config

from .routing import _shift_plane

# ---------------------------------------------------------------------------
# Plane bit layouts (the JAX package's ops/engine.py; csrc/common.cuh)
# ---------------------------------------------------------------------------
PA_KIND_SH = 1
PA_HEAD_SH = 3
PA_BASE_SH = 6
PA_CUR_SH = 10
PA_PARKED_SH = 14
PA_COL_SH = 15
PA_MAL_SH = 16
PA_STUCKF_SH = 17
PA_DEST_SH = 18
PB_STUCK_SH = 0
PB_STRAND_SH = 12
PB_CONTRA_SH = 24
PC_DEPART_SH = 0
PC_STEPS_SH = 20
PD_PHASE_SH = 0
PD_TIMER_SH = 2
PD_BLOCK_SH = 10
PD_CFKEY_SH = 24
PD_CFMODE_SH = 26
PD_CFSTEPS_SH = 27

FLAG_NEW_MAL = 1
FLAG_NEW_COL = 2
FLAG_MOVED = 4
ND_NONE4 = 0x07070707
KBIG = 1 << 19
KINF = 0x7FFFFFFF

launches = {"decide_move": 0, "build_sdir": 0, "build_sdir_batched": 0,
            "build_wavefront": 0, "prefix_planes": 0, "ordered_add": 0,
            "select_rows": 0, "mega": 0, "rain_ticks": 0,
            "decide_move_tiled": 0, "render": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def i32(c: int) -> int:
    """A u32 bit pattern as the int32 value with the same bits."""
    c &= 0xFFFFFFFF
    return c - (1 << 32) if c >= (1 << 31) else c


def _bit(p, sh):
    return ((p >> sh) & 1) != 0


def _fld(p, sh, bits):
    return (p >> sh) & ((1 << bits) - 1)


def _u(x):
    """bool/int plane -> int32, for packing."""
    return x.to(torch.int32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def select_dest_rows(sdir4: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """nd[y, x] = byte dest[y, x] of the packed stack (engine.pack_sdir4
    layout: byte k of word g = row 4g+k); ND_NONE when dest >> 2 falls
    outside the stack (the JAX masked reduction finds no word)."""
    D4 = sdir4.shape[0]
    hi = dest >> 2
    hit = (hi >= 0) & (hi < D4)
    w = torch.gather(sdir4, 0, hi.clamp(0, D4 - 1).to(torch.int64)[None])[0]
    w = torch.where(hit, w, ND_NONE4)
    return (w >> ((dest & 3) * 8)) & 0xFF


def _resolve(nd, head1, allow=None, wnd=None, wkey=None):
    """Move direction (7 = none) and contraflow flag from the sdir byte,
    the heading + 1 and, for vehicles holding a contraflow allowance,
    the wavefront byte of their excursion key (pallas_engine._resolve)."""
    h = torch.clamp(head1 - 1, min=0)
    sok = (((nd >> (4 + h)) & 1) == 1) & (head1 > 0)
    d = torch.where(sok, h, nd & 7)
    contra = ~sok & ((nd & 8) != 0)
    if allow is not None:
        wi = (wnd >> (wkey * 8)) & 0xFF
        wdir = wi & 7
        use_w = allow & (wdir < 7)
        d = torch.where(use_w, wdir, d)
        contra = (use_w & ((wi & 8) != 0)) | (~use_w & contra)
    return d, contra


def decide_move_core(cfg: Config, sdir4, wnd, pa, pb, pc, pd, pe, pl,
                     stop_map, rain_map, ped_block, intersection, dest_id,
                     r_mal, r_side, r_reroll, r_prio, select=None):
    """Plain version of K1: the JAX `decide_move_core` with padded shifts.
    Planes pa..pe and `wnd`, `r_prio` are int32 bit patterns; masks bool;
    `pl`, `r_mal`, `r_side` f32; `r_reroll`, `dest_id` int32.  `select`
    maps a dest plane to its next-move byte plane; None is the gather
    select of `sdir4` (the dense path).  Returns (pa, pb, pc, pd, pe, pl,
    flags int32)."""
    shift = _shift_plane
    H, W = pa.shape
    dev = pa.device
    present = (pa & 1) == 1

    if select is None:
        def select(dest):
            return select_dest_rows(sdir4, dest)

    # ---- decide -------------------------------------------------------------
    col0 = _bit(pa, PA_COL_SH)
    mal0 = _bit(pa, PA_MAL_SH)
    parked = _bit(pa, PA_PARKED_SH)
    stuckf = _bit(pa, PA_STUCKF_SH)
    head1 = _fld(pa, PA_HEAD_SH, 3)
    cur0 = _fld(pa, PA_CUR_SH, 4)

    stranded0 = col0 | mal0
    st = _fld(pb, PB_STRAND_SH, 12)
    st = torch.where(present & stranded0, st - 1, st)
    recovered = present & stranded0 & (st <= 0)
    col = col0 & ~recovered
    mal = mal0 & ~recovered
    st = torch.where(recovered, 0, st)
    still_stranded = present & (col | mal)

    if cfg.VEHICLE_MALFUNCTION_ACTIVE:
        roll = r_mal < cfg.VEHICLE_MALFUNCTION_CHANCE
        new_mal = present & ~still_stranded & ~parked & roll
        mal = mal | new_mal
        st = torch.where(new_mal, cfg.VEHICLE_MALFUNCTION_DURATION, st)
        still_stranded = still_stranded | new_mal
    else:
        new_mal = torch.zeros((H, W), dtype=torch.bool, device=dev)

    new_col = torch.zeros((H, W), dtype=torch.bool, device=dev)
    if cfg.VEHICLE_SIDESWIPE_COLLISION_ACTIVE:
        moving_nb = present & (cur0 > 0) & ~stuckf & ~parked & ~col0 & ~mal0
        hk = torch.clamp(head1 - 1, min=0)
        opp1 = ((hk + 2) % 4) + 1
        side_hit = torch.zeros((H, W), dtype=torch.bool, device=dev)
        for m in range(4):
            nb_mov = shift(moving_nb, m, False)
            nb_head = shift(head1, m, 0)
            rel = (m - hk) % 4
            perp = (rel == 1) | (rel == 3)
            side_hit = side_hit | (nb_mov & (nb_head == opp1) & perp)
        moving = present & (cur0 > 0) & ~stuckf & ~parked & ~still_stranded
        roll = r_side < cfg.VEHICLE_SIDESWIPE_COLLISION_CHANCE
        new_col = moving & (head1 > 0) & side_hit & roll
        col = col | new_col
        st = torch.where(new_col, cfg.VEHICLE_SIDESWIPE_COLLISION_DURATION,
                         st)
        still_stranded = still_stranded | new_col

    halted = still_stranded | (present & stop_map) | parked

    base = _fld(pa, PA_BASE_SH, 4)
    base = torch.where(present & (base == 0), r_reroll, base)
    speed = base
    if cfg.RAIN_ENABLED:
        speed = torch.where(rain_map, torch.clamp(
            speed - cfg.RAIN_SPEED_REDUCTION, min=1), speed)
    speed = torch.where(halted, 0, speed)
    base = torch.where(halted, 0, base)

    dest14 = _fld(pa, PA_DEST_SH, 14)
    nd0 = select(dest14)
    dir0, contra0 = _resolve(nd0, head1)
    at_dest0 = present & (dest_id >= 0) & (dest14 == dest_id)

    ct = torch.clamp(_fld(pb, PB_CONTRA_SH, 8) - 1, min=0)
    CF_CLEAR = i32(~(0xFF << PD_CFKEY_SH))
    wkey0 = _fld(pd, PD_CFKEY_SH, 2)
    wdir0 = ((wnd >> (wkey0 * 8)) & 0xFF) & 7
    merged = present & (ct > 0) & ~_bit(pd, PD_CFMODE_SH) & \
        (wdir0 == 7) & (dir0 < 7) & ~contra0
    ct = torch.where(merged, 0, ct)
    pd = torch.where(merged, pd & CF_CLEAR, pd)
    allow_pre = present & ~halted & (ct > 0)
    blocked = present & ~halted & ~at_dest0 & \
        ((dir0 == 7) | (contra0 & ~allow_pre))
    overtake = blocked & cfg.VEHICLE_CONTRAFLOW_OVERTAKE_ACTIVE
    stuck_v = _fld(pb, PB_STUCK_SH, 12)
    thresh = torch.where(
        intersection, cfg.VEHICLE_STUCK_CONTRAFLOW_THRESHOLD_INTERSECTION,
        cfg.VEHICLE_STUCK_CONTRAFLOW_THRESHOLD)
    stuck_detour = (stuck_v >= thresh) & present & \
        cfg.VEHICLE_STUCK_CONTRAFLOW_ENABLED
    newly = present & ~halted & (overtake | stuck_detour) & (ct == 0)
    ct = torch.where(newly, torch.where(
        stuck_detour, cfg.VEHICLE_CONTRAFLOW_STUCK_DETOUR_DURATION,
        cfg.VEHICLE_CONTRAFLOW_OVERTAKE_DURATION).to(torch.int32), ct)
    key_new = torch.where(head1 > 0, head1 - 1,
                          torch.where(dir0 < 4, dir0, 0))
    pd = torch.where(newly, (pd & CF_CLEAR)
                     | (key_new << PD_CFKEY_SH)
                     | (_u(stuck_detour) << PD_CFMODE_SH), pd)
    wkey_dec = _fld(pd, PD_CFKEY_SH, 2)

    CLEAR_A = i32(~((15 << PA_BASE_SH) | (15 << PA_CUR_SH)
                    | (1 << PA_COL_SH) | (1 << PA_MAL_SH)))
    pa = (pa & CLEAR_A) \
        | (base << PA_BASE_SH) \
        | (torch.where(present, speed, cur0) << PA_CUR_SH) \
        | (_u(col) << PA_COL_SH) | (_u(mal) << PA_MAL_SH)
    pb = (stuck_v.clamp(0, 4095)
          | (st.clamp(0, 4095) << PB_STRAND_SH)
          | (ct.clamp(0, 255) << PB_CONTRA_SH))

    # ---- move: K CA sub-rounds ---------------------------------------------
    occ0 = present
    prio = (r_prio >> 4) & 0x0FFFFFF8
    steps_left = torch.where(present, speed, 0)
    moved = torch.zeros((H, W), dtype=torch.int32, device=dev)
    halt_latch = _u(halted)
    HEAD_CLR = i32(~(7 << PA_HEAD_SH))
    CFS_CLR = i32(~(31 << PD_CFSTEPS_SH))
    bb_static = _u(stop_map) | (_u(occ0) << 2) | (_u(ped_block) << 3)

    for _s in range(cfg.VEHICLE_MAX_SPEED):
        present_c = (pa & 1) == 1
        dest_c = _fld(pa, PA_DEST_SH, 14)
        nd = select(dest_c)
        h1 = _fld(pa, PA_HEAD_SH, 3)
        at_dest_c = present_c & (dest_id >= 0) & (dest_c == dest_id)
        csteps = _fld(pd, PD_CFSTEPS_SH, 5)
        climit = torch.where(_bit(pd, PD_CFMODE_SH),
                             cfg.VEHICLE_MAX_CONTRAFLOW_STUCK_DETOUR_STEPS,
                             cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS)
        allow = (_fld(pb, PB_CONTRA_SH, 8) > 0) & (csteps < climit)
        dir_, contra = _resolve(nd, h1, allow, wnd,
                                _fld(pd, PD_CFKEY_SH, 2))
        can_dir = (dir_ < 7) & (~contra | allow)
        want = present_c & (halt_latch == 0) & (steps_left > 0) & ~at_dest_c

        bb = bb_static | (_u(present_c) << 1)
        blocked_t = torch.zeros((H, W), dtype=torch.bool, device=dev)
        for m in range(4):
            tb = shift(bb, m, 0xF)
            blocked_t = blocked_t | ((dir_ == m) & (tb != 0))
        can = want & can_dir & ~blocked_t

        inkeys = []
        for m in range(4):
            src_key = torch.where(can & (dir_ == m), prio | m, KINF)
            inkeys.append(shift(src_key, C.opposite(m), KINF))
        minkey = torch.minimum(torch.minimum(inkeys[0], inkeys[1]),
                               torch.minimum(inkeys[2], inkeys[3]))
        arrive_m = [(inkeys[m] == minkey) & (inkeys[m] != KINF)
                    for m in range(4)]
        won = torch.zeros((H, W), dtype=torch.bool, device=dev)
        for m in range(4):
            won = won | (can & (dir_ == m) & shift(arrive_m[m], m, False))

        def move_plane(P, zero, fm=None):
            out = torch.where(won, zero, P)
            for m in range(4):
                src = torch.where(can & (dir_ == m),
                                  fm(P, m) if fm is not None else P, zero)
                inc = shift(src, C.opposite(m), zero)
                out = torch.where(arrive_m[m], inc, out)
            return out

        pa = move_plane(pa, 0, lambda P, m: (P & HEAD_CLR)
                        | ((m + 1) << PA_HEAD_SH))
        pb = move_plane(pb, 0)
        pc = move_plane(pc, 0, lambda P, m: (torch.clamp(
            _fld(P, PC_STEPS_SH, 12) + 1, max=4095) << PC_STEPS_SH)
            | (P & ((1 << PC_STEPS_SH) - 1)))
        pd = move_plane(pd, 0, lambda P, m, contra=contra: torch.where(
            contra, (P & CFS_CLR) | (torch.clamp(
                _fld(P, PD_CFSTEPS_SH, 5) + 1, max=31) << PD_CFSTEPS_SH),
            P))
        pe = move_plane(pe, 0)
        pl = move_plane(pl, 0.0)
        steps_left = move_plane(steps_left, 0, lambda P, m: P - 1)
        moved = move_plane(moved, 0, lambda P, m: torch.ones_like(P))
        halt_latch = halt_latch | _u(want & ~won)

    moved = moved != 0
    present = (pa & 1) == 1

    # ---- base-speed reset and stuck bookkeeping -------------------------------
    bb0 = stop_map | occ0 | ped_block
    dir0r, contra0r = _resolve(nd0, head1, present & (ct > 0), wnd, wkey_dec)
    tgt_blocked0 = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for m in range(4):
        tgt_blocked0 = tgt_blocked0 | ((dir0r == m) & shift(bb0, m, True))
    allow0 = present & (_fld(pb, PB_CONTRA_SH, 8) > 0)
    fb0 = at_dest0 | (dir0r == 7) | (contra0r & ~allow0) | tgt_blocked0
    base_reset = present & ~moved & fb0
    pa = torch.where(base_reset, pa & i32(~(15 << PA_BASE_SH)), pa)

    at_stop_f = present & stop_map
    stuck_v = _fld(pb, PB_STUCK_SH, 12)
    stuck_inc = present & ~moved & ~at_stop_f
    stuck_v = torch.where(present & moved, 0, torch.where(
        stuck_inc, torch.clamp(stuck_v + 1, max=4095), stuck_v))
    stuckf = _bit(pa, PA_STUCKF_SH)
    stuckf = ~(present & moved) & \
        ((stuck_v > cfg.VEHICLE_STUCK_RECOMPUTE_THRESHOLD) | stuckf)
    pa = (pa & i32(~(1 << PA_STUCKF_SH))) | (_u(stuckf) << PA_STUCKF_SH)
    pb = (pb & i32(~4095)) | stuck_v.clamp(0, 4095)

    flags = (_u(new_mal) * FLAG_NEW_MAL | _u(new_col) * FLAG_NEW_COL
             | _u(moved) * FLAG_MOVED)
    return pa, pb, pc, pd, pe, pl, flags


def sdir_encode(K0: torch.Tensor, pen4: torch.Tensor, legal4: torch.Tensor,
                tp2: int) -> torch.Tensor:
    """Plain version of K2 (`pallas_engine._sdir_body`): per
    (destination, cell) the next-move byte from the pre-encoded key
    stack K0 [D, 4, H, W], the dynamic entry costs pen4 [4, H, W] and
    the legality planes legal4 [4, H, W]; 4 destinations packed per
    int32 word -> [ceil(D/4), H, W].  Rows past D decode to 7."""
    D, _, H, W = K0.shape
    D4 = (D + 3) // 4
    dev = K0.device
    legal = [legal4[m] != 0 for m in range(4)]
    lp = _u(legal[0]) | (_u(legal[1]) << 1) | (_u(legal[2]) << 2) \
        | (_u(legal[3]) << 3)
    hbit = [torch.where(legal[h], 1 << (4 + h), 0).to(torch.int32)
            for h in range(4)]
    pshift = [pen4[m] << 2 for m in range(4)]
    out = torch.zeros((D4, H, W), dtype=torch.int32, device=dev)
    GB = 32                                     # words per block
    for g0 in range(0, D4, GB):
        g1 = min(D4, g0 + GB)
        word = torch.zeros((g1 - g0, H, W), dtype=torch.int32, device=dev)
        for k in range(4):
            rows = torch.arange(4 * g0 + k, 4 * g1, 4, device=dev)
            enc = torch.full((g1 - g0, H, W), 7, dtype=torch.int32,
                             device=dev)
            rows = rows[rows < D]
            if rows.numel():
                blk = K0[rows]
                keys = [blk[:, m] + pshift[m] for m in range(4)]
                bk = torch.minimum(torch.minimum(keys[0], keys[1]),
                                   torch.minimum(keys[2], keys[3]))
                best = bk >> 2
                mstar = bk & 3
                contra = ((lp >> mstar) & 1) ^ 1
                e = mstar | (contra << 3)
                bnd2 = (torch.clamp(best + tp2, max=KBIG - 1) << 2) | 3
                for h in range(4):
                    e = e | torch.where(keys[h] <= bnd2, hbit[h], 0)
                e = torch.where(best >= KBIG, 7, e)
                enc[:rows.numel()] = e
            word = word | (enc << (8 * k))
        out[g0:g1] = word
    return out


def wavefront_core(cfg: Config, allowed, is_road, hard) -> torch.Tensor:
    """Plain version of K3 (`pallas_engine.wavefront_core` with padded
    shifts).  `allowed` u8/i32 bitmask, `is_road`/`hard` bool.  Returns
    the packed int32 word plane (byte d = wavefront for blocked
    direction d: bits 0-2 move direction, 7 = none; bit 3 contraflow)."""
    shift = _shift_plane
    K_OVT = cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS
    BIGW = 127
    allowed = allowed.to(torch.int32)
    legal = [(allowed & C.DIR_BITS[m]) != 0 for m in range(4)]
    legal_w = _u(legal[0]) | (_u(legal[1]) << 1) | (_u(legal[2]) << 2) \
        | (_u(legal[3]) << 3)
    can_mv = [(legal[m] | shift(is_road, m, False)) & ~shift(hard, m, True)
              for m in range(4)]
    road_free = is_road & ~hard

    def relax(Wv):
        for _ in range(K_OVT):
            nv = Wv
            for m in range(4):
                c = torch.where(can_mv[m], shift(Wv, m, BIGW), BIGW) + 1
                nv = torch.minimum(nv, c)
            Wv = torch.clamp(nv, max=BIGW)
        return Wv

    out = None
    for d in range(4):
        src = shift(hard & legal[d], C.opposite(d), False) & road_free
        Wv = relax(torch.where(src, 0, BIGW).to(torch.int32))
        wbest = torch.full_like(Wv, BIGW)
        warg = torch.full_like(Wv, 7)
        for m in range(4):
            c = torch.where(can_mv[m], shift(Wv, m, BIGW), BIGW)
            upd = c < wbest
            wbest = torch.where(upd, c, wbest)
            warg = torch.where(upd, m, warg)
        wvalid = (Wv <= K_OVT) & (wbest < Wv)
        wcontra = 1 - ((legal_w >> warg) & 1)
        byte = torch.where(wvalid, warg | (wcontra << 3), 7)
        out = byte if out is None else out | (byte << (8 * d))
    return out.to(torch.int32)


def decide_move_core_batched(cfg: Config, sdir4, wnd, planes, stop_map,
                             rain_map, ped_block, intersection, dest_id,
                             randoms):
    """Plain version of the batched K1: `decide_move_core` per world;
    every argument carries a leading B except the shared `intersection`
    and `dest_id`.  Returns the 7 outputs, each [B, H, W]."""
    outs = [decide_move_core(
        cfg, sdir4[b], wnd[b], *(p[b] for p in planes), stop_map[b],
        rain_map[b], ped_block[b], intersection, dest_id,
        *(r[b] for r in randoms)) for b in range(planes[0].shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def wavefront_core_batched(cfg: Config, allowed, is_road, hard):
    """Plain version of the batched K3: `wavefront_core` per world of
    `hard` [B, H, W] over the shared geometry."""
    return torch.stack([wavefront_core(cfg, allowed, is_road, h)
                        for h in hard])


def sdir_encode_batched(K0, pen4b, legal4, tp2: int) -> torch.Tensor:
    """Plain version of K5: K2's encode per world over a shared key
    stack, [B, ceil(D/4), H, W]."""
    return torch.stack([sdir_encode(K0, p, legal4, tp2) for p in pen4b])


def prefix_planes_plain(occ: torch.Tensor):
    """Plain version of K4: row- and column-inclusive prefix sums of an
    int32 plane [..., H, W], (incH, incV)."""
    return (torch.cumsum(occ, -1, dtype=torch.int32),
            torch.cumsum(occ, -2, dtype=torch.int32))


def ordered_add_plain(base, idx, vals) -> torch.Tensor:
    """Plain version of `ordered_add`: per row r, base[r] with vals[r, i]
    added at idx[r, i] (int64) in update order, as XLA's CPU scatter-add
    folds duplicates; indices outside [0, T) are dropped.  The CPU
    `index_add` adds a 1-D row in index order."""
    T = base.shape[-1]
    out = []
    for b, i, v in zip(base.reshape(-1, T), idx.reshape(-1, idx.shape[-1]),
                       vals.reshape(-1, vals.shape[-1])):
        keep = (i >= 0) & (i < T)
        out.append(b.index_add(0, i[keep], v[keep]))
    return torch.stack(out).reshape(base.shape)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _on_cuda(t: torch.Tensor) -> bool:
    """CPU -> plain version; CUDA -> the kernel; anything else raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, kernel runs on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _call(entry, *args):
    from . import build
    rc = getattr(build.load(), entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} "
                           f"({build.error_string(rc)})")


# ---- vmap rules ------------------------------------------------------------

def _front(x, bdim, B):
    """x with its batch dim first, or broadcast to B worlds when the
    vmapped call shares it (contiguous either way)."""
    if bdim is None:
        return x.unsqueeze(0).expand(B, *x.shape).contiguous()
    return x.movedim(bdim, 0).contiguous()


def _map_worlds(fn, B, in_dims, args):
    """fn mapped over the worlds of a vmapped call: each batched tensor
    argument is indexed per world, the rest passed as is; the outputs
    stacked along a new dim 0."""
    outs = []
    for b in range(B):
        outs.append(fn(*[a.select(d, b) if d is not None else a
                         for a, d in zip(args, in_dims)]))
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


class _Kernel(torch.autograd.Function):
    """A kernel wrapper as an autograd.Function: `forward` is the
    single-world wrapper, `vmap` the rule under torch.func.vmap.  No
    gradients."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


# ---- K1 --------------------------------------------------------------------

_N_SCRATCH_DM = 20        # K1's per-world scratch planes (decide_move.cuh)


def _dm_params(cfg: Config):
    ip = (ctypes.c_int * 16)(
        int(cfg.VEHICLE_MALFUNCTION_ACTIVE),
        int(cfg.VEHICLE_SIDESWIPE_COLLISION_ACTIVE),
        int(cfg.RAIN_ENABLED), int(cfg.VEHICLE_CONTRAFLOW_OVERTAKE_ACTIVE),
        int(cfg.VEHICLE_STUCK_CONTRAFLOW_ENABLED),
        cfg.VEHICLE_MALFUNCTION_DURATION,
        cfg.VEHICLE_SIDESWIPE_COLLISION_DURATION,
        cfg.RAIN_SPEED_REDUCTION,
        cfg.VEHICLE_STUCK_CONTRAFLOW_THRESHOLD,
        cfg.VEHICLE_STUCK_CONTRAFLOW_THRESHOLD_INTERSECTION,
        cfg.VEHICLE_CONTRAFLOW_STUCK_DETOUR_DURATION,
        cfg.VEHICLE_CONTRAFLOW_OVERTAKE_DURATION,
        cfg.VEHICLE_MAX_CONTRAFLOW_STUCK_DETOUR_STEPS,
        cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS,
        cfg.VEHICLE_STUCK_RECOMPUTE_THRESHOLD, cfg.VEHICLE_MAX_SPEED)
    # the thresholds compare against f32 draws, as the JAX `<` does
    fp = (ctypes.c_float * 2)(cfg.VEHICLE_MALFUNCTION_CHANCE,
                              cfg.VEHICLE_SIDESWIPE_COLLISION_CHANCE)
    return ip, fp


def decide_move_batched(cfg: Config, sdir4, wnd, planes, stop_map, rain_map,
                        ped_block, intersection, dest_id, randoms):
    """K1 for a batch of B worlds: every argument carries a leading B
    except the shared geometry `intersection` and `dest_id` [H, W].
    Returns (pa, pb, pc, pd, pe, pl, flags), each [B, H, W].

    Replaces `pallas_engine.decide_move_pallas` (`_kernel` ->
    `decide_move_core`, ops/pallas_engine.py; batched by `jax.vmap`
    through the Pallas batching rule).  Source: csrc/decide_move.cu.  On
    the H100 it is bound by launches and device memory bytes, not
    arithmetic: ~30 int32 planes of 256 KB per world are read and written
    per sub-round, far below the card's bandwidth, so the 12 dependent
    launches per tick set its time.  Design: one thread per cell and
    world (blockIdx.y) in phases with double-buffered planes in device
    memory (a `decide` kernel, then per sub-round an `intent` kernel that
    publishes each mover's conflict key and a `commit` kernel that
    resolves every target's lowest key from neighbours up to two cells
    away and pulls the winner's planes, then a `finish` kernel); the
    destination-row select is one indexed load.  Fusing the sub-rounds
    into one halo-tiled kernel (TILE_HALO >= 12 is exact) is later speed
    work."""
    pa = planes[0]
    r_mal, r_side, r_reroll, r_prio = randoms
    if not _on_cuda(pa):
        return decide_move_core_batched(cfg, sdir4, wnd, planes, stop_map,
                                        rain_map, ped_block, intersection,
                                        dest_id, randoms)
    B, H, W = pa.shape
    dev = pa.device
    i32t, f32t, bt = torch.int32, torch.float32, torch.bool
    _check("sdir4", sdir4, i32t, (B, sdir4.shape[1], H, W), dev)
    for name, t, dt in (("wnd", wnd, i32t), ("pa", pa, i32t),
                        ("pb", planes[1], i32t), ("pc", planes[2], i32t),
                        ("pd", planes[3], i32t), ("pe", planes[4], i32t),
                        ("pl", planes[5], f32t), ("stop_map", stop_map, bt),
                        ("rain_map", rain_map, bt),
                        ("ped_block", ped_block, bt),
                        ("r_mal", r_mal, f32t), ("r_side", r_side, f32t),
                        ("r_reroll", r_reroll, i32t),
                        ("r_prio", r_prio, i32t)):
        _check(name, t, dt, (B, H, W), dev)
    _check("intersection", intersection, bt, (H, W), dev)
    _check("dest_id", dest_id, i32t, (H, W), dev)
    outs = [torch.empty((B, H, W), dtype=i32t, device=dev)
            for _ in range(5)]
    out_pl = torch.empty((B, H, W), dtype=f32t, device=dev)
    flags = torch.empty((B, H, W), dtype=i32t, device=dev)
    scratch = torch.empty((B, 20, H, W), dtype=i32t, device=dev)
    ip, fp = _dm_params(cfg)
    _call("tsim_decide_move", ctypes.cast(ip, ctypes.c_void_p),
          ctypes.cast(fp, ctypes.c_void_p),
          _ptr(sdir4), ctypes.c_int(sdir4.shape[1]), _ptr(wnd),
          *[_ptr(p) for p in planes],
          _ptr(stop_map), _ptr(rain_map), _ptr(ped_block),
          _ptr(intersection), _ptr(dest_id), _ptr(r_mal), _ptr(r_side),
          _ptr(r_reroll), _ptr(r_prio),
          *[_ptr(o) for o in outs], _ptr(out_pl), _ptr(flags),
          _ptr(scratch), ctypes.c_int(B), ctypes.c_int(H), ctypes.c_int(W),
          _stream(dev))
    launches["decide_move"] += 1
    return (*outs, out_pl, flags)


# argument positions of _DecideMove after cfg: the per-world tensors and
# the shared geometry
_DM_SHARED = (11, 12)       # intersection, dest_id


def _dm_batched(cfg, args):
    (sdir4, wnd, pa, pb, pc, pd, pe, pl, stop_map, rain_map, ped_block,
     intersection, dest_id, r_mal, r_side, r_reroll, r_prio) = args
    return decide_move_batched(cfg, sdir4, wnd, (pa, pb, pc, pd, pe, pl),
                               stop_map, rain_map, ped_block, intersection,
                               dest_id, (r_mal, r_side, r_reroll, r_prio))


class _DecideMove(_Kernel):
    @staticmethod
    def forward(cfg, *args):
        if not _on_cuda(args[2]):
            return decide_move_core(cfg, *args)
        one = [a if i in _DM_SHARED else a.unsqueeze(0)
               for i, a in enumerate(args)]
        return tuple(o[0] for o in _dm_batched(cfg, one))

    @staticmethod
    def vmap(info, in_dims, cfg, *args):
        dims = in_dims[1:]
        B = info.batch_size
        if any(dims[i] is not None for i in _DM_SHARED):
            out = _map_worlds(lambda *a: _DecideMove.forward(cfg, *a), B,
                              dims, args)
        else:
            out = _dm_batched(cfg, [
                a if i in _DM_SHARED else _front(a, d, B)
                for i, (a, d) in enumerate(zip(args, dims))])
        return out, (0,) * 7


def decide_move(cfg: Config, sdir4, wnd, planes, stop_map, rain_map,
                ped_block, intersection, dest_id, randoms):
    """K1 for one world (`decide_move_batched` with B = 1; under vmap one
    batched launch).  Planes pa..pe and `wnd`, `r_prio` are int32 bit
    patterns; masks bool; `pl`, `r_mal`, `r_side` f32; `r_reroll`,
    `dest_id` int32.  Returns (pa, pb, pc, pd, pe, pl, flags int32)."""
    return _DecideMove.apply(cfg, sdir4, wnd, *planes, stop_map, rain_map,
                             ped_block, intersection, dest_id, *randoms)


# ---- K7 --------------------------------------------------------------------

# Contamination depth of one tick at a window edge: the decide phase
# reads neighbours 1 away; each movement sub-round 3 (a mover's key
# depends on its target's occupancy, a cell's commit on keys 2 away):
# 1 + 5 x 3 = 16 at VEHICLE_MAX_SPEED = 5, so the ring is just enough.
TILE_HALO = 16


def pick_tile(cfg: Config, D: int):
    """Largest [th, tw] tile whose window fits the Mosaic scoped-vmem
    budget of the JAX package's tiled kernel, or None (JAX's
    `pallas_engine.pick_tile`, copied as it is: ~1060 bytes per window
    cell, a 15 MB budget and a halo ratio under 1.6; None at every
    shape the repo runs)."""
    H, W = cfg.HEIGHT, cfg.WIDTH
    P = TILE_HALO
    for th, tw in ((128, 128), (128, 64), (64, 64)):
        if H % th or W % tw:
            continue
        win = (th + 2 * P) * (tw + 2 * P)
        need = 1060 * win + D * win
        if need < 15 * 1024 * 1024 and win < 1.6 * th * tw:
            return th, tw
    return None


def _check_tiling(H: int, W: int, th: int, tw: int):
    if th <= 0 or tw <= 0 or H % th or W % tw:
        raise ValueError(f"tile ({th}, {tw}) does not divide the grid "
                         f"({H}, {W})")


def decide_move_tiled_plain(cfg: Config, sdir4, wnd, planes, stop_map,
                            rain_map, ped_block, intersection, dest_id,
                            randoms, th: int, tw: int):
    """Plain version of K7, JAX's structure: every plane padded by
    TILE_HALO with JAX's fills (nothing present, stop 1, no roads or
    destinations, draws that never fire), `decide_move_core` on each
    [th + 2P, tw + 2P] window, the interiors assembled."""
    H, W = planes[0].shape
    _check_tiling(H, W, th, tw)
    P = TILE_HALO

    def pad(x, fill):
        out = torch.full((*x.shape[:-2], H + 2 * P, W + 2 * P), fill,
                         dtype=x.dtype, device=x.device)
        out[..., P:P + H, P:P + W] = x
        return out
    r_mal, r_side, r_reroll, r_prio = randoms
    padded = (pad(sdir4, ND_NONE4), pad(wnd, ND_NONE4),
              *(pad(p, 0) for p in planes[:5]), pad(planes[5], 0.0),
              pad(stop_map, True), pad(rain_map, False),
              pad(ped_block, False), pad(intersection, False),
              pad(dest_id, -1), pad(r_mal, 1.0), pad(r_side, 1.0),
              pad(r_reroll, 1), pad(r_prio, 0))
    outs = [torch.empty_like(p) for p in planes] + [
        torch.empty_like(planes[0])]
    for y in range(0, H, th):
        for x in range(0, W, tw):
            win = [t[..., y:y + th + 2 * P, x:x + tw + 2 * P]
                   for t in padded]
            res = decide_move_core(cfg, *win)
            for o, v in zip(outs, res):
                o[y:y + th, x:x + tw] = v[P:P + th, P:P + tw]
    return tuple(outs)


def decide_move_tiled(cfg: Config, sdir4, wnd, planes, stop_map, rain_map,
                      ped_block, intersection, dest_id, randoms,
                      th: int, tw: int):
    """K7, K1's decide + move for one world over [th, tw] tiles, each
    run on its window with a TILE_HALO ring (th | H and tw | W).  Takes
    K1's single-world arguments and returns its outputs, bit-equal.

    Replaces `pallas_engine.decide_move_tiled` (its `pallas_call`,
    ops/pallas_engine.py).  Source: csrc/decide_tiled.cu.  On no path:
    `engine.step_engine` runs K1 (dense) or the plain core with K6
    (hierarchical), as JAX's gate (`pick_tile`) never picks the tiled
    kernel.  On the H100 it is bound by device-memory bytes: K1's planes
    read once per window, so (th + 2P)(tw + 2P) / (th tw) times K1's
    bytes.  Design: one launch, one CTA per tile; the CTA copies its
    window (JAX's pad fills outside the grid) into device memory and
    runs K1's phase bodies over it with `__syncthreads()` between the
    2K + 2 phases; the row select reads the whole grid's stack at the
    cell's global coordinate; only the interior is written."""
    pa = planes[0]
    H, W = pa.shape
    _check_tiling(H, W, th, tw)
    if not _on_cuda(pa):
        return decide_move_tiled_plain(cfg, sdir4, wnd, planes, stop_map,
                                       rain_map, ped_block, intersection,
                                       dest_id, randoms, th, tw)
    dev = pa.device
    r_mal, r_side, r_reroll, r_prio = randoms
    i32t, f32t, bt = torch.int32, torch.float32, torch.bool
    D4 = sdir4.shape[0]
    _check("sdir4", sdir4, i32t, (D4, H, W), dev)
    for name, t, dt in (("wnd", wnd, i32t), ("pa", pa, i32t),
                        ("pb", planes[1], i32t), ("pc", planes[2], i32t),
                        ("pd", planes[3], i32t), ("pe", planes[4], i32t),
                        ("pl", planes[5], f32t), ("stop_map", stop_map, bt),
                        ("rain_map", rain_map, bt),
                        ("ped_block", ped_block, bt),
                        ("intersection", intersection, bt),
                        ("dest_id", dest_id, i32t),
                        ("r_mal", r_mal, f32t), ("r_side", r_side, f32t),
                        ("r_reroll", r_reroll, i32t),
                        ("r_prio", r_prio, i32t)):
        _check(name, t, dt, (H, W), dev)
    P = TILE_HALO
    T = (H // th) * (W // tw)
    n = (th + 2 * P) * (tw + 2 * P)
    outs = [torch.empty((H, W), dtype=i32t, device=dev) for _ in range(5)]
    out_pl = torch.empty((H, W), dtype=f32t, device=dev)
    flags = torch.empty((H, W), dtype=i32t, device=dev)
    win32 = torch.empty((T, 12, n), dtype=i32t, device=dev)
    win8 = torch.empty((T, 4, n), dtype=torch.uint8, device=dev)
    scratch = torch.empty((T, _N_SCRATCH_DM, n), dtype=i32t, device=dev)
    ip, fp = _dm_params(cfg)
    _call("tsim_decide_tiled", ctypes.cast(ip, ctypes.c_void_p),
          ctypes.cast(fp, ctypes.c_void_p), _ptr(sdir4), ctypes.c_int(D4),
          _ptr(wnd), *[_ptr(p) for p in planes],
          _ptr(stop_map), _ptr(rain_map), _ptr(ped_block),
          _ptr(intersection), _ptr(dest_id), _ptr(r_mal), _ptr(r_side),
          _ptr(r_reroll), _ptr(r_prio),
          *[_ptr(o) for o in outs], _ptr(out_pl), _ptr(flags),
          _ptr(win32), _ptr(win8), _ptr(scratch), ctypes.c_int(H),
          ctypes.c_int(W), ctypes.c_int(th), ctypes.c_int(tw),
          ctypes.c_int(P), _stream(dev))
    launches["decide_move_tiled"] += 1
    return (*outs, out_pl, flags)


# ---- K2 / K5 ----------------------------------------------------------------

def _sdir_single(K0, pen4, legal4, tp2: int):
    if not _on_cuda(K0):
        return sdir_encode(K0, pen4, legal4, tp2)
    D, _, H, W = K0.shape
    dev = K0.device
    _check("K0", K0, torch.int32, (D, 4, H, W), dev)
    _check("pen4", pen4, torch.int32, (4, H, W), dev)
    _check("legal4", legal4, torch.int32, (4, H, W), dev)
    out = torch.empty(((D + 3) // 4, H, W), dtype=torch.int32, device=dev)
    _call("tsim_build_sdir", _ptr(K0), _ptr(pen4), _ptr(legal4), _ptr(out),
          ctypes.c_int(D), ctypes.c_int(H * W), ctypes.c_int(int(tp2)),
          _stream(dev))
    launches["build_sdir"] += 1
    return out


def build_sdir_batched(K0, pen4b, legal4, tp2: int):
    """K5, the per-segment next-move stacks of B worlds that share the
    key stack K0 [D, 4, H, W] and the legality planes legal4 [4, H, W]:
    pen4b [B, 4, H, W] -> [B, ceil(D/4), H, W] int32.

    Replaces `pallas_engine.build_sdir_pallas_batched`
    (`_sdir_kernel_batched` -> `_sdir_body`, ops/pallas_engine.py).
    Source: csrc/sdir.cu.  On the H100 its floor is device-memory bytes
    (K0 read once: 637.5 MB at D = 608, 256^2; B packed stacks written:
    39.8 MB each) with the integer encode (about 25 operations per key
    and world) close behind.  Design: one thread per cell and 8 packed
    words; the thread loads a destination row's four keys once and
    encodes it for up to 16 worlds whose pen << 2 it keeps in
    registers, so K0 leaves device memory once per segment for the
    batch, not once per world."""
    if not _on_cuda(K0):
        return sdir_encode_batched(K0, pen4b, legal4, tp2)
    D, _, H, W = K0.shape
    B = pen4b.shape[0]
    dev = K0.device
    _check("K0", K0, torch.int32, (D, 4, H, W), dev)
    _check("pen4b", pen4b, torch.int32, (B, 4, H, W), dev)
    _check("legal4", legal4, torch.int32, (4, H, W), dev)
    out = torch.empty((B, (D + 3) // 4, H, W), dtype=torch.int32,
                      device=dev)
    _call("tsim_build_sdir_batched", _ptr(K0), _ptr(pen4b), _ptr(legal4),
          _ptr(out), ctypes.c_int(D), ctypes.c_int(H * W),
          ctypes.c_int(int(tp2)), ctypes.c_int(B), _stream(dev))
    launches["build_sdir_batched"] += 1
    return out


class _BuildSdir(_Kernel):
    @staticmethod
    def forward(K0, pen4, legal4, tp2):
        return _sdir_single(K0, pen4, legal4, tp2)

    @staticmethod
    def vmap(info, in_dims, K0, pen4, legal4, tp2):
        kd, pd, ld, _ = in_dims
        if kd is None and ld is None and pd is not None:
            out = build_sdir_batched(K0, pen4.movedim(pd, 0).contiguous(),
                                     legal4, tp2)
        else:
            out = _map_worlds(lambda k, p, lg: _sdir_single(k, p, lg, tp2),
                              info.batch_size, (kd, pd, ld),
                              (K0, pen4, legal4))
        return out, 0


def build_sdir(K0, pen4, legal4, tp2: int):
    """K2, the per-segment next-move stack [ceil(D/4), H, W] int32 of one
    world; under vmap with K0 and legal4 shared, K5.

    Replaces `pallas_engine.build_sdir_pallas` (`_sdir_kernel` ->
    `_sdir_body`, ops/pallas_engine.py).  Source: csrc/sdir.cu.  On the
    H100 it is bound by device-memory bytes: it reads the [D, 4, H, W]
    key stack once (637 MB at D = 608, 256^2) and writes the packed
    stack once (40 MB), about 0.2 ms at 3.35 TB/s; its ~20 integer ops
    per key are far below the card's rate.  Design: one thread per cell
    walks a run of packed words, keeps pen/legal in registers and reads
    K0 coalesced along W; each word is written once."""
    return _BuildSdir.apply(K0, pen4, legal4, tp2)


# ---- K3 --------------------------------------------------------------------

def build_wavefront_batched(cfg: Config, allowed, is_road, hard):
    """K3 for B worlds: `allowed` u8 and `is_road` bool [H, W] shared,
    `hard` bool [B, H, W] -> packed int32 [B, H, W].

    Replaces `pallas_engine.build_wavefront_pallas` (`_wavefront_kernel`
    -> `wavefront_core`, ops/pallas_engine.py).  Source:
    csrc/wavefront.cu.  On the H100 it is bound by launch latency: each
    of its 8 launches moves ~1 MB per world.  Design: a seed kernel, one
    ping-pong min-plus relax launch per step over the [4, H, W] direction
    stack of every world (VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS of
    them), then one argmin-and-pack launch; blockIdx.y is the world."""
    if not _on_cuda(allowed):
        return wavefront_core_batched(cfg, allowed, is_road, hard)
    B = hard.shape[0]
    H, W = allowed.shape
    dev = allowed.device
    _check("allowed", allowed, torch.uint8, (H, W), dev)
    _check("is_road", is_road, torch.bool, (H, W), dev)
    _check("hard", hard, torch.bool, (B, H, W), dev)
    out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    scratch = torch.empty((2, B, 4, H, W), dtype=torch.int32, device=dev)
    _call("tsim_build_wavefront", _ptr(allowed), _ptr(is_road), _ptr(hard),
          _ptr(out), _ptr(scratch),
          ctypes.c_int(cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS),
          ctypes.c_int(B), ctypes.c_int(H), ctypes.c_int(W), _stream(dev))
    launches["build_wavefront"] += 1
    return out


class _BuildWavefront(_Kernel):
    @staticmethod
    def forward(cfg, allowed, is_road, hard):
        if not _on_cuda(allowed):
            return wavefront_core(cfg, allowed, is_road, hard)
        return build_wavefront_batched(cfg, allowed, is_road,
                                       hard.unsqueeze(0))[0]

    @staticmethod
    def vmap(info, in_dims, cfg, allowed, is_road, hard):
        _, ad, rd, hd = in_dims
        B = info.batch_size
        if ad is None and rd is None:
            out = build_wavefront_batched(cfg, allowed, is_road,
                                          _front(hard, hd, B))
        else:
            out = _map_worlds(
                lambda a, r, h: _BuildWavefront.forward(cfg, a, r, h), B,
                (ad, rd, hd), (allowed, is_road, hard))
        return out, 0


def build_wavefront(cfg: Config, allowed, is_road, hard):
    """K3 for one world, the per-segment overtake merge wavefronts,
    packed int32 [H, W] (`build_wavefront_batched` with B = 1; under vmap
    one batched launch)."""
    return _BuildWavefront.apply(cfg, allowed, is_road, hard)


# ---- K4 --------------------------------------------------------------------

def prefix_planes_batched(occ):
    """K4 for B planes: occ int32 [B, H, W] -> row- and column-inclusive
    prefix sums (incH, incV), each [B, H, W].

    Replaces `pallas_engine.prefix_planes_pallas` (`_prefix_kernel`,
    ops/pallas_engine.py).  Source: csrc/prefix.cu.  On the H100 it is
    bound by launch latency (a 256 KB plane in, two out, per world).
    Design: one launch of (H + W) x B blocks, one per row and one per
    column of each plane, each a warp-shuffle scan in exact int32 with a
    carry across 256-element tiles."""
    if not _on_cuda(occ):
        return prefix_planes_plain(occ)
    B, H, W = occ.shape
    dev = occ.device
    _check("occ", occ, torch.int32, (B, H, W), dev)
    outh = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    outv = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    _call("tsim_prefix_planes", _ptr(occ), _ptr(outh), _ptr(outv),
          ctypes.c_int(B), ctypes.c_int(H), ctypes.c_int(W), _stream(dev))
    launches["prefix_planes"] += 1
    return outh, outv


class _PrefixPlanes(_Kernel):
    @staticmethod
    def forward(occ):
        if not _on_cuda(occ):
            return prefix_planes_plain(occ)
        h, v = prefix_planes_batched(occ.unsqueeze(0))
        return h[0], v[0]

    @staticmethod
    def vmap(info, in_dims, occ):
        return prefix_planes_batched(_front(occ, in_dims[0],
                                            info.batch_size)), (0, 0)


def prefix_planes(occ):
    """K4 for one plane [H, W] (`prefix_planes_batched` with B = 1; under
    vmap one batched launch)."""
    return _PrefixPlanes.apply(occ)


# ---- K6 --------------------------------------------------------------------

class _SelectRows(_Kernel):
    @staticmethod
    def forward(sdir4, dest):
        if not _on_cuda(sdir4):
            return select_dest_rows(sdir4, dest)
        D4, H, W = sdir4.shape
        dev = sdir4.device
        _check("sdir4", sdir4, torch.int32, (D4, H, W), dev)
        _check("dest", dest, torch.int32, (H, W), dev)
        out = torch.empty((H, W), dtype=torch.int32, device=dev)
        _call("tsim_select_rows", _ptr(sdir4), _ptr(dest), _ptr(out),
              ctypes.c_int(D4), ctypes.c_int(H * W), _stream(dev))
        launches["select_rows"] += 1
        return out


def select_rows(sdir4, dest):
    """K6, the destination-row select: nd[y, x] = byte dest & 3 of the
    word sdir4[dest >> 2, y, x] (int32 [D4, H, W], `engine.pack_sdir4`
    layout), 7 where dest >> 2 is outside [0, D4).  dest int32 [H, W] ->
    int32 [H, W].

    Replaces `pallas_engine.select_rows_pallas` (ops/pallas_engine.py).
    Source: csrc/select_rows.cu.  On the H100 it is bound by device
    memory: 12 bytes per cell (dest, one gathered word, the result),
    12.6 MB at 1024^2; the gathered words of neighbouring cells lie on
    different planes and do not coalesce.  Design: one thread per cell,
    one indexed load, where the TPU kernel streamed the whole stack."""
    return _SelectRows.apply(sdir4, dest)


# ---- ordered scatter-add --------------------------------------------------

def ordered_add_rows(base, idx, vals):
    """`ordered_add` over R rows: base f32 [R, T], idx int64 [R, n],
    vals f32 [R, n] -> f32 [R, T], each row base with vals added at idx
    in update order (indices outside [0, T) dropped).

    No TPU kernel: the JAX package adds with XLA's scatter
    (`food.at[sb].add(give)`, ops/engine.py `_post_move`), which on the
    CPU folds duplicates in update order; an atomic scatter on the card
    would not.  Source: csrc/ordered_add.cu.  Bound by launch latency.
    Design: one thread per target walks the row's updates in order."""
    if not _on_cuda(base):
        return ordered_add_plain(base, idx, vals)
    R, T = base.shape
    n = idx.shape[1]
    dev = base.device
    _check("base", base, torch.float32, (R, T), dev)
    _check("idx", idx, torch.int64, (R, n), dev)
    _check("vals", vals, torch.float32, (R, n), dev)
    out = torch.empty_like(base)
    if R == 0 or T == 0:
        return out
    _call("tsim_ordered_add", _ptr(base), _ptr(idx), _ptr(vals), _ptr(out),
          ctypes.c_int(R), ctypes.c_int(T), ctypes.c_int(n), _stream(dev))
    launches["ordered_add"] += 1
    return out


class _OrderedAdd(_Kernel):
    @staticmethod
    def forward(base, idx, vals):
        return ordered_add_rows(base, idx, vals)

    @staticmethod
    def vmap(info, in_dims, base, idx, vals):
        B = info.batch_size
        b, i, v = (_front(x, d, B) for x, d in zip((base, idx, vals),
                                                   in_dims))
        out = ordered_add_rows(b.reshape(-1, b.shape[-1]),
                               i.reshape(-1, i.shape[-1]),
                               v.reshape(-1, v.shape[-1]))
        return out.reshape(b.shape), 0


def ordered_add(base, idx, vals):
    """base [R, T] f32 plus vals [R, n] at idx [R, n] in update order
    (`ordered_add_rows`; under vmap one launch for all worlds' rows)."""
    return _OrderedAdd.apply(base, idx, vals)


# ---- rain clouds -----------------------------------------------------------

def rain_ticks_batched(clouds, active, cooldown, spawn, want_cd, cool: int):
    """The clouds' tick loop of `agents/rain.step_rain_ticks` for B
    worlds: clouds f32 [B, 9, R] (the cloud table), active bool [B, R],
    cooldown int32 [B], spawn f32 [B, 9, n], want_cd int32 [B, n] ->
    (the table after each tick f32 [B, n, 9, R], the active flags after
    each tick bool [B, n, R], the final cooldown int32 [B]).

    No TPU kernel: the JAX package steps rain with XLA ops per tick
    (`agents/rain.step_rain`).  Source: csrc/rain.cu.  Bound by launch
    latency (a few clouds per world).  Design: one thread per world
    walks the ticks in order; one launch for a segment of ticks and a
    batch of worlds, where the plain version issues ~20 ops a tick."""
    if not _on_cuda(clouds):
        from ..agents.rain import cloud_ticks_plain
        outs = [cloud_ticks_plain(*w, cool) for w in zip(
            clouds, active, cooldown, spawn, want_cd)]
        return tuple(torch.stack(o) for o in zip(*outs))
    B, _, R = clouds.shape
    n = spawn.shape[-1]
    dev = clouds.device
    _check("clouds", clouds, torch.float32, (B, 9, R), dev)
    _check("active", active, torch.bool, (B, R), dev)
    _check("cooldown", cooldown, torch.int32, (B,), dev)
    _check("spawn", spawn, torch.float32, (B, 9, n), dev)
    _check("want_cd", want_cd, torch.int32, (B, n), dev)
    seen = torch.empty((B, n, 9, R), dtype=torch.float32, device=dev)
    seen_a = torch.empty((B, n, R), dtype=torch.bool, device=dev)
    cd = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0 or n == 0:
        return seen, seen_a, cooldown.clone()
    _call("tsim_rain_ticks", _ptr(clouds), _ptr(active), _ptr(cooldown),
          _ptr(spawn), _ptr(want_cd), _ptr(seen), _ptr(seen_a), _ptr(cd),
          ctypes.c_int(B), ctypes.c_int(n), ctypes.c_int(R),
          ctypes.c_int(cool), _stream(dev))
    launches["rain_ticks"] += 1
    return seen, seen_a, cd


class _RainTicks(_Kernel):
    @staticmethod
    def forward(clouds, active, cooldown, spawn, want_cd, cool):
        out = rain_ticks_batched(
            clouds.contiguous()[None], active.contiguous()[None],
            cooldown.reshape(1), spawn.contiguous()[None],
            want_cd.contiguous()[None], cool)
        return out[0][0], out[1][0], out[2][0]

    @staticmethod
    def vmap(info, in_dims, clouds, active, cooldown, spawn, want_cd, cool):
        B = info.batch_size
        args = [_front(x, d, B) for x, d in zip(
            (clouds, active, cooldown, spawn, want_cd), in_dims[:5])]
        return rain_ticks_batched(*args, cool), (0, 0, 0)


def rain_ticks(clouds, active, cooldown, spawn, want_cd, cool: int):
    """One world's clouds over n ticks (`rain_ticks_batched` with B = 1;
    under vmap one launch for all worlds): clouds f32 [9, R], active
    bool [R], cooldown int32 [], spawn f32 [9, n], want_cd int32 [n] ->
    (f32 [n, 9, R], bool [n, R], int32 [])."""
    return _RainTicks.apply(clouds, active, cooldown, spawn, want_cd, cool)


# ---- K9 --------------------------------------------------------------------

# the kernel's inputs in its pointer order: (name, dtype, shape) with the
# symbols H, W, D4, R, G, L, NQ (queue runs), NS (stop runs)
_MEGA_IN = (
    ("sdir4", "i", ("D4", "H", "W")), ("wnd", "i", ("H", "W")),
    ("inter", "b", ("H", "W")), ("g_destid", "i", ("H", "W")),
    ("g_destkind1", "i", ("H", "W")), ("g_nexit", "i", ("H", "W")),
    ("g_exitcell", "i", ("H", "W")), ("b_mask", "i", ("H", "W")),
    ("b_ok", "i", ("H", "W")), ("b_bid", "i", ("H", "W")),
    ("b_svcdest", "i", ("H", "W")), ("b_needs", "i", ("H", "W")),
    ("b_prod", "i", ("H", "W")), ("b_inner", "f", ("H", "W")),
    ("b_fcap", "f", ("H", "W")), ("b_wcap", "f", ("H", "W")),
    ("qrun", "i", ("NQ", 6)), ("srun", "i", ("NS", 5)),
    ("l_group", "i", ("L",)), ("l_axis", "i", (1, "L")),
    ("gg_valid", "i", (1, "G")), ("nbr", "i", ("G", 4)),
    ("ticks", "i", ("R", 8)), ("elapsed", "f", ("R",)),
    ("rain", "b", ("R", "H", "W")), ("spawn_pa", "i", ("R", "H", "W")),
    ("spawn_pe", "i", ("R", "H", "W")), ("force", "i", ("L",)),
    ("pa", "i", ("H", "W")), ("pb", "i", ("H", "W")),
    ("pc", "i", ("H", "W")), ("pd", "i", ("H", "W")),
    ("pe", "i", ("H", "W")), ("pl", "f", ("H", "W")),
    ("food", "f", ("H", "W")), ("waste", "f", ("H", "W")),
    ("frem", "f", ("H", "W")), ("wrem", "f", ("H", "W")),
    ("li", "i", (9, "G")), ("lf", "f", (2, "G")), ("lstop", "b", ("L",)))
_DT = {"i": torch.int32, "f": torch.float32, "b": torch.bool}
MEGA_OUTPUTS = ("pa", "pb", "pc", "pd", "pe", "pl", "stop", "food", "waste",
                "frem", "wrem", "li", "lf", "lstop", "stats")
_ALGO_ID = {"DISABLED": 0, "FIXED_TIME": 1, "QUEUE_ACTUATED": 2,
            "PRESSURE_CONTROL": 3, "NEIGHBOR_PRESSURE_CONTROL": 4,
            "NEIGHBOR_GREEN_WAVE": 5}


def _mega_params(cfg: Config, dims: dict):
    ip_dm, fp_dm = _dm_params(cfg)
    ip = (ctypes.c_int * 34)(
        *ip_dm, *(dims[k] for k in ("H", "W", "D4", "R", "G", "L", "NQ",
                                    "NS")),
        _ALGO_ID[cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM],
        cfg.TRAFFIC_LIGHT_GREEN_DURATION,
        cfg.TRAFFIC_LIGHT_QUEUE_ACTUATED_MIN_GREEN,
        cfg.TRAFFIC_LIGHT_QUEUE_ACTUATED_GAP,
        cfg.TRAFFIC_LIGHT_QUEUE_ACTUATED_MAX_GREEN,
        int(cfg.TRAFFIC_LIGHT_TRANSITION_DURATION_ENABLED),
        int(cfg.TRAFFIC_LIGHT_TRANSITION_CLEARANCE_ENABLED),
        cfg.SERVICE_VEHICLE_LOAD_TIME,
        int(cfg.GRADUAL_CITY_BLOCK_RESOURCES),
        cfg.VEHICLE_MIN_SPEED)
    # f32 constants as the plain version rounds them
    fp = (ctypes.c_float * 7)(
        *fp_dm, float(cfg.TIME_PER_STEP_IN_SECONDS),
        float(cfg.SERVICE_VEHICLE_MAX_LOAD_FOOD),
        float(cfg.SERVICE_VEHICLE_MAX_LOAD_WASTE),
        float(np.float32(1.0 / cfg.FOOD_CONSUMPTION_TICKS)),
        float(np.float32(1.0 / cfg.WASTE_PRODUCTION_TICKS)))
    return ip, fp


def check_mega_inputs(a: dict) -> dict:
    """Raise unless `a` holds every input K9 takes, each of its dtype,
    shape and device, and contiguous; returns the dimensions."""
    H, W = a["pa"].shape
    dims = {"H": H, "W": W, "D4": a["sdir4"].shape[0],
            "R": a["ticks"].shape[0], "G": a["li"].shape[1],
            "L": a["lstop"].shape[0], "NQ": a["qrun"].shape[0],
            "NS": a["srun"].shape[0]}
    for name, dt, shape in _MEGA_IN:
        _check(name, a[name], _DT[dt], [dims.get(s, s) for s in shape],
               a["pa"].device)
    return dims


def _mega_kernel(cfg: Config, a: dict) -> dict:
    """Launch K9 on the card: one cooperative launch for the R ticks."""
    dims = check_mega_inputs(a)
    H, W, R, G = dims["H"], dims["W"], dims["R"], dims["G"]
    dev = a["pa"].device
    i32t, f32t, u8 = torch.int32, torch.float32, torch.bool

    def planes(n, dtype):
        return [torch.empty((H, W), dtype=dtype, device=dev)
                for _ in range(n)]
    sets = [planes(5, i32t) + planes(1, f32t) for _ in range(2)]
    stop = torch.empty((H, W), dtype=u8, device=dev)
    tanks = planes(4, f32t)
    li = [torch.empty((9, G), dtype=i32t, device=dev) for _ in range(2)]
    lf = [torch.empty((2, G), dtype=f32t, device=dev) for _ in range(2)]
    lstop = torch.empty_like(a["lstop"])
    stats = torch.empty((R, 16), dtype=f32t, device=dev)
    # at most 8 resident blocks of 256 threads per SM
    nbmax = torch.cuda.get_device_properties(dev).multi_processor_count * 8
    scratch = [torch.empty((_N_SCRATCH_DM, H, W), dtype=i32t, device=dev),
               torch.zeros((G * 5,), dtype=i32t, device=dev),
               torch.empty((G,), dtype=i32t, device=dev),
               torch.zeros((H, W), dtype=u8, device=dev),
               torch.empty((2 * nbmax * 6,), dtype=i32t, device=dev),
               torch.empty((R * nbmax * 16,), dtype=i32t, device=dev),
               torch.empty((R * nbmax * 4,), dtype=f32t, device=dev)]
    bufs = [a[n] for n, _, _ in _MEGA_IN] + sets[0] + sets[1] + [
        stop, *tanks, *li, *lf, lstop, stats, *scratch]
    ptrs = (ctypes.c_void_p * len(bufs))(*[t.data_ptr() for t in bufs])
    ip, fp = _mega_params(cfg, dims)
    _call("tsim_mega_segment", ctypes.cast(ip, ctypes.c_void_p),
          ctypes.cast(fp, ctypes.c_void_p), ctypes.cast(ptrs,
                                                        ctypes.c_void_p),
          ctypes.c_int(len(bufs)), ctypes.c_int(nbmax), _stream(dev))
    launches["mega"] += 1
    # tick t writes plane set t & 1 and light buffer (t + 1) & 1
    fin = sets[(R - 1) & 1]
    return dict(zip(MEGA_OUTPUTS, (*fin, stop, *tanks, li[R & 1],
                                   lf[R & 1], lstop, stats)))


class _MegaSegment(_Kernel):
    @staticmethod
    def forward(cfg, names, *tensors):
        a = dict(zip(names, tensors))
        if _on_cuda(a["pa"]):
            out = _mega_kernel(cfg, a)
        else:
            from .megakernel import segment_plain
            out = segment_plain(cfg, a)
        return tuple(out[k] for k in MEGA_OUTPUTS)

    @staticmethod
    def vmap(info, in_dims, cfg, names, *tensors):
        out = _map_worlds(
            lambda *t: _MegaSegment.forward(cfg, names, *t),
            info.batch_size, in_dims[2:], tensors)
        return out, (0,) * len(MEGA_OUTPUTS)


def mega_segment(cfg: Config, args: dict) -> dict:
    """K9, one routing segment of R ticks on the card: `args` holds the
    chunk tables (`megakernel.build_chunk_static`), the segment's next-move
    stack and wavefronts, its streams and the carried state, as
    `megakernel.segment_plain` takes them; returns its outputs
    (`MEGA_OUTPUTS`).  Under vmap the worlds run one after another (a
    batched K9 is later work).

    Replaces `megakernel.run_segment_mega`'s `pallas_call` (`_mega_kernel`,
    ops/megakernel.py).  Source: csrc/megakernel.cu.  On the H100 the
    ticks' device-memory bytes bound it (per tick K1's ~30 int32 planes
    per sub-round and the packed stack's gathered words; the 40 MB stack
    and the ~10 MB of planes about fill the 50 MB L2), behind the grid
    barriers' latency (18 per tick).  Design: one cooperative launch
    sized to the card's resident blocks; each stage is a grid-stride loop
    over runs, groups, lights or cells, separated by grid-wide barriers;
    K1's phase bodies are shared device functions; reductions use
    per-block partials in a fixed order, so a rerun gives the same bits."""
    names = tuple(args)
    outs = _MegaSegment.apply(cfg, names, *args.values())
    return dict(zip(MEGA_OUTPUTS, outs))
