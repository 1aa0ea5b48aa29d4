"""The tick's hand-written Hopper kernels, each beside its plain PyTorch
version (the counterpart of the JAX package's `ops/pallas_engine.py`).

  K1 `decide_move`         <- pallas_engine.decide_move_pallas (+ _kernel,
                              decide_move_core): every tick; under
                              hierarchical routing K1-hier
                              (`decide_move(..., hier=)`, the hier
                              select in the kernel); for many small
                              worlds one block a world (`k1_form`)
  K2 `build_sdir`          <- pallas_engine.build_sdir_pallas (_sdir_body):
                              once per routing segment of one world
  K3 `build_wavefront`     <- pallas_engine.build_wavefront_pallas
                              (wavefront_core): once per routing segment
  K4 `prefix_planes`       <- pallas_engine.prefix_planes_pallas
                              (_prefix_kernel): every tick
  K5 `build_sdir_batched`  <- pallas_engine.build_sdir_pallas_batched
                              (_sdir_kernel_batched): once per routing
                              segment of a shared-geometry batch
  K6 `select_rows`         <- pallas_engine.select_rows_pallas: the
                              selects of `ops/hier.hier_select`, the
                              plain version of K1-hier's; on no path
  K7 `decide_move_tiled`   <- pallas_engine.decide_move_tiled: K1's
                              function over halo-tiled windows; on no
                              path (`step_engine` never picks it, as
                              JAX's `pick_tile` never returns a tile)
  K9 `mega_segment`        <- megakernel.run_segment_mega (_mega_kernel):
                              one launch per routing segment under the
                              megakernel gate (`ops/megakernel.py`), for
                              one world or a whole batch; for many small
                              worlds one block a world (`k9_form`)
  `ordered_add`            the service FSM's f32 scatter-add into the
                           block tanks, in update order (no TPU kernel:
                           the JAX package leaves it to XLA's scatter)
  `rain_ticks`             the rain clouds' tick loop (no TPU kernel: the
                           JAX package steps rain in XLA ops per tick)
  `step_pedestrians`       one tick of the pedestrian count planes (no
                           TPU kernel: XLA ops per tick in the JAX
                           package); every tick while pedestrians are on

Dispatch: a wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel (built from `csrc/` by `ops/build.py`)
or raises.  There is no fallback from one to the other.  `launches`
counts, per kernel, the wrapper calls that launched it (K1's two forms
apart: "decide_move" its cooperative kernel, "decide_move_blocks" its
block-per-world kernel, which the wrapper chooses by shape,
`k1_form`; K9's two forms apart too: "mega" its cooperative kernel,
"mega_worlds" its block-per-world kernel, `k9_form`).

Batches.  K1, K2 (`build_sdir_stacks`), K3, K4, `ordered_add`,
`rain_ticks` and `step_pedestrians` take a leading batch of worlds
(`*_batched`; one launch per batch); the geometry that K1, K2, K3 and
`step_pedestrians` read (intersection and dest_id, the key stack and
legality planes, allowed and is_road, cell_type) is either shared by the
batch or one plane a world (config #4's batch of different cities).  The
single-world wrappers are the B = 1 call.  They have a
`torch.autograd.Function` with a `vmap` rule (K1, K3, K4, `ordered_add`,
`rain_ticks` and `step_pedestrians` take it only while a functorch
transform is active, and
otherwise launch directly), the counterpart of the batching rules that
`jax.vmap` finds for the Pallas kernels: under `torch.func.vmap` (the
world batches of `parallel/mesh.py`) each launches its batched kernel
once for the whole batch, whichever of its arguments are batched.  A
vmapped `build_sdir` whose key stack and legality planes are shared goes
to K5, which reads the key stack once for the batch; any other goes to
the batched K2.  K9's rule launches once for the batch too
(`mega_segment_batched`), its shared chunk tables read with world
stride 0, in one of two forms by shape (`k9_form`).

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

launches = {"decide_move": 0, "decide_move_blocks": 0, "build_sdir": 0,
            "build_sdir_batched": 0, "build_wavefront": 0,
            "prefix_planes": 0, "ordered_add": 0,
            "select_rows": 0, "mega": 0, "mega_worlds": 0,
            "rain_ticks": 0,
            "decide_move_tiled": 0, "render": 0, "step_pedestrians": 0}


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
    words = []
    GB = 32                                     # words per block
    for g0 in range(0, D4, GB):
        g1 = min(D4, g0 + GB)
        word = torch.zeros((g1 - g0, H, W), dtype=torch.int32, device=dev)
        for k in range(4):
            rows = torch.arange(4 * g0 + k, 4 * g1, 4, device=dev)
            rows = rows[rows < D]
            # rows past D decode to 7 (out of place, so that vmap runs it)
            enc = torch.full((g1 - g0 - rows.numel(), H, W), 7,
                             dtype=torch.int32, device=dev)
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
                enc = torch.cat([e.to(torch.int32), enc])
            word = word | (enc << (8 * k))
        words.append(word)
    return torch.cat(words)


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


def _bdim(t, dims: int):
    """vmap's in_dim of `t`: 0 where it carries a batch dim ahead of its
    `dims` trailing dims, None where the batch shares it."""
    return 0 if t.dim() > dims else None


def decide_move_core_batched(cfg: Config, sdir4, wnd, planes, stop_map,
                             rain_map, ped_block, intersection, dest_id,
                             randoms):
    """Plain version of the batched K1: `decide_move_core` on every world
    (under `torch.func.vmap`); every argument carries a leading B, and
    the geometry `intersection` and `dest_id` is [B, H, W] or shared
    [H, W].  Returns the 7 outputs, each [B, H, W]."""
    dims = ((0,) * 11 + (_bdim(intersection, 2), _bdim(dest_id, 2))
            + (0,) * 4)
    return torch.func.vmap(lambda *a: decide_move_core(cfg, *a),
                           in_dims=dims)(
        sdir4, wnd, *planes, stop_map, rain_map, ped_block, intersection,
        dest_id, *randoms)


def wavefront_core_batched(cfg: Config, allowed, is_road, hard):
    """Plain version of the batched K3: `wavefront_core` on every world
    of `hard` [B, H, W] (under vmap); the geometry `allowed` and
    `is_road` is [B, H, W] or shared [H, W]."""
    return torch.func.vmap(lambda *a: wavefront_core(cfg, *a), in_dims=(
        _bdim(allowed, 2), _bdim(is_road, 2), 0))(allowed, is_road, hard)


def sdir_encode_batched(K0, pen4b, legal4, tp2: int) -> torch.Tensor:
    """Plain version of K5 and of the batched K2: K2's encode on every
    world of pen4b [B, 4, H, W] (under vmap), over the key stack K0
    [B, D, 4, H, W] or shared [D, 4, H, W] and the legality planes
    legal4 [B, 4, H, W] or shared [4, H, W]; [B, ceil(D/4), H, W]."""
    return torch.func.vmap(lambda k, p, lg: sdir_encode(k, p, lg, tp2),
                           in_dims=(_bdim(K0, 4), 0, _bdim(legal4, 3)))(
        K0, pen4b, legal4)


def prefix_planes_plain(occ: torch.Tensor):
    """Plain version of K4: row- and column-inclusive prefix sums of an
    int32 plane [..., H, W], (incH, incV)."""
    return (torch.cumsum(occ, -1, dtype=torch.int32),
            torch.cumsum(occ, -2, dtype=torch.int32))


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """f32 x with every subnormal value replaced by a zero of its sign,
    as a flush-to-zero / denormals-are-zero unit reads or writes it."""
    b = x.view(torch.int32)
    return torch.where((b & 0x7F800000) == 0, b & -(1 << 31),
                       b).view(torch.float32)


def ordered_add_plain(base, idx, vals) -> torch.Tensor:
    """Plain version of `ordered_add`: per row r, base[r] with vals[r, i]
    added at idx[r, i] (int64) in update order, as XLA's CPU scatter-add
    folds duplicates; indices outside [0, T) are dropped.  XLA's CPU
    runtime adds with subnormals flushed to zero (inputs and results, the
    sign kept), so this folds step by step: step k adds the k-th update
    of every target at once, flushing both operands and the sum.  A
    target that no update reaches keeps its base bits."""
    T = base.shape[-1]
    b = base.reshape(-1, T)
    R = b.shape[0]
    i = idx.reshape(-1, idx.shape[-1])
    v = vals.reshape(-1, vals.shape[-1])
    keep = (i >= 0) & (i < T)
    rows = torch.arange(R, device=base.device)[:, None]
    tgt = (rows * T + i)[keep]                      # in update order
    val = flush_subnormal(v[keep].contiguous())
    acc = b.reshape(-1).clone()
    touched = torch.zeros_like(acc, dtype=torch.bool)
    touched[tgt] = True
    acc = torch.where(touched, flush_subnormal(acc), acc)
    # each update's rank among the updates of its target, in update order
    order = torch.sort(tgt, stable=True).indices
    tgt, val = tgt[order], val[order]
    counts = torch.bincount(tgt, minlength=acc.numel())
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tgt.numel(), device=base.device) - first[tgt]
    by_rank = torch.sort(rank, stable=True).indices
    sizes = torch.bincount(rank).tolist() if rank.numel() else []
    at = 0
    for size in sizes:
        sel = by_rank[at:at + size]
        t = tgt[sel]
        acc[t] = flush_subnormal(acc[t] + val[sel])
        at += size
    return acc.reshape(base.shape)


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


def _check_rc(entry, rc):
    if rc != 0:
        from . import build
        raise RuntimeError(f"{entry}: CUDA error {rc} "
                           f"({build.error_string(rc)})")


def _call(entry, *args):
    from . import build
    _check_rc(entry, getattr(build.load(), entry)(*args))


_entries = {}             # kernel entry points, resolved at first launch


def _entry(name: str):
    """The kernel library's entry point `name`, resolved once (the lean
    wrappers call it with Python ints for pointers)."""
    fn = _entries.get(name)
    if fn is None:
        from . import build
        fn = _entries[name] = getattr(build.load(), name)
    return fn


# ---- vmap rules ------------------------------------------------------------

def _front(x, bdim, B):
    """x with its batch dim first, or broadcast to B worlds when the
    vmapped call shares it (contiguous either way)."""
    if bdim is None:
        return x.unsqueeze(0).expand(B, *x.shape).contiguous()
    return x.movedim(bdim, 0).contiguous()


class _Kernel(torch.autograd.Function):
    """A kernel wrapper as an autograd.Function: `forward` is the
    single-world wrapper, `vmap` the rule under torch.func.vmap.  No
    gradients."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


# ---- K1 --------------------------------------------------------------------

_N_WORK_K1 = 8            # K1's, K7's and K9's int32 working planes per
                          # world, then a byte per cell (csrc/coop.cuh)


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


_dm_last = [None, None]   # the last Config K1 ran with, and its params


def _dm_params_of(cfg: Config):
    """`_dm_params(cfg)`, kept for the last Config object (hashing a
    Config costs more than building the arrays)."""
    if _dm_last[0] is not cfg:
        _dm_last[:] = [cfg, _dm_params(cfg)]
    return _dm_last[1]


def _dm_check(sdir4, wnd, planes, masks, intersection, dest_id, randoms,
              local4=None):
    """Raise unless K1's arguments are what its kernel takes: int32 /
    f32 / bool, contiguous, on one card; the per-world tensors of one
    shape [(B,) H, W], the stacks [(B,) D4, H, W], the geometry
    `intersection` and `dest_id` both [H, W] or both [B, H, W]."""
    pa = planes[0]
    dev, shape = pa.device, tuple(pa.shape)
    i32t, f32t, bt = torch.int32, torch.float32, torch.bool
    _check("sdir4", sdir4, i32t, (*shape[:-2], sdir4.shape[-3], *shape[-2:]),
           dev)
    if local4 is not None:
        _check("local4", local4, i32t, (local4.shape[0], *shape), dev)
    for name, t, dt in (("wnd", wnd, i32t), ("pa", pa, i32t),
                        ("pb", planes[1], i32t), ("pc", planes[2], i32t),
                        ("pd", planes[3], i32t), ("pe", planes[4], i32t),
                        ("pl", planes[5], f32t), ("stop_map", masks[0], bt),
                        ("rain_map", masks[1], bt),
                        ("ped_block", masks[2], bt),
                        ("r_mal", randoms[0], f32t),
                        ("r_side", randoms[1], f32t),
                        ("r_reroll", randoms[2], i32t),
                        ("r_prio", randoms[3], i32t)):
        _check(name, t, dt, shape, dev)
    geo = shape if intersection.dim() == 3 else shape[-2:]
    _check("intersection", intersection, bt, geo, dev)
    _check("dest_id", dest_id, i32t, geo, dev)


# K1's block-per-world form (csrc/decide_move.cu `dm_worlds`): an H x W
# world is ceil(H / 8) x ceil(W / 32) tiles of 32 x 8 cells, at most
# K1_MAX_TILES (csrc/coop.cuh MAX_CPT); its block's shared memory holds 8
# bytes a tile cell (the state words and the work list) and 5 a world
# cell (the key word and the pub byte), beside K1_WORLD_STATIC bytes of
# static shared memory (the tile table and the list length)
K1_TILE_H, K1_TILE_W, K1_THREADS = 8, 32, 256
K1_MAX_TILES = 64
K1_WORLD_STATIC = 64 * 12 + 4
# the shared memory CUDA reserves a block; an SM's shared memory is
# the most a block may take plus this reserve (H100: 232,448 + 1,024)
K1_BLOCK_RESERVED = 1024
# the fewest worlds an SM from which the block-per-world form is taken,
# and the fewest of its blocks that must fit an SM at once: on the H100
# at 64 x 64 (`chip_smoke.py --only forms`, PERF.md section 6) it was
# behind the cooperative form at 132 worlds on seeded planes (0.118
# against 0.093 device ms), even at 264 (0.173 against 0.177) and ahead
# from 528 (1024: 0.514 against 0.648), and ahead from 132 on config #4's
# own state (1024: 0.237 against 0.366); a world whose block leaves room
# for fewer blocks an SM was not measured
K1_WORLDS_PER_SM = 2


def k1_world_tiles(H: int, W: int) -> int:
    return -(-H // K1_TILE_H) * -(-W // K1_TILE_W)


def k1_world_smem(H: int, W: int) -> int:
    """Dynamic shared memory bytes of the block that owns an H x W world
    (csrc/coop.cuh `world_smem`)."""
    return k1_world_tiles(H, W) * K1_THREADS * 8 + H * W * 5


def k1_world_blocks_per_sm(H: int, W: int, smem_per_block: int) -> int:
    """How many blocks of the block-per-world form the shared memory of
    one SM holds at once for H x W worlds (0: one world is more than a
    block may take)."""
    need = k1_world_smem(H, W) + K1_WORLD_STATIC
    if need > smem_per_block:
        return 0
    return (smem_per_block + K1_BLOCK_RESERVED) // (need + K1_BLOCK_RESERVED)


def k1_form(B: int, H: int, W: int, n_sm: int, smem_per_block: int) -> str:
    """K1's form for B worlds of H x W on a card with `n_sm` SMs and
    `smem_per_block` bytes of shared memory a block may take: "worlds"
    (one block owns one world, block barriers) where one world fits one
    block, K1_WORLDS_PER_SM of those blocks fit one SM, and the batch
    fills the card (at least K1_WORLDS_PER_SM worlds an SM), else "coop"
    (the cooperative grid; its world groups where the tiles outnumber one
    resident grid).  A function of the shape alone: the H100's numbers
    are 132 SMs and 232,448 bytes."""
    fits = (k1_world_tiles(H, W) <= K1_MAX_TILES
            and k1_world_blocks_per_sm(H, W, smem_per_block)
            >= K1_WORLDS_PER_SM)
    return "worlds" if fits and B >= K1_WORLDS_PER_SM * n_sm else "coop"


_card = {}                # device index -> (SMs, shared memory a block)


def card_numbers(device=None) -> tuple:
    """(SMs, shared memory bytes a block may take) of the card, read
    once a device."""
    idx = torch.device("cuda" if device is None else device).index
    idx = torch.cuda.current_device() if idx is None else idx
    got = _card.get(idx)
    if got is None:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(idx):
            _check_rc("tsim_card_numbers", _entry("tsim_card_numbers")(
                ctypes.addressof(out)))
        got = _card[idx] = (out[0], out[1])
    return got


_k1_forms = {}            # (device index, B, H, W) -> k1_form's choice


def _k1_form_on(dev, B: int, H: int, W: int) -> str:
    k = (dev.index, B, H, W)
    form = _k1_forms.get(k)
    if form is None:
        form = _k1_forms[k] = k1_form(B, H, W, *card_numbers(dev))
    return form


def _dm_launch(cfg: Config, sdir4, wnd, planes, masks, intersection,
               dest_id, randoms, hier=None, form=None):
    """One K1 launch over checked tensors on the card, [H, W] or
    [B, H, W] per world, the geometry shared or one plane a world
    (K1-hier with `hier` = (local4, its 10 constants), one world), in
    the form `form` ("worlds" or "coop"; None: `k1_form`'s choice): (pa,
    pb, pc, pd, pe, pl, flags), views of one allocation."""
    pa = planes[0]
    H, W = pa.shape[-2:]
    B = pa.shape[0] if pa.dim() == 3 else 1
    dev = pa.device
    out = torch.empty((7, *pa.shape), dtype=torch.int32, device=dev)
    n = B * H * W
    work = torch.empty(n * _N_WORK_K1 + (n + 3) // 4, dtype=torch.int32,
                       device=dev)
    o, step = out.data_ptr(), pa.numel() * 4
    ip, fp = _dm_params_of(cfg)
    args = (sdir4.data_ptr(), sdir4.shape[-3], wnd.data_ptr(),
            *[p.data_ptr() for p in planes],
            *[m.data_ptr() for m in masks], intersection.data_ptr(),
            dest_id.data_ptr(), *[r.data_ptr() for r in randoms],
            *[o + k * step for k in range(7)], work.data_ptr())
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if hier is None:
        if form is None:
            form = _k1_form_on(dev, B, H, W)
        entry = ("tsim_decide_move_worlds" if form == "worlds"
                 else "tsim_decide_move")
        rc = _entry(entry)(ip, fp, *args, B, H, W,
                           int(intersection.dim() == 3), stream)
    else:
        local4, consts = hier
        entry = "tsim_decide_move_hier"
        rc = _entry(entry)(ip, fp, (ctypes.c_int * 10)(*consts),
                           local4.data_ptr(), local4.shape[0], *args, H, W,
                           stream)
    _check_rc(entry, rc)
    launches["decide_move_blocks" if form == "worlds" else "decide_move"] += 1
    outs = out.unbind(0)
    return (*outs[:5], outs[5].view(torch.float32), outs[6])


def decide_move_batched(cfg: Config, sdir4, wnd, planes, stop_map, rain_map,
                        ped_block, intersection, dest_id, randoms,
                        form=None):
    """K1 for a batch of B worlds: every argument carries a leading B;
    the geometry `intersection` and `dest_id` is both shared [H, W] or
    both one plane a world [B, H, W] (a batch of different cities,
    config #4; the vmap rule broadcasts a shared one beside a batched
    one).  `form`: None chooses by shape (`k1_form`); "worlds" or "coop"
    takes that form (to measure one against the other; "worlds" fails
    where a world does not fit one block).
    Returns (pa, pb, pc, pd, pe, pl, flags), each [B, H, W].

    Replaces `pallas_engine.decide_move_pallas` (`_kernel` ->
    `decide_move_core`, ops/pallas_engine.py; batched by `jax.vmap`
    through the Pallas batching rule).  Source: csrc/decide_move.cu.  On
    the H100 the function is bound by device-memory bytes (~80 B a
    cell); the phase chain of a tick (decide, K x (intent, commit),
    finish) by its dependent steps.  Design: one cooperative launch, a
    persistent grid whose blocks own fixed 32 x 8 tiles of cells in every
    phase, grid barriers between the phases; what only a cell itself
    reads (the decide aux word, halt, moved, presence, the intent it
    last published) stays in one register per cell, and the phases
    write a cell's working planes, keys and info words only where they
    change.  A batch with more tiles than one resident grid holds runs
    as world groups, one after another inside the same launch
    (`dm_plan`).  Many small worlds (config #4: 1024 of 64 x 64) take
    the block-per-world form instead (`k1_form`): B ordinary blocks,
    block b owning all of world b's tiles, its keys and pub bytes in
    shared memory for the whole tick, block barriers between the same
    phases.  The wrapper makes one allocation for the seven outputs
    and resolves the entry point once."""
    masks = (stop_map, rain_map, ped_block)
    if not _on_cuda(planes[0]):
        return decide_move_core_batched(cfg, sdir4, wnd, planes, stop_map,
                                        rain_map, ped_block, intersection,
                                        dest_id, randoms)
    if planes[0].dim() != 3:
        raise ValueError(f"pa: shape {tuple(planes[0].shape)}, kernel "
                         "takes [B, H, W]")
    _dm_check(sdir4, wnd, planes, masks, intersection, dest_id, randoms)
    return _dm_launch(cfg, sdir4, wnd, planes, masks, intersection, dest_id,
                      randoms, form=form)


def dm_plan(B: int, H: int, W: int, device=None, form=None) -> dict:
    """K1's plan for B worlds of H x W on the card: its form (`k1_form`'s
    choice, or `form`), tiles a block and blocks of the launch; for the
    cooperative form worlds a group and world groups (one launch walks
    the groups in turn), for the block-per-world form its dynamic and
    static shared memory, registers a thread and resident blocks an
    SM."""
    dev = torch.device("cuda" if device is None else device)
    if form is None:
        form = k1_form(B, H, W, *card_numbers(dev))
    if form == "worlds":
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(dev):
            _check_rc("tsim_dm_worlds_plan", _entry("tsim_dm_worlds_plan")(
                H, W, ctypes.addressof(out)))
        return {"form": form, "tiles_per_block": out[0], "blocks": B,
                "smem_bytes": out[1], "static_smem_bytes": out[2],
                "registers": out[3], "blocks_per_sm": out[4]}
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(dev):
        _check_rc("tsim_dm_plan", _entry("tsim_dm_plan")(
            B, H, W, ctypes.addressof(out)))
    return {"form": form, **dict(zip(
        ("tiles_per_block", "blocks", "worlds_per_group", "groups"), out))}


# argument positions of _DecideMove after cfg: the geometry, which a
# batch may share
_DM_SHARED = (11, 12)       # intersection, dest_id


def _dm_batched(cfg, args):
    (sdir4, wnd, pa, pb, pc, pd, pe, pl, stop_map, rain_map, ped_block,
     intersection, dest_id, r_mal, r_side, r_reroll, r_prio) = args
    return decide_move_batched(cfg, sdir4, wnd, (pa, pb, pc, pd, pe, pl),
                               stop_map, rain_map, ped_block, intersection,
                               dest_id, (r_mal, r_side, r_reroll, r_prio))


def _dm_single(cfg, sdir4, wnd, planes, stop_map, rain_map, ped_block,
               intersection, dest_id, randoms):
    masks = (stop_map, rain_map, ped_block)
    if not _on_cuda(planes[0]):
        return decide_move_core(cfg, sdir4, wnd, *planes, *masks,
                                intersection, dest_id, *randoms)
    if planes[0].dim() != 2:
        raise ValueError(f"pa: shape {tuple(planes[0].shape)}, kernel "
                         "takes [H, W]")
    _dm_check(sdir4, wnd, planes, masks, intersection, dest_id, randoms)
    return _dm_launch(cfg, sdir4, wnd, planes, masks, intersection, dest_id,
                      randoms)


class _DecideMove(_Kernel):
    @staticmethod
    def forward(cfg, *args):
        return _dm_single(cfg, args[0], args[1], args[2:8], *args[8:13],
                          args[13:])

    @staticmethod
    def vmap(info, in_dims, cfg, *args):
        dims = in_dims[1:]
        B = info.batch_size
        # the geometry stays shared only where the batch shares all of it
        geo_shared = all(dims[i] is None for i in _DM_SHARED)
        out = _dm_batched(cfg, [
            a if i in _DM_SHARED and geo_shared else _front(a, d, B)
            for i, (a, d) in enumerate(zip(args, dims))])
        return out, (0,) * 7


def _dm_hier(cfg, consts, sdir4, wnd, planes, stop_map, rain_map,
             ped_block, intersection, dest_id, randoms, local4):
    masks = (stop_map, rain_map, ped_block)
    if not _on_cuda(planes[0]):
        from . import hier

        def select(dest):
            return hier.hier_select(cfg, sdir4, local4, dest)
        return decide_move_core(cfg, sdir4, wnd, *planes, *masks,
                                intersection, dest_id, *randoms,
                                select=select)
    if planes[0].dim() != 2:
        raise ValueError(f"pa: shape {tuple(planes[0].shape)}, kernel "
                         "takes [H, W]")
    if len(consts) != 10:
        raise ValueError(f"hier constants: {len(consts)}, kernel takes 10")
    _dm_check(sdir4, wnd, planes, masks, intersection, dest_id, randoms,
              local4)
    return _dm_launch(cfg, sdir4, wnd, planes, masks, intersection, dest_id,
                      randoms, (local4, consts))


def decide_move(cfg: Config, sdir4, wnd, planes, stop_map, rain_map,
                ped_block, intersection, dest_id, randoms, hier=None):
    """K1 for one world (`decide_move_batched` with B = 1; under vmap one
    batched launch through `_DecideMove`'s rule; no autograd.Function
    otherwise).  Planes pa..pe and `wnd`, `r_prio` are int32 bit
    patterns; masks bool; `pl`, `r_mal`, `r_side` f32; `r_reroll`,
    `dest_id` int32.  Returns (pa, pb, pc, pd, pe, pl, flags int32).

    `hier`: (local4, consts) under hierarchical routing, the windowed
    stack [9 LMAX / 4, H, W] and `ops/hier.kernel_consts(cfg)`; `sdir4`
    is then the dense (hub and direct) stack and the call is K1-hier, K1
    with the hierarchical select (`ops/hier.hier_select`) at each cell.
    Its plain version is `decide_move_core` with `hier_select` as the
    select.  K1-hier replaces what the JAX package runs for such worlds
    (ops/engine.py, the ROUTING_HIER branch of `step_engine`):
    `decide_move_core` in XLA ops with `hier_select`, two
    `select_rows_pallas` calls (K6) per select.  Source:
    csrc/decide_move.cu, `HierSelect` in csrc/decide_move.cuh.  On the
    H100 it is bound, like K1, by device-memory bytes (K1's planes, plus
    one gathered word of each stack per select) and by its phase chain.
    Design: K1's cooperative launch and phase bodies with the select
    functor `HierSelect`, which decodes the rid with host-checked magic
    divisions and makes one gathered load from each stack.  One world
    only (no vmap rule): the hierarchical config is never batched; the
    batched K1 and K9 select with `GridSelect`."""
    if hier is not None:
        local4, consts = hier
        return _dm_hier(cfg, tuple(consts), sdir4, wnd, planes, stop_map,
                        rain_map, ped_block, intersection, dest_id, randoms,
                        local4)
    if torch._C._are_functorch_transforms_active():
        return _DecideMove.apply(cfg, sdir4, wnd, *planes, stop_map,
                                 rain_map, ped_block, intersection, dest_id,
                                 *randoms)
    return _dm_single(cfg, sdir4, wnd, planes, stop_map, rain_map,
                      ped_block, intersection, dest_id, randoms)


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


# K7's window words a cell in device memory beside K1's working planes:
# 12 input planes of 4 bytes and 4 of 1 byte (csrc/decide_tiled.cu)
_N_WIN_K7 = 13


def k7_plan(H: int, W: int, th: int, tw: int, smem_per_block: int) -> tuple:
    """K7's launch for an H x W grid in [th, tw] tiles on a card whose
    block may take `smem_per_block` bytes of shared memory: (blocks,
    tiles a block, dynamic shared memory bytes).  Each tile's window of
    (th + 2P) x (tw + 2P) cells is one block's world in K1's
    block-per-world layout (`k1_world_tiles` tiles of 32 x 8,
    `k1_world_smem` bytes), so a window past K1_MAX_TILES tiles or past
    the block's shared memory raises ValueError: no other form runs it.
    At the H100's 232,448 bytes every window that JAX's `pick_tile`
    budget admits (~14,800 cells) fits where its width is a multiple of
    32; a 160 x 160 window (128 x 128 tiles) takes 100 tiles and does
    not."""
    _check_tiling(H, W, th, tw)
    wh, ww = th + 2 * TILE_HALO, tw + 2 * TILE_HALO
    cpt, smem = k1_world_tiles(wh, ww), k1_world_smem(wh, ww)
    if cpt > K1_MAX_TILES or smem + K1_WORLD_STATIC > smem_per_block:
        raise ValueError(
            f"tile ({th}, {tw}): its {wh} x {ww} window takes {cpt} tiles "
            f"and {smem + K1_WORLD_STATIC} bytes of shared memory, past one "
            f"block ({K1_MAX_TILES} tiles, {smem_per_block} bytes)")
    return (H // th) * (W // tw), cpt, smem


def tiled_plan(H: int, W: int, th: int, tw: int, device=None) -> dict:
    """K7's plan on the card as the kernel's library sees it: `k7_plan`'s
    blocks, tiles a block and dynamic shared memory (the kernel's own
    count of the last two, which must agree), its static shared memory,
    registers a thread and resident blocks an SM."""
    dev = torch.device("cuda" if device is None else device)
    blocks, cpt, smem = k7_plan(H, W, th, tw, card_numbers(dev)[1])
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(dev):
        _check_rc("tsim_decide_tiled_plan", _entry("tsim_decide_tiled_plan")(
            th, tw, TILE_HALO, ctypes.addressof(out)))
    if (out[0], out[1]) != (cpt, smem):
        raise AssertionError(f"K7's plan: the kernel's tiles and shared "
                             f"memory {out[0]}, {out[1]}, k7_plan's {cpt}, "
                             f"{smem}")
    return {"blocks": blocks, "tiles_per_block": cpt, "smem_bytes": smem,
            "static_smem_bytes": out[2], "registers": out[3],
            "blocks_per_sm": out[4]}


def decide_move_tiled(cfg: Config, sdir4, wnd, planes, stop_map, rain_map,
                      ped_block, intersection, dest_id, randoms,
                      th: int, tw: int):
    """K7, K1's decide + move for one world over [th, tw] tiles, each
    run on its window with a TILE_HALO ring (th | H and tw | W).  Takes
    K1's single-world arguments and returns its outputs, bit-equal.

    Replaces `pallas_engine.decide_move_tiled` (its `pallas_call`,
    ops/pallas_engine.py).  Source: csrc/decide_tiled.cu.  On no path:
    `engine.step_engine` runs K1 (dense) or K1-hier (hierarchical), as
    JAX's gate (`pick_tile`) never picks the tiled kernel.  On the H100
    the function is bound by device-memory bytes, K1's (the windows
    re-read (th + 2P)(tw + 2P) / (th tw) of the grid); a call, like
    K1's, by its chain of 2K + 2 dependent phases.  Design: one ordinary
    launch of one 1024-thread block per tile, K1's block-per-world form
    over the windows: the block copies its window (JAX's pad fills
    outside the grid) into device memory and runs K1's phases (csrc/coop.cuh,
    `BlockOwn`) over it as one small world, its keys and pub bytes in
    shared memory, block barriers between phases; the row select reads
    the whole grid's stack at the cell's global coordinate; only the
    interior is written.  A window past one block raises ValueError
    (`k7_plan`)."""
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
    T, _, _ = k7_plan(H, W, th, tw, card_numbers(dev)[1])
    n = (th + 2 * P) * (tw + 2 * P)
    outs = [torch.empty((H, W), dtype=i32t, device=dev) for _ in range(5)]
    out_pl = torch.empty((H, W), dtype=f32t, device=dev)
    flags = torch.empty((H, W), dtype=i32t, device=dev)
    area = torch.empty(T * n * (_N_WIN_K7 + _N_WORK_K1), dtype=i32t,
                       device=dev)
    ip, fp = _dm_params(cfg)
    _check_rc("tsim_decide_tiled", _entry("tsim_decide_tiled")(
        ip, fp, _ptr(sdir4), D4, _ptr(wnd), *[_ptr(p) for p in planes],
        _ptr(stop_map), _ptr(rain_map), _ptr(ped_block), _ptr(intersection),
        _ptr(dest_id), _ptr(r_mal), _ptr(r_side), _ptr(r_reroll),
        _ptr(r_prio), *[_ptr(o) for o in outs], _ptr(out_pl), _ptr(flags),
        _ptr(area), H, W, th, tw, P, _stream(dev)))
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
          ctypes.c_int(1), ctypes.c_int(0), ctypes.c_int(0), _stream(dev))
    launches["build_sdir"] += 1
    return out


def build_sdir_stacks(K0, pen4b, legal4, tp2: int):
    """K2 for B worlds, each with its own next-move stack: pen4b [B, 4,
    H, W] over the key stacks K0 [B, D, 4, H, W] (or one shared [D, 4, H,
    W]) and the legality planes legal4 [B, 4, H, W] (or shared [4, H,
    W]) -> [B, ceil(D/4), H, W] int32.

    Replaces `pallas_engine.build_sdir_pallas` under `jax.vmap` with the
    key stack batched (config #4's cities: the Pallas batching rule makes
    the batch one grid dimension of one `pallas_call`).  Source:
    csrc/sdir.cu (`sdir_kernel`, blockIdx.z the world).  On the H100 it
    is bound by device-memory bytes: every world's key stack read once
    (2 MB a world at config #4: D = 32, 64^2) and its packed stack
    written once.  Design: K2's one thread per cell and run of packed
    words, with a grid dimension for the world and per-world strides
    (0 where an input is shared); K5's sharing of one K0 across the
    worlds of a thread does not apply when every world has its own."""
    if not _on_cuda(pen4b):
        return sdir_encode_batched(K0, pen4b, legal4, tp2)
    B, _, H, W = pen4b.shape
    D = K0.shape[-4]
    dev = pen4b.device
    k0_w, legal_w = int(K0.dim() == 5), int(legal4.dim() == 4)
    _check("K0", K0, torch.int32, (B,) * k0_w + (D, 4, H, W), dev)
    _check("pen4b", pen4b, torch.int32, (B, 4, H, W), dev)
    _check("legal4", legal4, torch.int32, (B,) * legal_w + (4, H, W), dev)
    out = torch.empty((B, (D + 3) // 4, H, W), dtype=torch.int32,
                      device=dev)
    _check_rc("tsim_build_sdir", _entry("tsim_build_sdir")(
        K0.data_ptr(), pen4b.data_ptr(), legal4.data_ptr(), out.data_ptr(),
        D, H * W, int(tp2), B, k0_w, legal_w,
        torch._C._cuda_getCurrentRawStream(dev.index)))
    launches["build_sdir"] += 1
    return out


def build_sdir_batched(K0, pen4b, legal4, tp2: int):
    """K5, the per-segment next-move stacks of B worlds that share the
    key stack K0 [D, 4, H, W] and the legality planes legal4 [4, H, W]:
    pen4b [B, 4, H, W] -> [B, ceil(D/4), H, W] int32.

    Replaces `pallas_engine.build_sdir_pallas_batched`
    (`_sdir_kernel_batched` -> `_sdir_body`, ops/pallas_engine.py).
    Source: csrc/sdir.cu.  On the H100 at B = 16 its floor is the
    integer encode (about 16 operations per key row, cell and world at
    the INT32 rate), with device-memory bytes close behind (K0 read
    once: 637.5 MB at D = 608, 256^2; B packed stacks written: 39.8 MB
    each).  Design: a block stages each packed word's key rows of its
    cells into a shared-memory ring with cp.async ahead of use; its
    threads take 4 worlds each (4 threads share a cell at B = 16), so K0
    leaves device memory once per segment for up to 16 worlds; per key
    row and world, DPX min and add-min, one byte permute for the argmin
    and its contra bit, and byte permutes to pack."""
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
        B = info.batch_size
        if kd is None and ld is None:
            out = build_sdir_batched(K0, _front(pen4, pd, B), legal4, tp2)
        else:
            out = build_sdir_stacks(
                K0 if kd is None else _front(K0, kd, B), _front(pen4, pd, B),
                legal4 if ld is None else _front(legal4, ld, B), tp2)
        return out, 0


def build_sdir(K0, pen4, legal4, tp2: int):
    """K2, the per-segment next-move stack [ceil(D/4), H, W] int32 of one
    world; under vmap with K0 and legal4 shared, K5, and otherwise the
    batched K2 (`build_sdir_stacks`): one launch for the batch either
    way.

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

WAVEFRONT_KMAX = 8        # the most relax steps K3 takes (csrc WF_KMAX)


def _wavefront_launch(k_ovt: int, allowed, is_road, hard, B: int,
                      geo: int = 0):
    """One K3 launch over the B worlds of `hard` ([B, H, W] or [H, W] for
    B = 1; every tensor checked by the caller), the geometry shared
    (geo = 0) or [B, H, W] (geo = 1): the packed planes, shaped as
    `hard`."""
    if not 0 <= k_ovt <= WAVEFRONT_KMAX:
        raise ValueError(f"K3 takes at most {WAVEFRONT_KMAX} relax steps "
                         f"(VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS = {k_ovt})")
    H, W = hard.shape[-2:]
    out = torch.empty(hard.shape, dtype=torch.int32, device=hard.device)
    _check_rc("tsim_build_wavefront", _entry("tsim_build_wavefront")(
        allowed.data_ptr(), is_road.data_ptr(), hard.data_ptr(),
        out.data_ptr(), k_ovt, B, H, W, geo,
        torch._C._cuda_getCurrentRawStream(hard.device.index)))
    launches["build_wavefront"] += 1
    return out


def build_wavefront_batched(cfg: Config, allowed, is_road, hard):
    """K3 for B worlds: `allowed` u8 and `is_road` bool, both shared
    [H, W] or both one plane a world [B, H, W] (a batch of different
    cities, config #4), `hard` bool [B, H, W] -> packed int32 [B, H, W].

    Replaces `pallas_engine.build_wavefront_pallas` (`_wavefront_kernel`
    -> `wavefront_core`, ops/pallas_engine.py).  Source:
    csrc/wavefront.cu.  On the H100 the function is tiny (~5 bytes a
    cell and world; a select and a min per relax step, direction and
    neighbour), so launches and memory round trips bound a step-by-step
    kernel.  Design: one launch a call, a block per tile (32 wide; 32
    high, or 16 where 32 would leave SMs idle) and world; the tile and a
    halo of K_OVT + 1 cells staged in shared memory as geometry bytes,
    the relax steps on the four directions' values in 16-bit lanes in
    shared memory (DPX min-of-three and add-min), then the argmin and
    one int32 store per cell.  K_OVT (VEHICLE_MAX_CONTRAFLOW_OVERTAKE_
    STEPS) may be at most WAVEFRONT_KMAX.  The geometry's world stride
    is a launch argument: 0 where the batch shares it."""
    if not _on_cuda(hard):
        return wavefront_core_batched(cfg, allowed, is_road, hard)
    B, H, W = hard.shape
    dev = hard.device
    geo = int(allowed.dim() == 3)
    _check("allowed", allowed, torch.uint8, (B,) * geo + (H, W), dev)
    _check("is_road", is_road, torch.bool, (B,) * geo + (H, W), dev)
    _check("hard", hard, torch.bool, (B, H, W), dev)
    return _wavefront_launch(cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS,
                             allowed, is_road, hard, B, geo)


def _wavefront_single(cfg: Config, allowed, is_road, hard):
    if not _on_cuda(allowed):
        return wavefront_core(cfg, allowed, is_road, hard)
    dev = allowed.device
    shape = allowed.shape
    if not (allowed.dtype == torch.uint8 and is_road.dtype == torch.bool
            and hard.dtype == torch.bool and len(shape) == 2
            and is_road.shape == shape and hard.shape == shape
            and is_road.device == dev and hard.device == dev
            and allowed.is_contiguous() and is_road.is_contiguous()
            and hard.is_contiguous()):
        # the precise error
        _check("allowed", allowed, torch.uint8, shape[-2:], dev)
        _check("is_road", is_road, torch.bool, shape[-2:], dev)
        _check("hard", hard, torch.bool, shape[-2:], dev)
    return _wavefront_launch(cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS,
                             allowed, is_road, hard, 1)


class _BuildWavefront(_Kernel):
    @staticmethod
    def forward(cfg, allowed, is_road, hard):
        return _wavefront_single(cfg, allowed, is_road, hard)

    @staticmethod
    def vmap(info, in_dims, cfg, allowed, is_road, hard):
        _, ad, rd, hd = in_dims
        B = info.batch_size
        if ad is None and rd is None:
            out = build_wavefront_batched(cfg, allowed, is_road,
                                          _front(hard, hd, B))
        else:
            out = build_wavefront_batched(cfg, _front(allowed, ad, B),
                                          _front(is_road, rd, B),
                                          _front(hard, hd, B))
        return out, 0


def build_wavefront(cfg: Config, allowed, is_road, hard):
    """K3 for one world, the per-segment overtake merge wavefronts,
    packed int32 [H, W] (`build_wavefront_batched` with B = 1: one lean
    launch; under vmap one batched launch, through `_BuildWavefront`'s
    rule)."""
    if torch._C._are_functorch_transforms_active():
        return _BuildWavefront.apply(cfg, allowed, is_road, hard)
    return _wavefront_single(cfg, allowed, is_road, hard)


# ---- K4 --------------------------------------------------------------------

def _prefix_launch(occ, B: int):
    """One K4 launch over the B planes of `occ` [(B,) H, W] (int32,
    contiguous, on the card): (incH, incV), views of one allocation."""
    H, W = occ.shape[-2:]
    out = torch.empty((2, *occ.shape), dtype=torch.int32, device=occ.device)
    ptr = out.data_ptr()
    _check_rc("tsim_prefix_planes", _entry("tsim_prefix_planes")(
        occ.data_ptr(), ptr, ptr + occ.numel() * 4, B, H, W,
        torch._C._cuda_getCurrentRawStream(occ.device.index)))
    launches["prefix_planes"] += 1
    return out.unbind(0)


def prefix_planes_batched(occ):
    """K4 for B planes: occ int32 [B, H, W] -> row- and column-inclusive
    prefix sums (incH, incV), each [B, H, W].

    Replaces `pallas_engine.prefix_planes_pallas` (`_prefix_kernel`,
    ops/pallas_engine.py).  Source: csrc/prefix.cu.  On the H100 it is
    bound by device-memory bytes (a plane in, two out: 12.6 MB at
    1024^2) and, for one 256^2 plane, by the latency of its one launch
    and this wrapper's host work.  Design: one launch; one warp scans a
    row with vector loads in flight and warp shuffles; a block scans a
    band of 8 columns in 32 row segments (whole-sector loads, segment
    totals scanned in shared memory); exact int32 with wrap-around.  The
    wrapper allocates both outputs at once and resolves the entry point
    once."""
    if not _on_cuda(occ):
        return prefix_planes_plain(occ)
    if occ.dim() != 3:
        raise ValueError(f"occ: shape {tuple(occ.shape)}, kernel takes "
                         "[B, H, W]")
    _check("occ", occ, torch.int32, occ.shape, occ.device)
    return _prefix_launch(occ, occ.shape[0])


def _prefix_single(occ):
    if not _on_cuda(occ):
        return prefix_planes_plain(occ)
    if occ.dim() != 2:
        raise ValueError(f"occ: shape {tuple(occ.shape)}, kernel takes "
                         "[H, W]")
    if occ.dtype != torch.int32 or not occ.is_contiguous():
        _check("occ", occ, torch.int32, occ.shape, occ.device)
    return _prefix_launch(occ, 1)


class _PrefixPlanes(_Kernel):
    @staticmethod
    def forward(occ):
        return _prefix_single(occ)

    @staticmethod
    def vmap(info, in_dims, occ):
        return prefix_planes_batched(_front(occ, in_dims[0],
                                            info.batch_size)), (0, 0)


def prefix_planes(occ):
    """K4 for one plane [H, W] (one launch; under vmap one batched
    launch, through `_PrefixPlanes`'s rule)."""
    if torch._C._are_functorch_transforms_active():
        return _PrefixPlanes.apply(occ)
    return _prefix_single(occ)


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
        # the kernel writes 16 bytes where it reads 16 of dest: the output
        # at dest's offset from a 16-byte boundary
        off = dest.data_ptr() // 4 % 4
        out = torch.empty(H * W + off, dtype=torch.int32,
                          device=dev)[off:].view(H, W)
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
    memory: dest in and the result out, 8 bytes a cell, and a 32-byte
    sector for every distinct sector the gathers touch (neighbouring
    cells share one only where they name the same plane; ~40 MB at
    1024^2 on uniform rows).  Design: four cells a thread, 16-byte loads
    of dest and stores of the result, the four gathers in flight at once
    and not allocated in L1, the edges before dest's first 16-byte
    boundary and after its last vector in the same launch, where the
    TPU kernel streamed the whole stack.  The result lies at dest's
    offset from a 16-byte boundary (a view, storage offset 0-3).  On
    no path: under hierarchical routing the tick's selects run inside
    K1-hier (`decide_move(..., hier=)`); `ops/hier.hier_select`, its
    plain version, calls this."""
    return _SelectRows.apply(sdir4, dest)


# ---- ordered scatter-add --------------------------------------------------

def ordered_add_rows(base, idx, vals):
    """`ordered_add` over R rows: base f32 [R, T], idx int64 [R, n],
    vals f32 [R, n] -> f32 [R, T], each row base with vals added at idx
    in update order (indices outside [0, T) dropped).

    No TPU kernel: the JAX package adds with XLA's scatter
    (`food.at[sb].add(give)`, ops/engine.py `_post_move`), which on the
    CPU folds duplicates in update order; an atomic scatter on the card
    would not.  Subnormals flush to zero as on XLA's CPU runtime.
    Source: csrc/ordered_add.cu.  Bound by latency.  Design: O(n + T)
    per row in one block: an order-keeping compaction of the nonzero
    updates (a +-0 or subnormal update changes a fold only where it ends
    at -0 with a +0 update after its last nonzero one: then it is +0), a
    scan of the per-target counts, a stable placement into per-target
    runs, then one thread per target folds its run with a flushing add;
    rows too large for shared memory use a work area in device
    memory."""
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
    # a row's work area in device memory, where shared memory is too small
    per_row = _entry("tsim_ordered_add_work")(T, n)
    work = (torch.empty(R * per_row, dtype=torch.uint8, device=dev)
            if per_row else None)
    _check_rc("tsim_ordered_add", _entry("tsim_ordered_add")(
        base.data_ptr(), idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
        work.data_ptr() if per_row else None, R, T, n,
        torch._C._cuda_getCurrentRawStream(dev.index)))
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
    (`ordered_add_rows`; under vmap one launch for all worlds' rows
    through `_OrderedAdd`'s rule, no autograd.Function otherwise)."""
    if torch._C._are_functorch_transforms_active():
        return _OrderedAdd.apply(base, idx, vals)
    return ordered_add_rows(base, idx, vals)


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


def _rain_single(clouds, active, cooldown, spawn, want_cd, cool: int):
    """One world's clouds over n ticks, one launch with no copies: the
    lean form of `rain_ticks_batched` at B = 1 (a comparison per check,
    the entry point resolved once, Python ints for pointers)."""
    if not _on_cuda(clouds):
        from ..agents.rain import cloud_ticks_plain
        return cloud_ticks_plain(clouds, active, cooldown, spawn, want_cd,
                                 cool)
    R = clouds.shape[-1]
    n = spawn.shape[-1]
    dev = clouds.device
    if not (clouds.dtype == torch.float32 and active.dtype == torch.bool
            and cooldown.dtype == torch.int32
            and spawn.dtype == torch.float32
            and want_cd.dtype == torch.int32
            and clouds.shape == (9, R) and active.shape == (R,)
            and cooldown.shape == () and spawn.shape == (9, n)
            and want_cd.shape == (n,)
            and active.device == dev and cooldown.device == dev
            and spawn.device == dev and want_cd.device == dev
            and clouds.is_contiguous() and active.is_contiguous()
            and spawn.is_contiguous() and want_cd.is_contiguous()):
        # the precise error
        _check("clouds", clouds, torch.float32, (9, R), dev)
        _check("active", active, torch.bool, (R,), dev)
        _check("cooldown", cooldown, torch.int32, (), dev)
        _check("spawn", spawn, torch.float32, (9, n), dev)
        _check("want_cd", want_cd, torch.int32, (n,), dev)
    seen = torch.empty((n, 9, R), dtype=torch.float32, device=dev)
    seen_a = torch.empty((n, R), dtype=torch.bool, device=dev)
    if n == 0:
        return seen, seen_a, cooldown.clone()
    cd = torch.empty((), dtype=torch.int32, device=dev)
    _check_rc("tsim_rain_ticks", _entry("tsim_rain_ticks")(
        clouds.data_ptr(), active.data_ptr(), cooldown.data_ptr(),
        spawn.data_ptr(), want_cd.data_ptr(), seen.data_ptr(),
        seen_a.data_ptr(), cd.data_ptr(), 1, n, R, cool,
        torch._C._cuda_getCurrentRawStream(dev.index)))
    launches["rain_ticks"] += 1
    return seen, seen_a, cd


class _RainTicks(_Kernel):
    @staticmethod
    def forward(clouds, active, cooldown, spawn, want_cd, cool):
        return _rain_single(clouds.contiguous(), active.contiguous(),
                            cooldown, spawn.contiguous(),
                            want_cd.contiguous(), cool)

    @staticmethod
    def vmap(info, in_dims, clouds, active, cooldown, spawn, want_cd, cool):
        B = info.batch_size
        args = [_front(x, d, B) for x, d in zip(
            (clouds, active, cooldown, spawn, want_cd), in_dims[:5])]
        return rain_ticks_batched(*args, cool), (0, 0, 0)


def rain_ticks(clouds, active, cooldown, spawn, want_cd, cool: int):
    """One world's clouds over n ticks (`rain_ticks_batched` with B = 1):
    clouds f32 [9, R], active bool [R], cooldown int32 [], spawn f32 [9,
    n], want_cd int32 [n] -> (f32 [n, 9, R], bool [n, R], int32 []).
    One launch through the lean `_rain_single`; under vmap one launch for
    all worlds, through `_RainTicks`'s rule."""
    if torch._C._are_functorch_transforms_active():
        return _RainTicks.apply(clouds, active, cooldown, spawn, want_cd,
                                cool)
    return _rain_single(clouds, active, cooldown, spawn, want_cd, cool)


# ---- pedestrians ------------------------------------------------------------

def _ped_launch(cfg: Config, walk, cross, cell_type, stop_map, seeds, n_side,
                B: int, geo: int):
    """One `step_pedestrians` launch over B worlds (every tensor checked
    by the caller)."""
    from ..agents.pedestrians import spawn_rate
    H, W = cell_type.shape[-2:]
    dev = walk.device
    walk_o = torch.empty(walk.shape, dtype=torch.int32, device=dev)
    cross_o = torch.empty(walk.shape, dtype=torch.int32, device=dev)
    block = torch.empty(stop_map.shape, dtype=torch.bool, device=dev)
    count = torch.empty(stop_map.shape, dtype=torch.int32, device=dev)
    _check_rc("tsim_step_pedestrians", _entry("tsim_step_pedestrians")(
        walk.data_ptr(), cross.data_ptr(), cell_type.data_ptr(),
        stop_map.data_ptr(), seeds.data_ptr(), n_side.data_ptr(),
        walk_o.data_ptr(), cross_o.data_ptr(), block.data_ptr(),
        count.data_ptr(), B, H, W, geo, float(spawn_rate(cfg)),
        int(cfg.PEDESTRIANS_ENABLED),
        torch._C._cuda_getCurrentRawStream(dev.index)))
    launches["step_pedestrians"] += 1
    return walk_o, cross_o, block, count


def _no_side(n_side):
    if n_side is None:
        raise ValueError("n_side: the world's sidewalk count "
                         "(`Grid.n_side`, core.state.sidewalk_count) is "
                         "required")


def step_pedestrians_batched(cfg: Config, walk, cross, cell_type, stop_map,
                             seeds, n_side):
    """One pedestrian tick for B worlds: walk, cross int32 [B, 4, H, W],
    cell_type u8 shared [H, W] or one plane a world [B, H, W], stop_map
    bool [B, H, W], seeds int64 [B, 14] (`engine.tick_draws`' u32
    seeds), n_side int32 the sidewalk count of each cell plane ([] or
    [B], `Grid.n_side`) -> (walk', cross' int32 [B, 4, H, W], ped_block
    bool [B, H, W], ped_count int32 [B, H, W]).

    No TPU kernel: the JAX package runs the step as XLA ops
    (`agents/pedestrians.step_pedestrians`).  Source:
    csrc/pedestrians.cu.  On the H100 it is bound by launch latency at
    a few hundred thousand cells (~71 bytes a cell: eight count planes
    in and out, cell_type, the stop map, ped_block and ped_count); the
    plain version issues ~700 ops a tick.  Design: one launch, a block
    per 32 x 8 tile and world; each cell of the tile and of the ring one
    step outside it computes its own splits once (the keep and cross
    split per heading, the rest, the pool's takes, each with its hashed
    uniform, from the cell types and stop map of the tile and a ring of
    two staged in shared memory) and stores what it sends in shared
    memory; after one block barrier each tile cell gathers what lands on
    it, thins its walkers and rolls its spawn; every f32 rounding
    spelled out.  The sidewalk count is a static of the world, so a
    call is one launch."""
    _no_side(n_side)
    if not _on_cuda(walk):
        from ..agents.pedestrians import step_pedestrians_plain
        geo = cell_type.dim() == 3
        outs = [step_pedestrians_plain(
            cfg, walk[b], cross[b], cell_type[b] if geo else cell_type,
            stop_map[b], seeds[b], n_side[b] if geo else n_side)
            for b in range(walk.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    B, _, H, W = walk.shape
    dev = walk.device
    geo = int(cell_type.dim() == 3)
    _check("walk", walk, torch.int32, (B, 4, H, W), dev)
    _check("cross", cross, torch.int32, (B, 4, H, W), dev)
    _check("cell_type", cell_type, torch.uint8, (B,) * geo + (H, W), dev)
    _check("stop_map", stop_map, torch.bool, (B, H, W), dev)
    _check("seeds", seeds, torch.int64, (B, 14), dev)
    _check("n_side", n_side, torch.int32, (B,) * geo, dev)
    return _ped_launch(cfg, walk, cross, cell_type, stop_map, seeds, n_side,
                       B, geo)


def _ped_single(cfg: Config, walk, cross, cell_type, stop_map, seeds,
                n_side):
    _no_side(n_side)
    if not _on_cuda(walk):
        from ..agents.pedestrians import step_pedestrians_plain
        return step_pedestrians_plain(cfg, walk, cross, cell_type, stop_map,
                                      seeds, n_side)
    H, W = cell_type.shape
    dev = walk.device
    if not (walk.dtype == torch.int32 and cross.dtype == torch.int32
            and cell_type.dtype == torch.uint8
            and stop_map.dtype == torch.bool and seeds.dtype == torch.int64
            and n_side.dtype == torch.int32
            and walk.shape == (4, H, W) and cross.shape == (4, H, W)
            and stop_map.shape == (H, W) and seeds.shape == (14,)
            and n_side.shape == ()
            and cross.device == dev and cell_type.device == dev
            and stop_map.device == dev and seeds.device == dev
            and n_side.device == dev
            and walk.is_contiguous() and cross.is_contiguous()
            and cell_type.is_contiguous() and stop_map.is_contiguous()
            and seeds.is_contiguous()):
        # the precise error
        _check("walk", walk, torch.int32, (4, H, W), dev)
        _check("cross", cross, torch.int32, (4, H, W), dev)
        _check("cell_type", cell_type, torch.uint8, (H, W), dev)
        _check("stop_map", stop_map, torch.bool, (H, W), dev)
        _check("seeds", seeds, torch.int64, (14,), dev)
        _check("n_side", n_side, torch.int32, (), dev)
    return _ped_launch(cfg, walk, cross, cell_type, stop_map, seeds, n_side,
                       1, 0)


class _StepPedestrians(_Kernel):
    @staticmethod
    def forward(cfg, walk, cross, cell_type, stop_map, seeds, n_side):
        return _ped_single(cfg, walk.contiguous(), cross.contiguous(),
                           cell_type.contiguous(), stop_map.contiguous(),
                           seeds.contiguous(), n_side.contiguous())

    @staticmethod
    def vmap(info, in_dims, cfg, walk, cross, cell_type, stop_map, seeds,
             n_side):
        B = info.batch_size
        _, wd, cd, gd, sd, kd, nd = in_dims
        # the geometry (cell_type with its count) is shared only where
        # all of it is
        if gd is None and nd is None:
            cell, side = cell_type.contiguous(), n_side.contiguous()
        else:
            cell, side = _front(cell_type, gd, B), _front(n_side, nd, B)
        return step_pedestrians_batched(
            cfg, _front(walk, wd, B), _front(cross, cd, B), cell,
            _front(stop_map, sd, B), _front(seeds, kd, B),
            side), (0, 0, 0, 0)


def step_pedestrians(cfg: Config, walk, cross, cell_type, stop_map, seeds,
                     n_side):
    """One pedestrian tick of one world (`step_pedestrians_batched` with
    B = 1): walk, cross int32 [4, H, W], cell_type u8 [H, W], stop_map
    bool [H, W], seeds int64 [14], n_side int32 [] (`Grid.n_side`) ->
    (walk', cross', ped_block, ped_count).  One lean launch; under vmap
    one launch for all worlds, through `_StepPedestrians`'s rule."""
    if torch._C._are_functorch_transforms_active():
        _no_side(n_side)
        return _StepPedestrians.apply(cfg, walk, cross, cell_type, stop_map,
                                      seeds, n_side)
    return _ped_single(cfg, walk, cross, cell_type, stop_map, seeds, n_side)


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
    ("li", "i", (9, "G")), ("lf", "f", (2, "G")), ("lstop", "b", ("L",)),
    ("lown", "i", ("NOWN",)))
_DT = {"i": torch.int32, "f": torch.float32, "b": torch.bool}
MEGA_OUTPUTS = ("pa", "pb", "pc", "pd", "pe", "pl", "stop", "food", "waste",
                "frem", "wrem", "li", "lf", "lstop", "stats")
_ALGO_ID = {"DISABLED": 0, "FIXED_TIME": 1, "QUEUE_ACTUATED": 2,
            "PRESSURE_CONTROL": 3, "NEIGHBOR_PRESSURE_CONTROL": 4,
            "NEIGHBOR_GREEN_WAVE": 5}

# K9's two forms (csrc/megakernel.cu), chosen by shape (`k9_form`):
#  "coop"    one cooperative launch; each block owns `tiles_per_block` of
#            K1's 32 x 8 tiles of ONE world (`blocks_per_world` blocks a
#            world, block j its tiles j, j + blocks_per_world, ...) and a
#            contiguous range of that world's light groups; grid
#            barriers; the worlds in groups where one resident grid does
#            not hold them all;
#  "worlds"  one ordinary block a world that owns all of it, its keys and
#            pub bytes in shared memory (K1's block-per-world layout,
#            `k1_world_smem`), block barriers.
# Beside the dynamic shared memory, every block takes K9_STATIC[form] bytes
# of static shared memory: the tile table, the work list's length, the
# neediest-block staging and both of a tick's results, the stats staging
# and the block's range of light groups (ptxas, per instantiation; the
# kernel's library reads its own, `mega_plan`'s "static_smem_bytes").
K9_STATIC = {"coop": 1632, "worlds": 1616}
# the block-per-world form from this many worlds an SM, where this many of
# its blocks fit an SM's shared memory (K1's rule, K1_WORLDS_PER_SM)
K9_WORLDS_PER_SM = 2
SM_REGISTERS = 65536      # an SM's 32-bit registers (H100)
_K9_FORMS = ("coop", "worlds")


def k9_coop_smem(cpt: int) -> int:
    """Dynamic shared memory bytes of a cooperative block of `cpt` tiles:
    its state words and work list (csrc/coop.cuh `coop_smem`)."""
    return cpt * K1_THREADS * 8


def k9_blocks_per_sm(smem: int, smem_per_block: int, regs: int) -> int:
    """Resident blocks an SM of K9's cooperative form with `smem` bytes of
    dynamic shared memory and `regs` registers a thread, as CUDA's
    occupancy calculator counts them: shared memory (each block also
    holds K9_STATIC["coop"] and the K1_BLOCK_RESERVED bytes CUDA keeps),
    registers (a warp's rounded up to 256) and threads (2048 an SM)."""
    by_smem = (smem_per_block + K1_BLOCK_RESERVED) \
        // (smem + K9_STATIC["coop"] + K1_BLOCK_RESERVED)
    warp = -(-regs * 32 // 256) * 256
    by_regs = SM_REGISTERS // (warp * (K1_THREADS // 32))
    return min(by_smem, by_regs, 2048 // K1_THREADS)


def k9_form(B: int, H: int, W: int, n_sm: int, smem_per_block: int) -> str:
    """K9's form for B worlds of H x W on a card with `n_sm` SMs and
    `smem_per_block` bytes of shared memory a block may take: "worlds"
    where one world fits one block (at most K1_MAX_TILES tiles),
    K9_WORLDS_PER_SM of those blocks fit an SM's shared memory and the
    batch fills the card (at least K9_WORLDS_PER_SM worlds an SM); else
    "coop" where one world's tiles fit one resident grid (by shared
    memory) at some number of tiles a block; else ValueError.  A
    function of the shape alone (the H100's numbers: 132 SMs, 232,448
    bytes)."""
    tiles = k1_world_tiles(H, W)
    if B < 1 or tiles < 1:
        raise ValueError(f"K9 takes no batch of {B} worlds of {H} x {W}")
    need = k1_world_smem(H, W) + K9_STATIC["worlds"] + K1_BLOCK_RESERVED
    fits = (tiles <= K1_MAX_TILES and (smem_per_block + K1_BLOCK_RESERVED)
            // need >= K9_WORLDS_PER_SM)
    if fits and B >= K9_WORLDS_PER_SM * n_sm:
        return "worlds"
    if any(-(-tiles // c) <= n_sm * ((smem_per_block + K1_BLOCK_RESERVED)
                                     // (k9_coop_smem(c)
                                         + K9_STATIC["coop"]
                                         + K1_BLOCK_RESERVED))
           for c in (1, 2, 4, 8, 16, 32, K1_MAX_TILES)):
        return "coop"
    raise ValueError(
        f"K9 takes no batch of {B} worlds of {H} x {W}: a world of {tiles} "
        f"tiles fits neither one block ({K1_MAX_TILES} tiles) nor one "
        f"cooperative grid of {n_sm} SMs at {K1_MAX_TILES} tiles a block")


def k9_plan(B: int, H: int, W: int, n_sm: int, smem_per_block: int,
            regs: int, form=None) -> dict:
    """K9's launch for B worlds of H x W (the form `k9_form` chooses, or
    `form`) on a card with `n_sm` SMs, `smem_per_block` bytes of shared
    memory a block and a kernel of `regs` registers a thread: its blocks,
    tiles a block (a power of two in the cooperative form: the fewest
    whose resident grid holds every world's blocks; else as few world
    groups as the largest resident grid allows, of equal size), blocks a
    world, worlds a group, groups and dynamic shared memory bytes.  A
    function of these numbers alone: the mirror of the plan the kernel's
    library makes on the card (`mega_plan`, which launches go by), for
    the CPU's tests; the card's tests hold the two equal."""
    if form is None:
        form = k9_form(B, H, W, n_sm, smem_per_block)
    tiles = k1_world_tiles(H, W)
    if form == "worlds":
        if tiles > K1_MAX_TILES or k1_world_smem(H, W) \
                + K9_STATIC["worlds"] > smem_per_block:
            raise ValueError(f"K9's block-per-world form takes no world of "
                             f"{H} x {W}")
        return {"form": form, "blocks": B, "tiles_per_block": tiles,
                "blocks_per_world": 1, "worlds_per_group": B, "groups": 1,
                "smem_bytes": k1_world_smem(H, W)}
    cpts = [1 << i for i in range(7)]

    def resident(c):
        return n_sm * k9_blocks_per_sm(k9_coop_smem(c), smem_per_block, regs)

    def bpw(c):
        return -(-tiles // c)

    wpg = B
    if all(bpw(c) * B > resident(c) for c in cpts):
        fit = max(resident(c) // bpw(c) for c in cpts)
        if fit < 1:
            raise ValueError(f"K9 takes no world of {H} x {W} in one "
                             "cooperative grid")
        wpg = -(-B // -(-B // fit))
    c = next(c for c in cpts if bpw(c) * wpg <= resident(c))
    return {"form": form, "blocks": bpw(c) * wpg, "tiles_per_block": c,
            "blocks_per_world": bpw(c), "worlds_per_group": wpg,
            "groups": -(-B // wpg), "smem_bytes": k9_coop_smem(c)}


_mega_plans = {}          # (device index, B, H, W, form) -> mega_plan


# what tsim_mega_plan returns for a shape it does not take
# (cudaErrorInvalidValue, cudaErrorCooperativeLaunchTooLarge)
_K9_REFUSED = (1, 720)


def mega_plan(B: int, H: int, W: int, device=None, form=None) -> dict:
    """K9's plan for B worlds of H x W on the card, as the kernel's library
    makes it (its rule and the card's occupancy; `k9_plan` mirrors it):
    form, blocks, tiles a block, blocks a world, worlds a group, groups,
    dynamic and static shared memory, registers and resident blocks an
    SM.  `form` forces one form; a shape that neither form (or the forced
    one) takes raises ValueError naming it."""
    dev = torch.device("cuda" if device is None else device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, B, H, W, form)
    got = _mega_plans.get(key)
    if got is not None:
        return got
    out = (ctypes.c_int * 10)()
    with torch.cuda.device(idx):
        rc = _entry("tsim_mega_plan")(
            B, H, W, -1 if form is None else _K9_FORMS.index(form),
            ctypes.addressof(out))
    if rc in _K9_REFUSED:
        raise ValueError(f"K9 takes no batch of {B} worlds of {H} x {W}"
                         + (f" in its {form!r} form" if form else ""))
    _check_rc("tsim_mega_plan", rc)
    names = ("blocks", "tiles_per_block", "blocks_per_world",
             "worlds_per_group", "groups", "smem_bytes",
             "static_smem_bytes", "registers", "blocks_per_sm")
    got = {"form": _K9_FORMS[out[0]], **dict(zip(names, out[1:]))}
    _mega_plans[key] = got
    return got


def mega_grid(dev, H: int, W: int):
    """(blocks, tiles a block) of K9's cooperative grid for one H x W world
    on the card `dev` (`mega_plan` at B = 1)."""
    p = mega_plan(1, H, W, dev)
    return p["blocks"], p["tiles_per_block"]


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


def _mega_sig(dims: dict, B: int, batched) -> tuple:
    """(name, dtype, shape, whether batched, the contiguous strides of one
    world's tensor) of each input K9 takes: a leading B where `batched`
    names it."""
    out = []
    for name, dt, shape in _MEGA_IN:
        one = tuple(dims.get(x, x) for x in shape)
        strides = tuple(int(np.prod(one[i + 1:])) for i in range(len(one)))
        lead = (B,) if name in batched else ()
        out.append((name, _DT[dt], lead + one, bool(lead), strides))
    return tuple(out)


def _check_world(name, t, dtype, shape, device, batched: bool):
    """`_check` of one K9 input: a batched one [B, ...] needs each world
    contiguous (any stride between worlds: the kernel takes one per
    input), a shared one contiguous."""
    if batched:
        if tuple(t.shape[:1]) != tuple(shape[:1]):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes "
                             f"{tuple(shape)}")
        t, shape = t[0], shape[1:]
    _check(name, t, dtype, shape, device)


def check_mega_inputs(a: dict, B: int = 1, batched=()) -> dict:
    """Raise unless `a` holds every input K9 takes, each of its dtype,
    shape and device; the tensors named in `batched` with a leading dim
    of B worlds, each world contiguous (any stride between worlds), the
    others one world's (shared by the batch) and contiguous.  Returns
    the dimensions of one world."""
    dims = _mega_dims(a, batched)
    for name, dt, shape, bat, _ in _mega_sig(dims, B, batched):
        _check_world(name, a[name], dt, shape, a["pa"].device, bat)
    return dims


def _mega_dims(a: dict, batched=()) -> dict:
    def shape(k):
        s = a[k].shape
        return s[1:] if k in batched else s
    H, W = shape("pa")
    G, L = shape("li")[1], shape("lstop")[0]
    NQ, NS = shape("qrun")[0], shape("srun")[0]
    return {"H": H, "W": W, "D4": shape("sdir4")[0], "R": shape("ticks")[0],
            "G": G, "L": L, "NQ": NQ, "NS": NS,
            "NOWN": 3 * (G + 3) + NQ + L + NS}


class _MegaShape:
    """K9's launch state for one device, world shape, batch size and form,
    kept between calls: the plan (`mega_plan`), the scratch (the plane
    set, light rows and K1 working sets that are not returned, the queue
    counts, group flags, a zero pedestrian plane, the reduction
    partials, each for every world), the pointer table, and per set of
    batched inputs their signature and world strides."""

    def __init__(self, dev, dims: dict, B: int, plan: dict):
        H, W, R, G = dims["H"], dims["W"], dims["R"], dims["G"]
        HW = H * W
        i32t, f32t = torch.int32, torch.float32
        self.plan = plan
        bpw = plan["blocks_per_world"]
        self.launch = (_K9_FORMS.index(plan["form"]), plan["blocks"],
                       plan["tiles_per_block"], plan["worlds_per_group"])
        self.set_ = torch.empty((5, B, H, W), dtype=i32t, device=dev)
        self.setl = torch.empty((B, H, W), dtype=f32t, device=dev)
        self.li = torch.empty((B, 9, G), dtype=i32t, device=dev)
        self.lf = torch.empty((B, 2, G), dtype=f32t, device=dev)
        self.scratch = [
            torch.empty((B * (_N_WORK_K1 * HW + (HW + 3) // 4),),
                        dtype=i32t, device=dev),
            torch.empty((B * G * 5,), dtype=i32t, device=dev),
            torch.empty((B * G,), dtype=i32t, device=dev),
            torch.zeros((H, W), dtype=torch.uint8, device=dev),
            torch.empty((2 * B * bpw * 6,), dtype=i32t, device=dev),
            torch.empty((B * R * bpw * 16,), dtype=i32t, device=dev),
            torch.empty((B * R * bpw * 4,), dtype=f32t, device=dev)]
        # the inputs, then the 2 plane sets (5 int planes, pl), the stop
        # plane, the tanks, 2 + 2 light-row buffers, lstop, stats and the
        # 7 scratch buffers
        self.ptrs = (ctypes.c_void_p * (len(_MEGA_IN) + 30))()
        plane = B * H * W * 4
        self.set_ptrs = [self.set_.data_ptr() + k * plane
                         for k in range(5)] + [self.setl.data_ptr()]
        self.scratch_ptrs = [t.data_ptr() for t in self.scratch]
        self.ws = (ctypes.c_long * len(_MEGA_IN))()
        self.sigs = {}            # frozenset(batched) -> signature


_mega_cache = {}          # (device index, dims, B, form) -> _MegaShape
_mega_last = [None, None, None]   # the last Config, dims and its params


def _mega_kernel(cfg: Config, a: dict, B: int = 1, batched=frozenset(),
                 form=None) -> dict:
    """Launch K9 on the card: one launch for the R ticks of B worlds (the
    tensors named in `batched` carry a leading dim B, the others are
    shared and read with world stride 0), in the form `mega_plan` gives
    (or `form`).  The scratch, the pointer table and the parameters are
    kept per shape, B and form and per Config (so calls of one shape run
    on one stream, as the path's do); the outputs are new tensors at
    every call, each with a leading dim B."""
    dev = a["pa"].device
    dims = _mega_dims(a, batched)
    key = (dev.index, *dims.values(), B, form)
    sh = _mega_cache.get(key)
    if sh is None:
        check_mega_inputs(a, B, batched)
        plan = mega_plan(B, dims["H"], dims["W"], dev, form)
        sh = _mega_cache[key] = _MegaShape(dev, dims, B, plan)
    sig = sh.sigs.get(batched)
    if sig is None:
        sig = sh.sigs[batched] = _mega_sig(dims, B, batched)
    idx = dev.index
    ins = []
    ws = sh.ws
    for i, (name, dt, shape, bat, strides) in enumerate(sig):
        t = a[name]
        st = t.stride()
        if (t.dtype != dt or t.shape != shape or t.get_device() != idx
                or (st[1:] if bat else st) != strides):
            _check_world(name, t, dt, shape, dev, bat)
        ws[i] = st[0] if bat else 0
        ins.append(t.data_ptr())
    if _mega_last[0] is not cfg or _mega_last[1] != key:
        _mega_last[:] = [cfg, key, _mega_params(cfg, dims)]
    p5, f5, stop, li, lf, lstop, stats = _mega_launch(
        sh, ins, ws, _mega_last[2], dims, B, dev)
    pa_, pb, pc, pd, pe = p5.unbind(0)
    pl, food, waste, frem, wrem = f5.unbind(0)
    return dict(zip(MEGA_OUTPUTS, (pa_, pb, pc, pd, pe, pl, stop, food,
                                   waste, frem, wrem, li, lf, lstop, stats)))


def _mega_launch(sh, ins, ws, params, dims: dict, B: int, dev):
    """The one K9 launch: new outputs (the plane set [5, B, H, W] int32,
    pl and the 4 tanks [5, B, H, W] f32, stop, li, lf, lstop, stats, each
    world's after the others'), the pointer table of the inputs `ins`
    (pointers), the outputs and the scratch of `sh`, then the kernel."""
    H, W, R, G = dims["H"], dims["W"], dims["R"], dims["G"]
    i32t, f32t = torch.int32, torch.float32
    p5 = torch.empty((5, B, H, W), dtype=i32t, device=dev)
    f5 = torch.empty((5, B, H, W), dtype=f32t, device=dev)
    stop = torch.empty((B, H, W), dtype=torch.bool, device=dev)
    li = torch.empty((B, 9, G), dtype=i32t, device=dev)
    lf = torch.empty((B, 2, G), dtype=f32t, device=dev)
    lstop = torch.empty((B, dims["L"]), dtype=torch.bool, device=dev)
    stats = torch.empty((B, R, 16), dtype=f32t, device=dev)
    # tick t writes plane set t & 1 and light buffer (t + 1) & 1: the
    # last tick's go to the outputs, the others to the scratch
    p0, fp0 = p5.data_ptr(), f5.data_ptr()
    plane = B * H * W * 4
    fin = [p0 + k * plane for k in range(5)] + [fp0]
    sets = fin + sh.set_ptrs if R & 1 else sh.set_ptrs + fin
    lis = [li.data_ptr(), sh.li.data_ptr()]
    lfs = [lf.data_ptr(), sh.lf.data_ptr()]
    if R & 1:
        lis.reverse()
        lfs.reverse()
    sh.ptrs[:] = (ins + sets + [stop.data_ptr()]
                  + [fp0 + k * plane for k in (1, 2, 3, 4)]
                  + lis + lfs + [lstop.data_ptr(), stats.data_ptr()]
                  + sh.scratch_ptrs)
    ip, fp = params
    form, grid, cpt, wpg = sh.launch
    _check_rc("tsim_mega_segment", _entry("tsim_mega_segment")(
        ctypes.addressof(ip), ctypes.addressof(fp),
        ctypes.addressof(sh.ptrs), ctypes.addressof(ws), len(sh.ptrs), B,
        form, grid, cpt, wpg, torch._C._cuda_getCurrentRawStream(dev.index)))
    launches["mega_worlds" if form else "mega"] += 1
    return p5, f5, stop, li, lf, lstop, stats


def mega_syncs() -> int:
    """The stage barriers K9's launches have passed since the last call,
    counted by block 0 (grid barriers in the cooperative form, its block
    barriers at the same places in the block-per-world form; synchronises
    the card)."""
    n = ctypes.c_int(0)
    torch.cuda.synchronize()
    _check_rc("tsim_mega_syncs",
              _entry("tsim_mega_syncs")(ctypes.addressof(n)))
    return n.value


def mega_segment_batched(cfg: Config, a: dict, B: int, batched,
                         form=None) -> dict:
    """K9 for a batch of B worlds in one launch: the tensors of `a` named
    in `batched` carry a leading world dim B, the others (chunk tables a
    shared-geometry batch shares) are one world's and read by every
    world.  Returns `MEGA_OUTPUTS`, each with a leading dim B.  On CPU
    tensors the plain batched version (`megakernel.
    segment_plain_batched`); on the card the kernel in the form
    `k9_form` chooses by shape, or `form` ("coop" or "worlds")."""
    batched = frozenset(batched)
    if not _on_cuda(a["pa"]):
        from .megakernel import segment_plain_batched
        return segment_plain_batched(cfg, a, B, batched)
    return _mega_kernel(cfg, a, B, batched, form)


class _MegaSegment(_Kernel):
    @staticmethod
    def forward(cfg, names, *tensors):
        out = _mega_single(cfg, dict(zip(names, tensors)))
        return tuple(out[k] for k in MEGA_OUTPUTS)

    @staticmethod
    def vmap(info, in_dims, cfg, names, *tensors):
        a, batched = {}, []
        for name, t, d in zip(names, tensors, in_dims[2:]):
            if d is not None:
                t = t.movedim(d, 0)
                batched.append(name)
            a[name] = t
        out = mega_segment_batched(cfg, a, info.batch_size, batched)
        return (tuple(out[k] for k in MEGA_OUTPUTS),
                (0,) * len(MEGA_OUTPUTS))


def _mega_single(cfg: Config, a: dict) -> dict:
    if _on_cuda(a["pa"]):
        return {k: v[0] for k, v in _mega_kernel(cfg, a).items()}
    from .megakernel import segment_plain
    return segment_plain(cfg, a)


def mega_segment(cfg: Config, args: dict) -> dict:
    """K9, one routing segment of R ticks on the card: `args` holds the
    chunk tables (`megakernel.build_chunk_static`), the segment's next-move
    stack and wavefronts, its streams and the carried state, as
    `megakernel.segment_plain` takes them; returns its outputs
    (`MEGA_OUTPUTS`).  One lean launch; under vmap one launch for the
    whole batch (`mega_segment_batched`), the shared tensors read by
    every world.

    Replaces `megakernel.run_segment_mega`'s `pallas_call` (`_mega_kernel`,
    ops/megakernel.py; batched by `jax.vmap` through the Pallas batching
    rule, a world axis on its grid).  Source: csrc/megakernel.cu.  On the
    H100 a tick is bound by its chain of dependent phases and the
    barriers between them (the planes and the packed stack sit in the 50
    MB L2), then by this wrapper's host work.  Design: blocks own fixed
    cell tiles of one world (K1's decide + move, shared through
    csrc/coop.cuh) and whole light groups of that world with their runs
    (`megakernel.light_owner_table`), so a tick takes 2K + 3 barriers (K
    = VEHICLE_MAX_SPEED); the form by shape (`k9_form`): one cooperative
    launch whose blocks_per_world blocks share a world through grid
    barriers (one world, or a batch such as 16 rollouts of 256^2), or one
    block a world with its keys and pub bytes in shared memory and block
    barriers (many small worlds: config #4); each block builds its
    world's pointers from the batch's base pointers and world strides
    (0 for a shared table).  Reductions use per-block partials in a
    fixed order, so a rerun gives the same bits.  The wrapper keeps the
    scratch, the pointer table and the plan per shape and batch, and the
    parameters per Config; the kernel zeroes what it needs zeroed."""
    if torch._C._are_functorch_transforms_active():
        names = tuple(args)
        outs = _MegaSegment.apply(cfg, names, *args.values())
        return dict(zip(MEGA_OUTPUTS, outs))
    return _mega_single(cfg, args)
