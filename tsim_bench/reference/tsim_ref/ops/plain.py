# Frozen copy of the plain versions in trafficsimulation_tpu_torch/ops/hopper_engine.py at
# commit 20130c3 (the benchmark's plain reference; tsim_ref/__init__.py says what was kept).
"""The tick's plain versions of the port's hand-written kernels, in plain
PyTorch, each the port's transcription of the JAX package's XLA or
Pallas semantics:

  `decide_move`      <- pallas_engine.decide_move_core (K1's semantics)
  `build_sdir`       <- pallas_engine._sdir_body (K2's)
  `build_wavefront`  <- pallas_engine.wavefront_core (K3's)
  `prefix_planes`    <- pallas_engine._prefix_kernel (K4's)
  `ordered_add`      the service FSM's f32 scatter-add into the block
                     tanks in update order, as XLA's CPU scatter folds it
  `rain_ticks`       the rain clouds' tick loop (agents/rain.py)
  `mega_segment`     <- megakernel._mega_kernel (K9's semantics: the plain
                     segment, ops/megakernel.segment_plain)

One world at a time: no kernel, no batching rule, no launch counter.

Packed u32 planes are carried as int32 with the same bits: every right
shift below is masked to the field it extracts, so the sign fill of the
arithmetic shift never reaches a result.
"""

from __future__ import annotations

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
# The entries the tick calls, each its plain version
# ---------------------------------------------------------------------------

def decide_move(cfg: Config, sdir4, wnd, planes, stop_map, rain_map,
                ped_block, intersection, dest_id, randoms):
    """K1's semantics for one world: (pa, pb, pc, pd, pe, pl, flags)."""
    return decide_move_core(cfg, sdir4, wnd, *planes, stop_map, rain_map,
                            ped_block, intersection, dest_id, *randoms)


def build_sdir(K0, pen4, legal4, tp2: int):
    """K2's semantics: the next-move stack [ceil(D/4), H, W] int32."""
    return sdir_encode(K0, pen4, legal4, tp2)


def build_wavefront(cfg: Config, allowed, is_road, hard):
    """K3's semantics: the overtake merge wavefronts, packed int32 [H, W]."""
    return wavefront_core(cfg, allowed, is_road, hard)


def prefix_planes(occ):
    """K4's semantics: (row, column) inclusive prefix sums."""
    return prefix_planes_plain(occ)


def ordered_add(base, idx, vals):
    """base [R, T] f32 plus vals [R, n] at idx [R, n] in update order."""
    return ordered_add_plain(base, idx, vals)


def rain_ticks(clouds, active, cooldown, spawn, want_cd, cool: int):
    """One world's clouds over n ticks (agents/rain.cloud_ticks_plain)."""
    from ..agents.rain import cloud_ticks_plain
    return cloud_ticks_plain(clouds, active, cooldown, spawn, want_cd, cool)


def mega_segment(cfg: Config, args: dict) -> dict:
    """K9's semantics for one world: ops/megakernel.segment_plain."""
    from .megakernel import segment_plain
    return segment_plain(cfg, args)
