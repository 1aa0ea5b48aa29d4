"""K1-hier, the port's decide + move under hierarchical routing
(`hopper_engine.decide_move` with `hier=(local4, consts)`), on the CPU.

- The constant block that the wrapper hands the kernel
  (`ops/hier.kernel_consts`) drives a plain emulation of the arithmetic
  of the kernel's row select (`HierSelect`, csrc/decide_move.cuh); it
  must give JAX's and the port's `hier_rows` for every rid in [0, 2^14)
  at every tile, at the 64^2 test config (16-cell tiles, LMAX 8: every
  division a shift) and at config #5's 1024^2 parameters (64-cell
  tiles, LMAX 48: a magic division by 48), and at the test config the
  same bytes as both packages' `hier_select`.
- The wrapper's plain version against JAX's `decide_move_core` with
  `hier_select`, on random planes whose dest fields hold windowed rids,
  rids whose window misses the cell, direct rids, rids past the dense
  stack and DEST_NONE.
- The stall that the reference's select order makes
  (trafficsimulation_tpu/ops/hier.py, the select order): a vehicle at
  its destination region's hub cell, inside the destination's window,
  whose windowed byte is 7 (its path leaves the window) falls back to
  the hub row, which offers no move at the hub.  Both packages leave it
  standing and count it stuck; a later change of the select shows up
  here as a parity break.

JAX's functions run op by op (no compile of `run_chunk` or
`generate_city`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu.config import Config
from trafficsimulation_tpu.ops import engine as jengine
from trafficsimulation_tpu.ops import hier as jhier
from trafficsimulation_tpu.ops import pallas_engine as jpe
from trafficsimulation_tpu.ops.routing import _shift_plane

from trafficsimulation_tpu_torch.config import Config as TConfig
from trafficsimulation_tpu_torch.ops import engine as tengine
from trafficsimulation_tpu_torch.ops import hier as thier
from trafficsimulation_tpu_torch.ops import hopper_engine as HE

torch.set_num_threads(2)

SMALL = dict(WIDTH=64, HEIGHT=64, ROUTING_HIER=True, HIER_TILE=16,
             HIER_LMAX=8)
CONFIG5 = dict(WIDTH=1024, HEIGHT=1024, ROUTING_HIER=True)
DEST_NONE = (1 << 14) - 1
NAMES = ("pa", "pb", "pc", "pd", "pe", "pl", "flags")


def emulate_rows(consts, dest, y, x):
    """(p, r) as `HierSelect` computes them for rid `dest` at cell
    (y, x), from the kernel's constant block alone, in int64 with the
    kernel's int32 products checked to fit."""
    (ts_sh, lmax, lmax_m, lmax_sh, ntx, ntx_m, ntx_sh, direct_base, nrx,
     nr) = consts
    dest, y, x = np.broadcast_arrays(dest.astype(np.int64), y, x)
    tiled = dest < direct_base
    prod = np.where(tiled, dest, 0) * lmax_m
    td = prod >> lmax_sh
    l = dest - td * lmax
    prod2 = td * ntx_m
    ty = prod2 >> ntx_sh
    tx = td - ty * ntx
    assert prod.max() < 2**31 and prod2.max() < 2**31
    dy, dx = ty - (y >> ts_sh), tx - (x >> ts_sh)
    win = tiled & (np.abs(dy) <= 1) & (np.abs(dx) <= 1)
    p = np.where(win, ((dy + 1) * 3 + (dx + 1)) * lmax + l, -1)
    r = np.where(tiled, (ty >> 1) * nrx + (tx >> 1),
                 nr + (dest - direct_base))
    return p, r


def emulate_byte(stack4, row, c):
    """`select_nd`: byte row & 3 of word stack4[row >> 2] at flat cell c,
    7 past the stack."""
    hi = row >> 2
    hit = (hi >= 0) & (hi < stack4.shape[0])
    flat = stack4.reshape(stack4.shape[0], -1).view(np.uint32)
    w = np.where(hit, flat[np.clip(hi, 0, stack4.shape[0] - 1), c],
                 0x07070707)
    return ((w >> ((row & 3) * 8)) & 0xFF).astype(np.int32)


def every_rid_planes(cfg: TConfig) -> np.ndarray:
    """[n, H, W] rid planes in which every tile holds every rid of
    [0, 2^14) once: plane k, cell (y, x) of a tile holds
    k * ts^2 + (y mod ts) * ts + (x mod ts)."""
    ts = cfg.HIER_TILE
    y = np.arange(cfg.HEIGHT)[:, None] % ts
    x = np.arange(cfg.WIDTH)[None, :] % ts
    n = (1 << 14) // (ts * ts)
    return (np.arange(n)[:, None, None] * ts * ts + y * ts + x).astype(
        np.int32)


@pytest.mark.parametrize("kw", [SMALL, CONFIG5], ids=["64sq", "config5"])
def test_kernel_consts_reproduce_hier_rows_for_every_rid(kw):
    tcfg = TConfig(**kw)
    consts = thier.kernel_consts(tcfg)
    hp = thier.hier_params(tcfg)
    assert len(consts) == 10
    if kw is CONFIG5:
        assert consts[2] != 1          # LMAX 48: a magic multiplier
    dest = every_rid_planes(tcfg)
    assert np.array_equal(np.unique(dest), np.arange(1 << 14))
    H, W = dest.shape[1:]
    p, r = emulate_rows(consts, dest, np.arange(H)[:, None],
                        np.arange(W)[None, :])
    jp, jr = jhier.hier_rows(Config(**kw), jnp.asarray(dest))
    tp, tr = thier.hier_rows(tcfg, torch.from_numpy(dest))
    assert np.array_equal(p, np.asarray(jp))
    assert np.array_equal(r, np.asarray(jr))
    assert np.array_equal(p, tp.numpy()) and np.array_equal(r, tr.numpy())
    # the windowed stack holds every p; direct rids run past the dense rows
    assert p.max() < 9 * hp.lmax and (p >= 0).any() and (p < 0).any()
    assert r[dest == DEST_NONE].min() == hp.nr + DEST_NONE - hp.direct_base


def test_emulated_select_matches_hier_select():
    """The kernel's select, emulated from the constant block, gives both
    packages' `hier_select` bytes on random stacks (a dense stack of 5
    words, so that hub rows, direct rows and rows past it all occur)."""
    tcfg = TConfig(**SMALL)
    hp = thier.hier_params(tcfg)
    rng = np.random.default_rng(11)
    dest = every_rid_planes(tcfg)[::7]
    local4 = rng.integers(-2**31, 2**31, (9 * hp.lmax // 4, 64, 64),
                          dtype=np.int64).astype(np.int32)
    dense4 = rng.integers(-2**31, 2**31, (5, 64, 64),
                          dtype=np.int64).astype(np.int32)
    c = np.arange(64 * 64).reshape(64, 64)
    p, r = emulate_rows(thier.kernel_consts(tcfg), dest,
                        np.arange(64)[:, None], np.arange(64)[None, :])
    nd_loc = emulate_byte(local4, p, c)
    got = np.where((p >= 0) & ((nd_loc & 7) != 7), nd_loc,
                   emulate_byte(dense4, r, c))
    for k in range(dest.shape[0]):
        ref = jhier.hier_select(Config(**SMALL), jnp.asarray(dense4),
                                jnp.asarray(local4), jnp.asarray(dest[k]))
        assert np.array_equal(got[k], np.asarray(ref)), k
        tref = thier.hier_select(tcfg, torch.from_numpy(dense4),
                                 torch.from_numpy(local4),
                                 torch.from_numpy(dest[k]))
        assert np.array_equal(got[k], tref.numpy()), k


def _bits(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(
        np.uint32).view(np.int32)


def hier_inputs(seed: int, kw: dict, n_dense: int = 10):
    """numpy inputs of one hier tick at the config `kw`: (dense bytes
    [n_dense, H, W] u8, local4, wnd, planes, masks (stop, rain, ped,
    inter), dest_id, randoms).  Vehicles carry no faults and are not
    parked or stuck, so many move; their rids are windowed or not (60%),
    direct (20%), past the dense stack (10%) or DEST_NONE (10%).  The
    windowed stack holds every plane, as `init_world_hier` builds it."""
    hp = thier.hier_params(TConfig(**kw))
    H, W = kw["HEIGHT"], kw["WIDTH"]
    rng = np.random.default_rng(seed)
    # next-move bytes, most without the contraflow bit
    dense = rng.integers(0, 256, (n_dense, H, W)).astype(np.uint8)
    dense &= np.where(rng.random((n_dense, H, W)) < 0.8, 0xF7, 0xFF).astype(
        np.uint8)
    local4 = _bits(rng, 9 * hp.lmax // 4, H, W) & np.where(
        rng.random((9 * hp.lmax // 4, H, W)) < 0.8, np.int32(-0x08080809),
        np.int32(-1))
    wb = rng.integers(0, 16, (4, H, W))
    wnd = (wb[0] | (wb[1] << 8) | (wb[2] << 16) | (wb[3] << 24)).astype(
        np.int32)
    planes = [_bits(rng, H, W) for _ in range(5)] + [
        rng.random((H, W), dtype=np.float32)]
    n_direct = n_dense - hp.nr
    u = rng.random((H, W))
    rid = np.select(
        [u < 0.6, u < 0.8, u < 0.9],
        [rng.integers(0, hp.direct_base, (H, W)),
         rng.integers(hp.direct_base, hp.direct_base + n_direct, (H, W)),
         rng.integers(hp.direct_base + n_direct, DEST_NONE, (H, W))],
        DEST_NONE).astype(np.int32)
    # a third of the cells hold a vehicle, with no stuck count and no
    # contraflow allowance
    keep = (1 << 14) - 2
    present = rng.random((H, W)) < 0.3
    planes[0] = (planes[0] & keep) | present | (rid << 18)
    planes[1] &= np.int32(0x00FFF000)
    masks = (rng.random((H, W)) < 0.02, rng.random((H, W)) < 0.1,
             rng.random((H, W)) < 0.02, rng.random((H, W)) < 0.1)
    dest_id = np.where(rng.random((H, W)) < 0.05, rid, -1).astype(np.int32)
    randoms = (rng.random((H, W), dtype=np.float32),
               rng.random((H, W), dtype=np.float32),
               rng.integers(1, 6, (H, W)).astype(np.int32), _bits(rng, H, W))
    return dense, local4, wnd, planes, masks, dest_id, randoms


def jax_hier_core(cfg: Config, dense, local4, wnd, planes, masks, dest_id,
                  randoms):
    """JAX's decide + move under hierarchical routing (`step_engine`'s
    ROUTING_HIER branch): `decide_move_core` with `hier_select`; the
    outputs as int32 bits."""
    dense4 = jengine.pack_sdir4(jnp.asarray(dense))
    jl = jnp.asarray(local4)
    u32 = lambda a: jnp.asarray(a.view(np.uint32))     # noqa: E731
    out = jpe.decide_move_core(
        cfg, _shift_plane, lambda d: jhier.hier_select(cfg, dense4, jl, d),
        jnp.asarray(wnd), *(u32(p) for p in planes[:5]),
        jnp.asarray(planes[5]), *(jnp.asarray(m) for m in masks),
        jnp.asarray(dest_id), jnp.asarray(randoms[0]),
        jnp.asarray(randoms[1]), jnp.asarray(randoms[2]), u32(randoms[3]))
    return [np.asarray(o).view(np.int32) for o in out]


def port_hier(tcfg: TConfig, dense, local4, wnd, planes, masks, dest_id,
              randoms):
    """The port's `decide_move` with `hier=`, on CPU tensors."""
    t = torch.from_numpy
    got = HE.decide_move(
        tcfg, tengine.pack_sdir4(t(dense)), t(wnd),
        tuple(t(p) for p in planes), *(t(m) for m in masks), t(dest_id),
        tuple(t(r) for r in randoms),
        hier=(t(local4), thier.kernel_consts(tcfg)))
    return [(g.view(torch.int32) if g.dtype == torch.float32 else g).numpy()
            for g in got]


@pytest.mark.parametrize("seed,speed", [(0, 2), (5, 5)])
def test_k1_hier_plain_matches_jax(seed, speed):
    kw = dict(SMALL, VEHICLE_MAX_SPEED=speed, RAIN_ENABLED=True,
              VEHICLE_MALFUNCTION_ACTIVE=True,
              VEHICLE_SIDESWIPE_COLLISION_ACTIVE=True)
    args = hier_inputs(seed, kw)
    ref = jax_hier_core(Config(**kw), *args)
    n0 = dict(HE.launches)
    got = port_hier(TConfig(**kw), *args)
    assert HE.launches == n0              # the CPU launches nothing
    for name, g, r in zip(NAMES, got, ref):
        assert np.array_equal(g, r), name
    moved = (ref[6] & HE.FLAG_MOVED) != 0
    present = (args[3][0] & 1) == 1
    assert moved.sum() > 0.3 * present.sum()
    # both stacks route: some movers took the windowed byte, some the
    # dense row's
    tcfg = TConfig(**kw)
    dest = torch.from_numpy((args[3][0] >> 18) & DEST_NONE)
    p, _ = thier.hier_rows(tcfg, dest)
    loc = HE.select_dest_rows(torch.from_numpy(args[1]), p)
    use_loc = ((p >= 0) & ((loc & 7) != 7)).numpy()
    assert (moved & use_loc).any() and (moved & ~use_loc).any()


def test_hub_cell_stall_is_reproduced():
    """A vehicle at its destination region's hub cell, in the window,
    with windowed byte 7: the hub row offers no move there, so it stays
    and its stuck counter steps, in both packages."""
    kw = dict(SMALL, VEHICLE_MALFUNCTION_ACTIVE=False,
              VEHICLE_SIDESWIPE_COLLISION_ACTIVE=False, RAIN_ENABLED=False)
    tcfg = TConfig(**kw)
    hp = thier.hier_params(tcfg)
    H, W = 64, 64
    ty, tx, l = 1, 1, 3                    # the destination's tile and slot
    rid = (ty * hp.ntx + tx) * hp.lmax + l
    hub_row = (ty >> 1) * hp.nrx + (tx >> 1)
    y, x = 20, 21                          # the hub cell, in tile (1, 1)
    c = y * W + x
    rng = np.random.default_rng(2)
    # every other byte offers a move; at the hub cell the windowed byte
    # (window centre, slot l) and the hub row's byte are 7
    local = rng.integers(0, 7, (9 * hp.lmax, H, W)).astype(np.uint8)
    local[4 * hp.lmax + l, y, x] = 7
    dense = rng.integers(0, 7, (hp.nr, H, W)).astype(np.uint8)
    dense[hub_row, y, x] = 7
    local4 = tengine.pack_sdir4(torch.from_numpy(local)).numpy()
    stuck0 = 4
    planes = [np.zeros((H, W), np.int32) for _ in range(5)] + [
        np.zeros((H, W), np.float32)]
    # present, base speed 3, cruising at 3, heading north (+1)
    planes[0][y, x] = 1 | (1 << 3) | (3 << 6) | (3 << 10) | (rid << 18)
    planes[1][y, x] = stuck0
    wnd = np.full((H, W), HE.ND_NONE4, np.int32)
    masks = tuple(np.zeros((H, W), bool) for _ in range(4))
    dest_id = np.full((H, W), -1, np.int32)
    randoms = (np.ones((H, W), np.float32), np.ones((H, W), np.float32),
               np.full((H, W), 3, np.int32), np.zeros((H, W), np.int32))
    args = (dense, local4, wnd, planes, masks, dest_id, randoms)
    # the premise: the select at the hub cell offers no move
    nd = thier.hier_select(tcfg, tengine.pack_sdir4(torch.from_numpy(dense)),
                           torch.from_numpy(local4),
                           torch.full((H, W), rid, dtype=torch.int32))
    assert int(nd[y, x]) & 7 == 7
    ref = jax_hier_core(Config(**kw), *args)
    got = port_hier(tcfg, *args)
    for name, g, r in zip(NAMES, got, ref):
        assert np.array_equal(g, r), name
    for pa, pb, flags in ((ref[0], ref[1], ref[6]), (got[0], got[1], got[6])):
        assert flags[y, x] & HE.FLAG_MOVED == 0
        assert pa[y, x] & 1 and (pa & 1).sum() == 1
        assert (pa[y, x] >> 18) & DEST_NONE == rid
        assert pb[y, x] & 4095 == stuck0 + 1
