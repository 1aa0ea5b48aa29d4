"""K3's tiled design (csrc/wavefront.cu) held to the reference on the CPU.

A numpy emulation of the kernel's algorithm: tiles with a halo of
K_OVT + 1 cells staged with the grid-edge fills (road False, hard True,
no legal flow), the four can-move bits and the seed bytes per cell, the
relax steps on byte values over a window that shrinks by one cell a
step (every cell outside it poisoned, so a read the kernel would make of
a value it never computed shows up), then the argmin and the pack.  It
must equal JAX's `wavefront_core` (jitted, padded shifts), JAX's
`build_wavefront_pallas` in interpret mode and the port's plain version,
on small grids cut by small tiles so that tile edges and grid edges both
cross wavefronts.  A halo one cell shorter gives other bits, so the
K_OVT + 1 is needed; a source beyond it lies too far from the tile to
give a byte the pack takes (the derivation is in wavefront.cu).  The
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu.config import Config as JConfig
from trafficsimulation_tpu.ops import pallas_engine
from trafficsimulation_tpu.ops.routing import _shift_plane as jshift

from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.ops import hopper_engine as HE

torch.set_num_threads(2)

BIGW = 127
DY = (1, 0, -1, 0)          # N (+y), E (+x), S (-y), W (-x)
DX = (0, 1, 0, -1)
SRC = (Path(HE.__file__).resolve().parent.parent / "csrc"
       / "wavefront.cu").read_text()


def _rshift(a, m, fill):
    """a at each region cell's neighbour in direction m, `fill` where
    that neighbour lies outside the region."""
    out = np.full_like(a, fill)
    RH, RW = a.shape
    dy, dx = DY[m], DX[m]
    ys, yd = slice(max(dy, 0), RH + min(dy, 0)), slice(max(-dy, 0),
                                                        RH + min(-dy, 0))
    xs, xd = slice(max(dx, 0), RW + min(dx, 0)), slice(max(-dx, 0),
                                                        RW + min(-dx, 0))
    out[yd, xd] = a[ys, xs]
    return out


def emulate(allowed, road, hard, k, th, tw, halo, poison=0):
    """The kernel's result for the worlds of `hard` [B, H, W] over the
    shared `allowed` / `road` [H, W], with th x tw tiles and `halo`."""
    H, W = allowed.shape
    out = np.zeros(hard.shape, np.int64)
    RH, RW = th + 2 * halo, tw + 2 * halo
    for b in range(hard.shape[0]):
        for ty in range(0, H, th):
            for tx in range(0, W, tw):
                ys = np.arange(ty - halo, ty - halo + RH)[:, None]
                xs = np.arange(tx - halo, tx - halo + RW)[None, :]
                inside = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
                yc, xc = np.clip(ys, 0, H - 1), np.clip(xs, 0, W - 1)
                legal = np.where(inside, allowed[yc, xc] & 15, 0)
                rd = np.where(inside, road[yc, xc], False)
                hd = np.where(inside, hard[b][yc, xc], True)
                can = [((((legal >> m) & 1) != 0) | _rshift(rd, m, False))
                       & ~_rshift(hd, m, True) for m in range(4)]
                free = rd & ~hd
                # byte d: blocked direction d; the blocker at opposite(d)
                v = np.stack([np.where(
                    free & _rshift(hd, (d + 2) & 3, False)
                    & (_rshift((legal >> d) & 1, (d + 2) & 3, 0) != 0),
                    0, BIGW) for d in range(4)])
                for i in range(1, k + 1):
                    best = np.full_like(v, BIGW)
                    for m in range(4):
                        nb = np.stack([_rshift(v[d], m, poison)
                                       for d in range(4)])
                        best = np.where(can[m][None], np.minimum(best, nb),
                                        best)
                    new = np.full_like(v, poison)
                    win = (slice(None), slice(i, RH - i), slice(i, RW - i))
                    new[win] = np.minimum(v, best + 1)[win]
                    v = new
                nv = [np.stack([np.where(can[m], _rshift(v[d], m, poison),
                                         BIGW) for d in range(4)])
                      for m in range(4)]
                word = np.zeros((RH, RW), np.int64)
                for d in range(4):
                    wbest = np.full((RH, RW), BIGW)
                    warg = np.full((RH, RW), 7)
                    for m in range(4):
                        upd = nv[m][d] < wbest
                        wbest = np.where(upd, nv[m][d], wbest)
                        warg = np.where(upd, m, warg)
                    valid = (v[d] <= k) & (wbest < v[d])
                    contra = 1 - ((legal >> np.minimum(warg, 4)) & 1)
                    byte = np.where(valid, warg | (contra << 3), 7)
                    word |= byte << (8 * d)
                h1, w1 = min(th, H - ty), min(tw, W - tx)
                out[b, ty:ty + h1, tx:tx + w1] = \
                    word[halo:halo + h1, halo:halo + w1]
    return out.astype(np.uint32).view(np.int32)


def _planes(seed, B, H=24, W=40, p_hard=0.3):
    rng = np.random.default_rng(seed)
    allowed = rng.integers(0, 16, (H, W)).astype(np.uint8)
    road = rng.random((H, W)) < 0.7
    hard = (rng.random((B, H, W)) < p_hard) & road
    return allowed, road, hard


_JIT = {}


def _jax_ref(k, allowed, road, hard):
    """JAX's wavefront_core under jit with padded shifts, per world."""
    fn = _JIT.get(k)
    if fn is None:
        cfg = JConfig(WIDTH=allowed.shape[1], HEIGHT=allowed.shape[0],
                      VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS=k)
        fn = _JIT[k] = jax.jit(lambda a, r, h: pallas_engine.wavefront_core(
            cfg, jshift, a, r, h))
    a = jnp.asarray(allowed.astype(np.int32))
    return np.stack([np.asarray(fn(a, jnp.asarray(road), jnp.asarray(h)))
                     .view(np.int32) for h in hard])


def _port_plain(k, allowed, road, hard):
    cfg = Config(WIDTH=allowed.shape[1], HEIGHT=allowed.shape[0],
                 VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS=k)
    return HE.build_wavefront_batched(
        cfg, torch.from_numpy(allowed), torch.from_numpy(road),
        torch.from_numpy(hard)).numpy()


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_tiled_emulation_matches_jax_and_plain(k, B):
    """8 x 8 tiles with the K_OVT + 1 halo on a 24 x 40 grid: equal to
    JAX's jitted core and to the port's plain version, world by world;
    every byte form occurs (none, a move, a contraflow move)."""
    allowed, road, hard = _planes(10 * k + B, B)
    ref = _jax_ref(k, allowed, road, hard)
    got = emulate(allowed, road, hard, k, 8, 8, k + 1)
    assert np.array_equal(got, ref)
    assert np.array_equal(_port_plain(k, allowed, road, hard), ref)
    b = got.view(np.uint32)
    bytes_ = np.stack([(b >> (8 * d)) & 0xFF for d in range(4)])
    assert (bytes_ == 7).any() and (bytes_ < 4).any() and \
        ((bytes_ & 8) != 0).any() and ((bytes_ != 7) & (bytes_ >= 4)
                                       & (bytes_ < 8)).sum() == 0


@pytest.mark.parametrize("k,th", [(1, 16), (6, 32)])
def test_tiled_emulation_matches_pallas_interpret(k, th):
    """The emulation with the kernel's own tiles (32 wide, 16 or 32
    high) on a grid they do not divide equals JAX's Pallas kernel in
    interpret mode."""
    allowed, road, hard = _planes(k, 1, H=40, W=72, p_hard=0.2)
    cfg = JConfig(WIDTH=72, HEIGHT=40,
                  VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS=k)
    ref = np.asarray(pallas_engine.build_wavefront_pallas(
        cfg, jnp.asarray(allowed.astype(np.int32)), jnp.asarray(road),
        jnp.asarray(hard[0]), interpret=True)).view(np.int32)
    got = emulate(allowed, road, hard, k, th, 32, k + 1)
    assert np.array_equal(got[0], ref)


@pytest.mark.parametrize("k", [1, 3, 6])
def test_a_shorter_halo_differs(k):
    """With K_OVT cells of halo the tiles' edges give other bits (a seed
    the region misses lies K_OVT cells from the tile and reaches it);
    one more cell (the seed's blocker) changes nothing."""
    allowed, road, hard = _planes(5 + k, 2, p_hard=0.15)
    ref = _jax_ref(k, allowed, road, hard)
    assert np.array_equal(emulate(allowed, road, hard, k, 8, 8, k + 2),
                          ref)
    short = emulate(allowed, road, hard, k, 8, 8, k)
    assert (short != ref).any()


def test_kernel_constants_match_the_wrapper():
    """The wrapper's limit on K_OVT and the tiles the emulation takes
    are the kernel's."""
    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", SRC).group(1))
    assert const("WF_KMAX") == HE.WAVEFRONT_KMAX
    assert const("WF_TW") == 32
    assert "wf_launch<16>" in SRC and "wf_launch<32>" in SRC
    cfg = Config(WIDTH=8, HEIGHT=4)
    assert cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS <= HE.WAVEFRONT_KMAX
