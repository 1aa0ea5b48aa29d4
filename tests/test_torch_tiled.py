"""K7's plain version (`hopper_engine.decide_move_tiled` on CPU tensors)
against the JAX package's whole-grid `decide_move_core`, bit for bit on
every output plane, the port's `pick_tile` against JAX's, and K7's
launch plan (`k7_plan`: one block a window, or ValueError).

The inputs are those of the JAX package's own tiled-kernel test
(tests/test_pallas_engine.py, random packed planes at 64^2 with D = 8),
drawn with numpy, plus a case whose vehicles all hold destinations
inside the stack, so that most of them move and the contamination of a
window's edge reaches as deep as it can.  JAX's `decide_move_core` is
that test's own reference; it runs here op by op (no compile of the
tiled Pallas kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu.config import Config
from trafficsimulation_tpu.ops import engine as jengine
from trafficsimulation_tpu.ops import pallas_engine as jpe
from trafficsimulation_tpu.ops.routing import _shift_plane

from trafficsimulation_tpu_torch.config import Config as TConfig
from trafficsimulation_tpu_torch.ops import engine as tengine
from trafficsimulation_tpu_torch.ops import hopper_engine as HE

torch.set_num_threads(2)

H = W = 64
D = 8
KW = dict(WIDTH=W, HEIGHT=H, RAIN_ENABLED=True,
          VEHICLE_MALFUNCTION_ACTIVE=True,
          VEHICLE_SIDESWIPE_COLLISION_ACTIVE=True, VEHICLE_MIN_SPEED=1,
          VEHICLE_MAX_SPEED=5, MAX_VEHICLES=64, MAX_FIELD_DESTS=8)
NAMES = ("pa", "pb", "pc", "pd", "pe", "pl", "flags")


def _inputs(seed: int, movers: bool, H: int = H, W: int = W):
    """numpy inputs: (sdir bytes [D, H, W] u8, wnd, planes, stop, rain,
    ped, inter, dest, randoms); the u32 planes as int32 bits."""
    rng = np.random.default_rng(seed)

    def bits():
        return rng.integers(0, 2**32, (H, W), dtype=np.uint64).astype(
            np.uint32).view(np.int32)
    sdir = rng.integers(0, 256, (D, H, W)).astype(np.uint8)
    wb = rng.integers(0, 16, (4, H, W))
    wnd = (wb[0] | (wb[1] << 8) | (wb[2] << 16) | (wb[3] << 24)).astype(
        np.int32)
    planes = [bits() for _ in range(5)] + [
        rng.random((H, W), dtype=np.float32)]
    stop = rng.random((H, W)) < (0.02 if movers else 0.15)
    if movers:
        # destinations in the stack; no faults, not parked, not stuck
        keep = (1 << 14) - 1
        pa = planes[0] & keep & ~(1 << 14)
        planes[0] = pa | (rng.integers(0, D, (H, W)).astype(np.int32) << 18)
    masks = (stop, rng.random((H, W)) < 0.1, rng.random((H, W)) < 0.02,
             rng.random((H, W)) < 0.1)
    dest = rng.integers(-1, D, (H, W)).astype(np.int32)
    randoms = (rng.random((H, W), dtype=np.float32),
               rng.random((H, W), dtype=np.float32),
               rng.integers(1, 6, (H, W)).astype(np.int32), bits())
    return sdir, wnd, planes, masks, dest, randoms


def _case(seed: int, movers: bool, H: int = H, W: int = W):
    """The inputs and JAX's whole-grid outputs (as int32 bits)."""
    sdir, wnd, planes, masks, dest, randoms = _inputs(seed, movers, H, W)
    cfg = Config(**{**KW, "WIDTH": W, "HEIGHT": H})
    jsd = jengine.pack_sdir4(jnp.asarray(sdir))
    u32 = lambda a: jnp.asarray(a.view(np.uint32))     # noqa: E731
    ref = jpe.decide_move_core(
        cfg, _shift_plane, lambda d: jengine.select_dest_rows(jsd, d),
        jnp.asarray(wnd), *(u32(p) for p in planes[:5]),
        jnp.asarray(planes[5]),
        *(jnp.asarray(m) for m in masks), jnp.asarray(dest),
        jnp.asarray(randoms[0]), jnp.asarray(randoms[1]),
        jnp.asarray(randoms[2]), u32(randoms[3]))
    ref = [np.asarray(r).view(np.int32) for r in ref]
    t = torch.from_numpy
    args = (tengine.pack_sdir4(t(sdir)), t(wnd),
            tuple(t(p) for p in planes), *(t(m) for m in masks), t(dest),
            tuple(t(r) for r in randoms))
    return args, ref


@pytest.fixture(scope="module", params=[(0, False), (3, False), (1, True)],
                ids=["seed0", "seed3", "movers"])
def case(request):
    return _case(*request.param)


@pytest.mark.parametrize("tile", [(16, 32), (32, 32)])
def test_decide_move_tiled_matches_jax_core(case, tile):
    args, ref = case
    n0 = HE.launches["decide_move_tiled"]
    got = HE.decide_move_tiled(TConfig(**KW), *args, *tile)
    assert HE.launches["decide_move_tiled"] == n0   # the CPU launches none
    for name, g, r in zip(NAMES, got, ref):
        g = g.view(torch.int32) if g.dtype == torch.float32 else g
        assert g.shape == (H, W)
        assert np.array_equal(g.numpy(), r), name
    assert ((ref[6] & HE.FLAG_MOVED) != 0).any()


def test_decide_move_tiled_window_width_not_a_multiple_of_32():
    """32 x 48 tiles of a 64 x 96 grid: 64 x 80 windows, whose last
    32-wide tile column the kernel's block covers only in part."""
    args, ref = _case(1, True, 64, 96)
    got = HE.decide_move_tiled(TConfig(**{**KW, "WIDTH": 96}), *args, 32, 48)
    for name, g, r in zip(NAMES, got, ref):
        g = g.view(torch.int32) if g.dtype == torch.float32 else g
        assert np.array_equal(g.numpy(), r), name
    assert ((ref[6] & HE.FLAG_MOVED) != 0).any()
    assert HE.k7_plan(64, 96, 32, 48, H100_SMEM)[1] == 8 * 3


# the shared memory a block may take on the H100 (opt-in)
H100_SMEM = 232_448


@pytest.mark.parametrize("grid,tile,want", [
    ((256, 256), (64, 64), (16, 36, 119_808)),
    ((256, 256), (16, 32), (128, 12, 39_936)),
    ((64, 96), (32, 48), (4, 24, 74_752)),
    ((64, 64), (32, 32), (4, 16, 53_248)),
])
def test_k7_plan(grid, tile, want):
    """One block a window at the H100's shared memory: (blocks, tiles of
    32 x 8 a block, dynamic shared memory bytes)."""
    assert HE.k7_plan(*grid, *tile, H100_SMEM) == want


def test_k7_plan_raises_past_one_block():
    # a 160 x 160 window (128 x 128 tiles) takes 100 tiles, past 64
    with pytest.raises(ValueError, match="100 tiles"):
        HE.k7_plan(256, 256, 128, 128, H100_SMEM)
    # a 96 x 96 window takes 36 tiles but 120,580 bytes: past a block
    # that may take 100,000
    HE.k7_plan(256, 256, 64, 64, 120_580)
    with pytest.raises(ValueError, match="120580 bytes"):
        HE.k7_plan(256, 256, 64, 64, 100_000)
    with pytest.raises(ValueError):         # 24 does not divide 256
        HE.k7_plan(256, 256, 24, 32, H100_SMEM)


def test_k7_plan_admits_what_jax_budget_admits():
    """Every window of a tile whose width is a multiple of 32, within the
    JAX kernel's VMEM budget (`pick_tile`: 1060 bytes a window cell
    under 15 MB), fits one block at the H100's numbers."""
    P = HE.TILE_HALO
    n = 0
    for th in range(8, 256, 8):
        for tw in range(32, 256, 32):
            cells = (th + 2 * P) * (tw + 2 * P)
            if 1060 * cells >= 15 * 1024 * 1024 or (tw + 2 * P) % 32:
                continue
            HE.k7_plan(th, tw, th, tw, H100_SMEM)
            n += 1
    assert n > 40


def test_decide_move_tiled_rejects_a_tiling_that_does_not_divide():
    sdir, wnd, planes, masks, dest, randoms = _inputs(0, False)
    t = torch.from_numpy
    args = (tengine.pack_sdir4(t(sdir)), t(wnd),
            tuple(t(p) for p in planes), *(t(m) for m in masks), t(dest),
            tuple(t(r) for r in randoms))
    for tile in ((24, 32), (32, 48), (0, 32)):
        with pytest.raises(ValueError):
            HE.decide_move_tiled(TConfig(**KW), *args, *tile)


@pytest.mark.parametrize("size,D", [((64, 64), 8), ((128, 128), 64),
                                    ((256, 256), 608), ((128, 96), 16),
                                    ((1024, 1024), 144), ((64, 192), 4)])
def test_pick_tile_matches_jax(size, D):
    h, w = size
    assert HE.pick_tile(TConfig(WIDTH=w, HEIGHT=h), D) == \
        jpe.pick_tile(Config(WIDTH=w, HEIGHT=h), D)
    assert HE.TILE_HALO == jpe.TILE_HALO
