"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`: they skip without a CUDA device (this file imports
no JAX, so it also runs on a machine without it):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest \
        -o addopts="" -p no:cacheprovider

Shapes are small and deliberately ragged (not multiples of the 256-thread
blocks, rows longer than one scan tile, a packed word half past D)."""

import pytest
import torch

from trafficsimulation_tpu.config import Config

from trafficsimulation_tpu_torch.ops import engine
from trafficsimulation_tpu_torch.ops import hopper_engine as HE

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(1)


def _rint(g, lo, hi, *shape):
    return torch.randint(lo, hi, shape, generator=g, device="cuda",
                         dtype=torch.int64).to(torch.int32)


def _bern(g, p, *shape):
    return torch.rand(shape, generator=g, device="cuda") < p


def _same(got, ref):
    for a, b in zip(got, ref):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(64, 96), (37, 300)])
def test_decide_move_kernel_matches_plain(gen, shape):
    H, W = shape
    D = 10
    cfg = Config(WIDTH=W, HEIGHT=H, VEHICLE_MALFUNCTION_CHANCE=0.01,
                 VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    sdir4 = engine.pack_sdir4(_rint(gen, 0, 256, D, H, W).to(torch.uint8))
    wb = _rint(gen, 0, 16, 4, H, W)
    wnd = wb[0] | (wb[1] << 8) | (wb[2] << 16) | (wb[3] << 24)
    planes = tuple(_rint(gen, -2**31, 2**31, H, W) for _ in range(5)) + (
        torch.rand((H, W), generator=gen, device="cuda"),)
    masks = tuple(_bern(gen, p, H, W) for p in (0.15, 0.1, 0.02, 0.1))
    dest = _rint(gen, -1, D, H, W)
    randoms = (torch.rand((H, W), generator=gen, device="cuda"),
               torch.rand((H, W), generator=gen, device="cuda"),
               _rint(gen, 1, 6, H, W), _rint(gen, -2**31, 2**31, H, W))
    n0 = HE.launches["decide_move"]
    got = HE.decide_move(cfg, sdir4, wnd, planes, *masks, dest, randoms)
    assert HE.launches["decide_move"] == n0 + 1
    ref = HE.decide_move_core(cfg, sdir4, wnd, *planes, *masks, dest,
                              *randoms)
    _same(got, ref)


@pytest.mark.parametrize("D", [8, 10])
def test_sdir_kernel_matches_plain(gen, D):
    H, W = 33, 270
    q = _rint(gen, 0, 60000, D, 4, H, W)
    q = torch.where(_bern(gen, 0.15, D, 4, H, W), 65535, q)
    K0 = engine.costs_u16_to_keys(q)
    pen4 = torch.where(_bern(gen, 0.1, 4, H, W), 1 << 17,
                       _rint(gen, 0, 3000, 4, H, W))
    legal4 = _bern(gen, 0.6, 4, H, W).to(torch.int32)
    _same((HE.build_sdir(K0, pen4, legal4, 20),),
          (HE.sdir_encode(K0, pen4, legal4, 20),))


def test_wavefront_kernel_matches_plain(gen):
    H, W = 45, 77
    cfg = Config(WIDTH=W, HEIGHT=H)
    allowed = _rint(gen, 0, 16, H, W).to(torch.uint8)
    road = _bern(gen, 0.5, H, W)
    hard = _bern(gen, 0.1, H, W) & road
    _same((HE.build_wavefront(cfg, allowed, road, hard),),
          (HE.wavefront_core(cfg, allowed, road, hard),))


@pytest.mark.parametrize("shape", [(8, 16), (300, 520), (513, 7)])
def test_prefix_kernel_matches_plain(gen, shape):
    occ = _rint(gen, 0, 3, *shape)
    _same(HE.prefix_planes(occ), HE.prefix_planes_plain(occ))


def test_kernels_reject_what_they_do_not_take(gen):
    occ = _rint(gen, 0, 2, 8, 16)
    with pytest.raises(TypeError):
        HE.prefix_planes(occ.to(torch.int64))
    with pytest.raises(ValueError):
        HE.prefix_planes(occ.t())
