"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`: they skip without a CUDA device (this file imports
no JAX, so it also runs on a machine without it):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest \
        -o addopts="" -p no:cacheprovider

Shapes are small and deliberately ragged (not multiples of the 256-thread
blocks, rows longer than one scan tile, a packed word half past D).  The
batched kernels hold each world to its plain version, and their B = 1
call to the single-world kernel; under `torch.func.vmap` each wrapper
launches once for the whole batch."""

import numpy as np
import pytest
import torch

from trafficsimulation_tpu_torch.config import Config

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


def _dm_inputs(g, B, H, W, D):
    sdir4 = torch.stack([engine.pack_sdir4(_rint(g, 0, 256, D, H, W).to(
        torch.uint8)) for _ in range(B)])
    wb = _rint(g, 0, 16, B, 4, H, W)
    wnd = wb[:, 0] | (wb[:, 1] << 8) | (wb[:, 2] << 16) | (wb[:, 3] << 24)
    planes = tuple(_rint(g, -2**31, 2**31, B, H, W) for _ in range(5)) + (
        torch.rand((B, H, W), generator=g, device="cuda"),)
    masks = tuple(_bern(g, p, B, H, W) for p in (0.15, 0.1, 0.02))
    inter = _bern(g, 0.1, H, W)
    dest = _rint(g, -1, D, H, W)
    randoms = (torch.rand((B, H, W), generator=g, device="cuda"),
               torch.rand((B, H, W), generator=g, device="cuda"),
               _rint(g, 1, 6, B, H, W), _rint(g, -2**31, 2**31, B, H, W))
    return sdir4, wnd, planes, masks, inter, dest, randoms


@pytest.mark.parametrize("B", [1, 3])
def test_decide_move_batched_matches_plain(gen, B):
    H, W, D = 37, 300, 10
    cfg = Config(WIDTH=W, HEIGHT=H, VEHICLE_MALFUNCTION_CHANCE=0.01,
                 VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    sdir4, wnd, planes, masks, inter, dest, randoms = _dm_inputs(
        gen, B, H, W, D)
    n0 = HE.launches["decide_move"]
    got = HE.decide_move_batched(cfg, sdir4, wnd, planes, *masks, inter,
                                 dest, randoms)
    assert HE.launches["decide_move"] == n0 + 1
    for b in range(B):
        ref = HE.decide_move_core(
            cfg, sdir4[b], wnd[b], *(p[b] for p in planes),
            *(m[b] for m in masks), inter, dest, *(r[b] for r in randoms))
        _same([o[b] for o in got], ref)
        one = HE.decide_move(cfg, sdir4[b], wnd[b],
                             tuple(p[b] for p in planes),
                             *(m[b] for m in masks), inter, dest,
                             tuple(r[b] for r in randoms))
        _same(one, ref)


@pytest.mark.parametrize("D", [8, 10])
def test_sdir_batched_kernel_matches_plain(gen, D):
    H, W, B = 33, 270, 3
    q = _rint(gen, 0, 60000, D, 4, H, W)
    q = torch.where(_bern(gen, 0.15, D, 4, H, W), 65535, q)
    K0 = engine.costs_u16_to_keys(q)
    pen4b = torch.where(_bern(gen, 0.1, B, 4, H, W), 1 << 17,
                        _rint(gen, 0, 3000, B, 4, H, W))
    legal4 = _bern(gen, 0.6, 4, H, W).to(torch.int32)
    n0 = HE.launches["build_sdir_batched"]
    got = HE.build_sdir_batched(K0, pen4b, legal4, 20)
    assert HE.launches["build_sdir_batched"] == n0 + 1
    _same((got,), (HE.sdir_encode_batched(K0, pen4b, legal4, 20),))
    # B = 1 of K5 is K2
    for b in range(B):
        _same((HE.build_sdir_batched(K0, pen4b[b:b + 1].contiguous(),
                                     legal4, 20)[0],),
              (HE.build_sdir(K0, pen4b[b].contiguous(), legal4, 20),))


def test_sdir_batched_kernel_large_batch(gen):
    """B = 19 runs as two register groups of worlds (16 + 3)."""
    H, W, D, B = 16, 40, 9, 19
    K0 = engine.costs_u16_to_keys(_rint(gen, 0, 65536, D, 4, H, W))
    pen4b = _rint(gen, 0, 3000, B, 4, H, W)
    legal4 = _bern(gen, 0.6, 4, H, W).to(torch.int32)
    _same((HE.build_sdir_batched(K0, pen4b, legal4, 20),),
          (HE.sdir_encode_batched(K0, pen4b, legal4, 20),))


@pytest.mark.parametrize("B", [1, 3])
def test_wavefront_batched_matches_plain(gen, B):
    H, W = 45, 77
    cfg = Config(WIDTH=W, HEIGHT=H)
    allowed = _rint(gen, 0, 16, H, W).to(torch.uint8)
    road = _bern(gen, 0.5, H, W)
    hard = _bern(gen, 0.1, B, H, W) & road
    got = HE.build_wavefront_batched(cfg, allowed, road, hard)
    for b in range(B):
        ref = HE.wavefront_core(cfg, allowed, road, hard[b])
        _same((got[b],), (ref,))
        _same((HE.build_wavefront(cfg, allowed, road, hard[b]),), (ref,))


@pytest.mark.parametrize("B", [1, 4])
def test_prefix_batched_matches_plain(gen, B):
    occ = _rint(gen, 0, 3, B, 300, 520)
    got = HE.prefix_planes_batched(occ)
    _same(got, HE.prefix_planes_plain(occ))
    for b in range(B):
        _same(HE.prefix_planes(occ[b]), [x[b] for x in got])


def test_vmapped_wrappers_launch_once_per_batch(gen):
    B, H, W = 5, 40, 60
    occ = _rint(gen, 0, 2, B, H, W)
    n0 = dict(HE.launches)
    got = torch.func.vmap(HE.prefix_planes)(occ)
    assert HE.launches["prefix_planes"] == n0["prefix_planes"] + 1
    _same(got, HE.prefix_planes_plain(occ))
    D = 8
    K0 = engine.costs_u16_to_keys(_rint(gen, 0, 65536, D, 4, H, W))
    pen4b = _rint(gen, 0, 3000, B, 4, H, W)
    legal4 = _bern(gen, 0.6, 4, H, W).to(torch.int32)
    got = torch.func.vmap(HE.build_sdir, in_dims=(None, 0, None, None))(
        K0, pen4b, legal4, 20)
    assert HE.launches["build_sdir_batched"] == \
        n0["build_sdir_batched"] + 1
    assert HE.launches["build_sdir"] == n0["build_sdir"]
    _same((got,), (HE.sdir_encode_batched(K0, pen4b, legal4, 20),))


def test_ordered_add_is_update_order(gen):
    """Duplicate indices whose f32 sum depends on the order: the card
    folds them in update order from the stored value, bit for bit the
    CPU plain version (XLA's CPU scatter-add order)."""
    base = torch.tensor([[1.0, 0.0, 5.0], [0.0, 3.0, 0.0]])
    idx = torch.tensor([[0, 0, 0, 2, 1, 0], [1, 1, 1, 1, 3, -1]])
    vals = torch.tensor([[1e8, 1.0, -1e8, 2.0, 7.0, 0.5],
                         [1e8, -1e8, 1.0, 1.0, 9.0, 9.0]])
    want = base.numpy().copy()
    for r in range(2):
        for i, v in zip(idx[r].tolist(), vals[r].numpy()):
            if 0 <= i < 3:
                want[r, i] = np.float32(want[r, i] + v)
    cpu = HE.ordered_add_plain(base, idx, vals)
    assert np.array_equal(cpu.numpy().view(np.int32), want.view(np.int32))
    n0 = HE.launches["ordered_add"]
    got = HE.ordered_add(base.cuda(), idx.cuda(), vals.cuda())
    assert HE.launches["ordered_add"] == n0 + 1
    _same((got.cpu(),), (cpu,))
    # a fold in another order gives another f32 result here
    assert want[0, 0] != np.float32(1.0) + np.float32(
        np.float32(1e8) - np.float32(1e8)) + np.float32(1.5)


@pytest.mark.parametrize("D4,shape", [(27, (64, 96)), (5, (37, 300))])
def test_select_rows_kernel_matches_plain(gen, D4, shape):
    """K6 against `select_dest_rows`: dest planes holding negative rows
    (-1 from `hier_rows`) and rows past the stack."""
    H, W = shape
    sdir4 = _rint(gen, -2**31, 2**31, D4, H, W)
    dest = _rint(gen, -6, 4 * D4 + 9, H, W)
    n0 = HE.launches["select_rows"]
    got = HE.select_rows(sdir4, dest)
    assert HE.launches["select_rows"] == n0 + 1
    _same((got,), (HE.select_dest_rows(sdir4, dest),))
    assert bool(((got == 7) | (dest >> 2 < D4) & (dest >= 0)).all())


def test_hier_select_launches_k6_twice(gen):
    """`hier_select` on the card: two K6 launches, the same bytes as the
    plain selects."""
    from trafficsimulation_tpu_torch.ops import hier
    cfg = Config(WIDTH=64, HEIGHT=64, ROUTING_HIER=True, HIER_TILE=16,
                 HIER_LMAX=8)
    hp = hier.hier_params(cfg)
    local4 = _rint(gen, -2**31, 2**31, 9 * hp.lmax // 4, 64, 64)
    dense4 = _rint(gen, -2**31, 2**31, 3, 64, 64)
    dest = _rint(gen, 0, hp.direct_base + 8, 64, 64)
    n0 = HE.launches["select_rows"]
    got = hier.hier_select(cfg, dense4, local4, dest)
    assert HE.launches["select_rows"] == n0 + 2
    p, r = hier.hier_rows(cfg, dest)
    nd_loc = HE.select_dest_rows(local4, p)
    ref = torch.where((p >= 0) & ((nd_loc & 7) != 7), nd_loc,
                      HE.select_dest_rows(dense4, r))
    _same((got,), (ref,))
