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
from trafficsimulation_tpu_torch.core.state import sidewalk_count

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


def _device_kernels(fn, reps=10):
    """(names, count) of the device kernels one call of fn runs: the
    profiler's over `reps` calls after two warm-up calls inside its
    window.  The profiler may drop some calls' kernels, so each kernel
    counts its recorded launches over `reps`, rounded, at least once
    where any was recorded; a profile that records no kernel is taken
    again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=2, active=reps,
                                       repeat=1)) as prof:
            for _ in range(reps + 2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        per = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count]
        if per:
            break
    names = [k for k, c in per for _ in range(max(1, round(c / reps)))]
    return names, len(names)


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
    """B = 19 runs as two blocks of worlds (16 + 3)."""
    H, W, D, B = 16, 40, 9, 19
    K0 = engine.costs_u16_to_keys(_rint(gen, 0, 65536, D, 4, H, W))
    pen4b = _rint(gen, 0, 3000, B, 4, H, W)
    legal4 = _bern(gen, 0.6, 4, H, W).to(torch.int32)
    _same((HE.build_sdir_batched(K0, pen4b, legal4, 20),),
          (HE.sdir_encode_batched(K0, pen4b, legal4, 20),))


def _k5_inputs(g, D, B, H, W):
    """A key stack with unreachable rows, small costs (ties between moves,
    keys at the straight bound), costs near KBIG (bounds at the cap), and
    pens at 1 << 17."""
    x = torch.where(_bern(g, 0.5, D, 4, H, W), _rint(g, 0, 8, D, 4, H, W),
                    _rint(g, 0, 60000, D, 4, H, W))
    x = torch.where(_bern(g, 0.1, D, 4, H, W), HE.KBIG, x)
    x = torch.where(_bern(g, 0.05, D, 4, H, W),
                    HE.KBIG - _rint(g, 1, 6, D, 4, H, W), x)
    x[D // 2] = HE.KBIG
    m = torch.arange(4, dtype=torch.int32, device="cuda").reshape(1, 4, 1, 1)
    K0 = (x << 2) | m
    pen4b = torch.where(_bern(g, 0.5, B, 4, H, W), _rint(g, 0, 4, B, 4, H, W),
                        _rint(g, 0, 3000, B, 4, H, W))
    pen4b = torch.where(_bern(g, 0.1, B, 4, H, W), 1 << 17, pen4b)
    return K0, pen4b, _bern(g, 0.6, 4, H, W).to(torch.int32)


@pytest.mark.parametrize("D,tp2,shape", [(10, 20, (17, 130)),
                                         (7, 0, (16, 136)),
                                         (170, 3, (8, 64))])
@pytest.mark.parametrize("B", [1, 2, 3, 5, 16, 17])
def test_sdir_batched_kernel_every_batch_form(gen, B, D, tp2, shape):
    """K5's forms (1, 2 or 4 worlds a thread, 1, 2 or 4 groups a block,
    a second block of worlds past 16) against its plain version: ragged
    D (rows past D, two runs of words at D = 170), cells not a multiple
    of 4 (the 4-byte copies), tp2 = 0, ties, keys at the bound and near
    KBIG; at B = 1 also against K2."""
    K0, pen4b, legal4 = _k5_inputs(gen, D, B, *shape)
    n0 = HE.launches["build_sdir_batched"]
    got = HE.build_sdir_batched(K0, pen4b, legal4, tp2)
    assert HE.launches["build_sdir_batched"] == n0 + 1
    _same((got,), (HE.sdir_encode_batched(K0, pen4b, legal4, tp2),))
    if B == 1:
        _same((got[0],), (HE.build_sdir(K0, pen4b[0], legal4, tp2),))


def test_sdir_batched_kernel_unaligned_keys(gen):
    """A K0 view that starts 4 bytes past a 16-byte boundary (HW a
    multiple of 4) takes the 4-byte copies and gives the same stack."""
    D, B, H, W = 9, 3, 16, 136
    K0, pen4b, legal4 = _k5_inputs(gen, D, B, H, W)
    flat = torch.empty(K0.numel() + 1, dtype=torch.int32, device="cuda")
    K0u = flat[1:].view(K0.shape)
    K0u.copy_(K0)
    assert K0u.is_contiguous() and K0u.data_ptr() % 16 == 4
    _same((HE.build_sdir_batched(K0u, pen4b, legal4, 20),),
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


@pytest.mark.parametrize("shape", [(256, 256), (16, 256, 256), (1024, 1024)])
def test_wavefront_kernel_at_path_shapes(gen, shape):
    """K3 at the path's shapes (one world, B = 16, config #5's 1024^2)
    against its plain version, dense hard blockers, in one launch a call
    (chip_smoke.py counts its device kernels with the profiler)."""
    H, W = shape[-2:]
    cfg = Config(WIDTH=W, HEIGHT=H)
    allowed = _rint(gen, 0, 16, H, W).to(torch.uint8)
    road = _bern(gen, 0.6, H, W)
    hard = _bern(gen, 0.15, *shape) & road
    if len(shape) == 3:
        kern = lambda: HE.build_wavefront_batched(cfg, allowed, road, hard)
        plain = lambda: HE.wavefront_core_batched(cfg, allowed, road, hard)
    else:
        kern = lambda: HE.build_wavefront(cfg, allowed, road, hard)
        plain = lambda: HE.wavefront_core(cfg, allowed, road, hard)
    n0 = HE.launches["build_wavefront"]
    got = kern()
    assert HE.launches["build_wavefront"] == n0 + 1
    _same((got,), (plain(),))
    assert (got != 0x07070707).any()


def test_wavefront_takes_at_most_its_compiled_steps(gen):
    """K3 at the most relax steps it was compiled for equals its plain
    version; one step more raises before any launch."""
    H, W = 70, 90
    allowed = _rint(gen, 0, 16, H, W).to(torch.uint8)
    road = _bern(gen, 0.6, H, W)
    hard = _bern(gen, 0.1, H, W) & road
    k = HE.WAVEFRONT_KMAX
    cfg = Config(WIDTH=W, HEIGHT=H, VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS=k)
    _same((HE.build_wavefront(cfg, allowed, road, hard),),
          (HE.wavefront_core(cfg, allowed, road, hard),))
    over = cfg.replace(VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS=k + 1)
    n0 = HE.launches["build_wavefront"]
    with pytest.raises(ValueError):
        HE.build_wavefront(over, allowed, road, hard)
    with pytest.raises(ValueError):
        HE.build_wavefront_batched(over, allowed, road, hard[None])
    assert HE.launches["build_wavefront"] == n0


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


@pytest.mark.parametrize("shape,offset", [((37, 301), 0), ((37, 300), 1),
                                          ((64, 96), 3), ((5, 7), 2)])
def test_select_rows_kernel_ragged_and_misaligned(gen, shape, offset):
    """K6 where H * W is not a multiple of 4 and on a dest view whose
    storage offset leaves it off a 16-byte boundary: the edge cells in
    the same launch."""
    H, W = shape
    D4 = 9
    sdir4 = _rint(gen, -2**31, 2**31, D4, H, W)
    dest = _rint(gen, -6, 4 * D4 + 9, H * W + offset)[offset:].view(H, W)
    assert dest.data_ptr() % 16 == 4 * offset
    n0 = HE.launches["select_rows"]
    got = HE.select_rows(sdir4, dest)
    assert HE.launches["select_rows"] == n0 + 1
    assert got.data_ptr() % 16 == dest.data_ptr() % 16
    _same((got,), (HE.select_dest_rows(sdir4, dest),))


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



def _hier_inputs(g, cfg, n_direct=6):
    """K1-hier's arguments at `cfg` (64^2, 16-cell tiles): dense (hub and
    direct) and windowed stacks whose bytes mostly lack the contraflow
    bit; a tenth of the cells hold a vehicle with no faults, stuck count
    or allowance (about half of them move), whose rid is windowed or not,
    direct, past the dense stack or DEST_NONE."""
    from trafficsimulation_tpu_torch.ops import hier
    hp = hier.hier_params(cfg)
    H, W = cfg.HEIGHT, cfg.WIDTH
    nd = hp.nr + n_direct
    dense = _rint(g, 0, 256, nd, H, W) & torch.where(
        _bern(g, 0.8, nd, H, W), 0xF7, 0xFF).to(torch.int32)
    dense4 = engine.pack_sdir4(dense.to(torch.uint8))
    LD4 = 9 * hp.lmax // 4
    local4 = _rint(g, -2**31, 2**31, LD4, H, W) & torch.where(
        _bern(g, 0.8, LD4, H, W), -0x08080809, -1).to(torch.int32)
    wb = _rint(g, 0, 16, 4, H, W)
    wnd = wb[0] | (wb[1] << 8) | (wb[2] << 16) | (wb[3] << 24)
    u = torch.rand((H, W), generator=g, device="cuda")
    base = hp.direct_base
    rid = torch.where(u < 0.6, _rint(g, 0, base, H, W), torch.where(
        u < 0.8, _rint(g, base, base + n_direct, H, W), torch.where(
            u < 0.9, _rint(g, base + n_direct, 16383, H, W), 16383)))
    planes = [_rint(g, -2**31, 2**31, H, W) for _ in range(5)] + [
        torch.rand((H, W), generator=g, device="cuda")]
    planes[0] = (planes[0] & ((1 << 14) - 2)) | _bern(g, 0.1, H, W) | \
        (rid << 18)
    planes[1] &= 0x00FFF000
    masks = tuple(_bern(g, p, H, W) for p in (0.02, 0.1, 0.02, 0.1))
    dest_id = torch.where(_bern(g, 0.05, H, W), rid, -1)
    randoms = (torch.rand((H, W), generator=g, device="cuda"),
               torch.rand((H, W), generator=g, device="cuda"),
               _rint(g, 1, 6, H, W), _rint(g, -2**31, 2**31, H, W))
    return dense4, local4, wnd, tuple(planes), masks, dest_id, randoms


@pytest.mark.parametrize("speed", [2, 5])
def test_decide_move_hier_matches_plain(gen, speed):
    """K1-hier against the plain core with `hier_select` (K6 twice per
    select), one launch and no K6, at K = 2 and 5 sub-rounds."""
    from trafficsimulation_tpu_torch.ops import hier
    cfg = Config(WIDTH=64, HEIGHT=64, ROUTING_HIER=True, HIER_TILE=16,
                 HIER_LMAX=8, VEHICLE_MAX_SPEED=speed,
                 VEHICLE_MALFUNCTION_CHANCE=0.01,
                 VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    dense4, local4, wnd, planes, masks, dest_id, randoms = _hier_inputs(
        gen, cfg)
    n0 = dict(HE.launches)
    got = HE.decide_move(cfg, dense4, wnd, planes, *masks, dest_id, randoms,
                         hier=(local4, hier.kernel_consts(cfg)))
    assert HE.launches["decide_move"] == n0["decide_move"] + 1
    assert HE.launches["select_rows"] == n0["select_rows"]
    ref = HE.decide_move_core(
        cfg, dense4, wnd, *planes, *masks, dest_id, *randoms,
        select=lambda d: hier.hier_select(cfg, dense4, local4, d))
    _same(got, ref)
    moved = (got[6] & HE.FLAG_MOVED) != 0
    assert int(moved.sum()) > 0.4 * int((planes[0] & 1).sum())


def test_decide_move_hier_rejects_what_it_does_not_take(gen):
    from trafficsimulation_tpu_torch.ops import hier
    cfg = Config(WIDTH=64, HEIGHT=64, ROUTING_HIER=True, HIER_TILE=16,
                 HIER_LMAX=8)
    dense4, local4, wnd, planes, masks, dest_id, randoms = _hier_inputs(
        gen, cfg)
    consts = hier.kernel_consts(cfg)
    with pytest.raises(ValueError):
        HE.decide_move(cfg, dense4, wnd, planes, *masks, dest_id, randoms,
                       hier=(local4[:, :32], consts))
    with pytest.raises(TypeError):
        HE.decide_move(cfg, dense4, wnd, planes, *masks, dest_id, randoms,
                       hier=(local4.to(torch.int64), consts))
    with pytest.raises(ValueError):
        HE.decide_move(cfg, dense4, wnd, planes, *masks, dest_id, randoms,
                       hier=(local4, consts[:9]))


def test_hier_run_chunk_on_card_launches_k1_hier(gen):
    """A ROUTING_HIER `run_chunk` on the card: K1 once and K6 never per
    tick, and the same world as the CPU plain run."""
    from trafficsimulation_tpu_torch import prng, sim
    from trafficsimulation_tpu_torch.core import transfer
    cfg = Config(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6,
                 SIDEWALK_RING_WIDTH=2, MAX_VEHICLES=256, ROUTING_HIER=True,
                 HIER_TILE=16, HIER_LMAX=8,
                 INTERNAL_POPULATION_TRAFFIC_PER_DAY=2000,
                 PASSING_POPULATION_TRAFFIC_PER_DAY=500)
    cfg, world = sim.init_world_hier(cfg, prng.PRNGKey(0), "cpu")
    world = sim.inject_vehicles(cfg, world, 200)
    n = 7
    ref = transfer.world_to_numpy(sim.run_chunk(cfg, world, n))
    card = transfer.world_from_numpy(transfer.world_to_numpy(world), "cuda")
    n0 = dict(HE.launches)
    got = transfer.world_to_numpy(sim.run_chunk(cfg, card, n))
    assert HE.launches["decide_move"] == n0["decide_move"] + n
    assert HE.launches["select_rows"] == n0["select_rows"]
    for k, a in ref.items():
        if k.startswith("metrics.sum_duration"):
            assert np.allclose(a, got[k], rtol=1e-5, atol=0.0), k
        else:
            assert np.array_equal(a, got[k]), k
    assert (ref["vehicles.pos"] != transfer.world_to_numpy(world)[
        "vehicles.pos"]).any()


@pytest.mark.parametrize("shape", [(37, 300), (256, 256), (16, 256, 256),
                                   (1024, 1024)])
def test_prefix_kernel_at_path_shapes(gen, shape):
    """K4 at an odd width and at the path's shapes (one world, B = 16,
    config #5), on 0/1 occupancy and on full-range int32 planes whose
    sums wrap."""
    kern = HE.prefix_planes_batched if len(shape) == 3 else HE.prefix_planes
    for occ in (_bern(gen, 0.3, *shape).to(torch.int32),
                _rint(gen, -2**31, 2**31, *shape)):
        n0 = HE.launches["prefix_planes"]
        got = kern(occ)
        assert HE.launches["prefix_planes"] == n0 + 1
        _same(got, HE.prefix_planes_plain(occ))

# ---- K9 ----------------------------------------------------------------

MEGA_CFG = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
                MAX_FIELD_DESTS=32, MAX_VEHICLES=256,
                INTERNAL_POPULATION_TRAFFIC_PER_DAY=60000,
                PASSING_POPULATION_TRAFFIC_PER_DAY=20000,
                RAIN_SPAWN_CHANCE=0.2)
# stats columns that are f32 sums of non-integer order (the durations)
MEGA_DUR_COLS = [2, 3, 7]


def _mega_world(algo):
    from trafficsimulation_tpu_torch import prng, sim
    cfg = Config(**MEGA_CFG, TRAFFIC_LIGHT_AGENT_ALGORITHM=algo)
    world = sim.init_world(cfg, prng.PRNGKey(3), "cuda")
    cfg, world = sim.measure_and_shrink(cfg, world)
    return cfg, sim.inject_vehicles(cfg, world, 120)


def _same_mega(got, ref):
    """K9's outputs against the plain version's: every plane, light row,
    tank bit for bit; the stats rows too but for the duration sums."""
    for k in HE.MEGA_OUTPUTS:
        a, b = got[k], ref[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k == "stats":
            keep = [c for c in range(a.shape[1]) if c not in MEGA_DUR_COLS]
            assert torch.equal(a[:, keep], b[:, keep])
            assert torch.allclose(a[:, MEGA_DUR_COLS], b[:, MEGA_DUR_COLS],
                                  rtol=1e-5, atol=0.0)
        else:
            _same((a,), (b,))


def _mega_args(cfg, world, R):
    """K9's inputs for the next R ticks of `world`, as `run_chunk`
    launches them on the megakernel path."""
    from trafficsimulation_tpu_torch import sim
    from trafficsimulation_tpu_torch.ops import megakernel
    es = sim._enter_engine(cfg, world)
    cs = megakernel.build_chunk_static(cfg, world)
    draws, _ = engine.tick_draws(cfg, sim._key_np(world.key), R)
    args, _ = megakernel.segment_inputs(
        cfg, world, es, cs, engine.routing_planes(cfg, world, es), R,
        torch.from_numpy(draws).cuda())
    return args


@pytest.mark.parametrize("algo", ["DISABLED", "FIXED_TIME", "QUEUE_ACTUATED",
                                  "PRESSURE_CONTROL",
                                  "NEIGHBOR_PRESSURE_CONTROL",
                                  "NEIGHBOR_GREEN_WAVE"])
def test_mega_kernel_matches_plain(gen, algo):
    """Segments of R = 1 ... 5 ticks: K9 against `segment_plain` on the
    same inputs, from a world that has run a few ticks (lights switching,
    vehicles moving, trips spawning), under every FSM controller; a
    second launch gives the same bits."""
    from trafficsimulation_tpu_torch import sim
    from trafficsimulation_tpu_torch.ops import megakernel
    cfg, world = _mega_world(algo)
    world = sim.run_chunk(cfg, world, 7)
    for R in range(1, 6):
        args = _mega_args(cfg, world, R)
        n0 = HE.launches["mega"]
        got = HE.mega_segment(cfg, args)
        torch.cuda.synchronize()
        assert HE.launches["mega"] == n0 + 1
        _same_mega(got, megakernel.segment_plain(cfg, args))
        # a second launch gives the same bits (reproducible reductions)
        _same_mega(HE.mega_segment(cfg, args), got)


def test_mega_stop_runs_of_two_groups_share_a_cell(gen):
    """A stop run copied to a light of another group: two owners clear
    and paint one cell; K9 equals its plain version over 5 ticks whose
    lights switch."""
    from trafficsimulation_tpu_torch import sim
    from trafficsimulation_tpu_torch.ops import megakernel
    cfg, world = _mega_world("FIXED_TIME")
    cfg = cfg.replace(TRAFFIC_LIGHT_GREEN_DURATION=2)
    world = sim.run_chunk(cfg, world, 3)
    args = _mega_args(cfg, world, 5)
    H, W = cfg.HEIGHT, cfg.WIDTH
    G = args["li"].shape[1]
    lg = args["l_group"].cpu()
    srun = args["srun"].cpu()
    r0 = next(r for r in range(srun.shape[0])
              if srun[r, 0] != 0 and lg[srun[r, 4]] >= 0)
    g0 = int(lg[srun[r0, 4]])
    grid, _ = HE.mega_grid(world.grid.is_road.device, H, W)
    l1 = next(i for i in range(lg.shape[0])
              if lg[i] >= 0 and int(lg[i]) % grid != g0 % grid)
    extra = srun[r0].clone()
    extra[4] = l1
    a = dict(args)
    a["srun"] = torch.cat([srun, extra[None]]).cuda().contiguous()
    for k in ("s_rmv", "s_rh"):               # [H, S]
        a[k] = torch.cat([args[k], args[k][:, r0:r0 + 1]], 1).contiguous()
    for k in ("s_cv", "s_cmh"):               # [S, W]
        a[k] = torch.cat([args[k], args[k][r0:r0 + 1]], 0).contiguous()
    col = torch.zeros_like(args["s_ol"][:, :1])
    col[l1, 0] = 1
    a["s_ol"] = torch.cat([args["s_ol"], col], 1).contiguous()
    a["lown"] = megakernel.light_owner_table(args["qrun"], a["srun"],
                                             args["l_group"], G)
    own = megakernel.light_owners(a["lown"], G, a["qrun"].shape[0],
                                  lg.shape[0], a["srun"].shape[0], a["srun"],
                                  H, W, grid)
    assert len(own["shared_stop_cells"]) > 0
    got = HE.mega_segment(cfg, a)
    _same_mega(got, megakernel.segment_plain(cfg, a))


def test_mega_scratch_per_shape_and_fresh_outputs(gen):
    """Calls at two shapes in one process, back and forth: each equals
    its plain version, and the outputs of two successive calls share no
    storage (the first call's still hold its results)."""
    from trafficsimulation_tpu_torch import prng, sim
    from trafficsimulation_tpu_torch.ops import megakernel
    cfg_a, world_a = _mega_world("QUEUE_ACTUATED")
    cfg_b = Config(**{**MEGA_CFG, "WIDTH": 96},
                   TRAFFIC_LIGHT_AGENT_ALGORITHM="QUEUE_ACTUATED")
    world_b = sim.init_world(cfg_b, prng.PRNGKey(5), "cuda")
    cfg_b, world_b = sim.measure_and_shrink(cfg_b, world_b)
    world_b = sim.inject_vehicles(cfg_b, world_b, 150)
    a5 = _mega_args(cfg_a, world_a, 5)
    b3 = _mega_args(cfg_b, world_b, 3)
    a4 = _mega_args(cfg_a, sim.run_chunk(cfg_a, world_a, 2), 4)
    outs = []
    for cfg, args in ((cfg_a, a5), (cfg_b, b3), (cfg_a, a4), (cfg_a, a5)):
        outs.append((cfg, args, HE.mega_segment(cfg, args)))
    ptrs = [{t.untyped_storage().data_ptr() for t in o.values()}
            for _, _, o in outs]
    for i in range(len(ptrs) - 1):
        assert not ptrs[i] & ptrs[i + 1]
    for cfg, args, got in outs:
        _same_mega(got, megakernel.segment_plain(cfg, args))


def test_mega_counts_its_barriers(gen):
    """K9 passes 2K + 3 grid barriers a tick and one more a segment (the
    kernel counts them), at R = 5 and R = 2."""
    cfg, world = _mega_world("QUEUE_ACTUATED")
    for R in (5, 2):
        args = _mega_args(cfg, world, R)
        HE.mega_segment(cfg, args)
        HE.mega_syncs()
        HE.mega_segment(cfg, args)
        assert HE.mega_syncs() == 1 + R * (2 * cfg.VEHICLE_MAX_SPEED + 3)


def test_mega_run_chunk_matches_per_tick_on_card(gen, monkeypatch):
    """`run_chunk(12)` on the card through K9 (TSIM_MEGA_FORCE) against
    the per-tick path: 3 K9 launches, no K1 or K4."""
    from trafficsimulation_tpu_torch import sim
    from trafficsimulation_tpu_torch.core.transfer import world_to_numpy
    from trafficsimulation_tpu_torch.ops import megakernel
    cfg, world = _mega_world("QUEUE_ACTUATED")
    monkeypatch.setenv("TSIM_NO_MEGAKERNEL", "1")
    ref = world_to_numpy(sim.run_chunk(cfg, world, 12))
    monkeypatch.delenv("TSIM_NO_MEGAKERNEL")
    monkeypatch.setenv("TSIM_MEGA_FORCE", "1")
    assert megakernel.mega_ok(cfg, world)
    n0 = dict(HE.launches)
    got = world_to_numpy(sim.run_chunk(cfg, world, 12))
    assert HE.launches["mega"] == n0["mega"] + 3
    assert HE.launches["decide_move"] == n0["decide_move"]
    assert HE.launches["prefix_planes"] == n0["prefix_planes"]
    for k, a in ref.items():
        if k.startswith("metrics.sum_duration"):
            assert np.allclose(a, got[k], rtol=1e-5, atol=0.0), k
        else:
            assert np.array_equal(a, got[k]), k


def test_mega_rejects_what_it_does_not_take(gen):
    from trafficsimulation_tpu_torch import sim
    from trafficsimulation_tpu_torch.ops import megakernel
    cfg, world = _mega_world("QUEUE_ACTUATED")
    es = sim._enter_engine(cfg, world)
    cs = megakernel.build_chunk_static(cfg, world)
    draws, _ = engine.tick_draws(cfg, sim._key_np(world.key), 2)
    args, _ = megakernel.segment_inputs(
        cfg, world, es, cs, engine.routing_planes(cfg, world, es), 2,
        torch.from_numpy(draws).cuda())
    # before any launch at this shape, and after one (its cached
    # signature)
    for _ in range(2):
        n0 = HE.launches["mega"]
        with pytest.raises(TypeError):
            HE.mega_segment(cfg, {**args, "pb": args["pb"].to(torch.int64)})
        with pytest.raises(ValueError):
            HE.mega_segment(cfg, {**args, "pa": args["pa"].t()})
        with pytest.raises(ValueError):
            HE.mega_segment(cfg, {**args, "wnd": args["wnd"].cpu()})
        with pytest.raises(ValueError):
            HE.mega_segment(cfg, {**args, "lown": args["lown"][1:]})
        assert HE.launches["mega"] == n0
        HE.mega_segment(cfg, args)


def test_mega_batch_on_card_matches_single_worlds(gen, monkeypatch):
    """`run_batch_shared` on the card through K9 (its vmap rule launches
    once per world and segment) against each world's per-tick run."""
    from trafficsimulation_tpu_torch import sim
    from trafficsimulation_tpu_torch.core.transfer import world_to_numpy
    from trafficsimulation_tpu_torch.parallel import mesh
    cfg, world = _mega_world("QUEUE_ACTUATED")
    keys = np.stack([sim._key_np(world.key), np.array([7, 9], np.uint32)])
    monkeypatch.setenv("TSIM_MEGA_FORCE", "1")
    n0 = HE.launches["mega"]
    batch = mesh.run_batch_shared(cfg, mesh.tile_dynamic(world, keys), 7)
    assert HE.launches["mega"] == n0 + 2 * 2
    monkeypatch.delenv("TSIM_MEGA_FORCE")
    monkeypatch.setenv("TSIM_NO_MEGAKERNEL", "1")
    for b in range(2):
        w = world.replace(key=torch.from_numpy(
            keys[b].view(np.int32).copy()).cuda())
        ref = world_to_numpy(sim.run_chunk(cfg, w, 7))
        got = world_to_numpy(mesh.world_at(batch, b))
        for k, a in ref.items():
            if k.startswith("metrics.sum_duration"):
                assert np.allclose(a, got[k], rtol=1e-5, atol=0.0), k
            else:
                assert np.array_equal(a, got[k]), k


def _cloud_inputs(g, B, R, n, H=16, W=20):
    """B worlds' cloud tables anywhere on the map, moving up to 3 cells
    a tick (so that clouds leave within the run), the spawn tables of n
    random draw rows, random spawn requests and cooldowns."""
    from trafficsimulation_tpu_torch.agents import rain
    cfg = Config(WIDTH=W, HEIGHT=H, RAIN_RADIUS_MIN=2, RAIN_RADIUS_MAX=6)

    def table(x, y, vx, vy, rad):
        return torch.stack([x, y, vx, vy, -rad, -rad, W + rad, H + rad,
                            rad], dim=-2)
    u = torch.rand((5, B, R), generator=g, device="cuda")
    clouds = table(u[0] * (W + 8) - 4, u[1] * (H + 8) - 4, u[2] * 6 - 3,
                   u[3] * 6 - 3, 2 + torch.floor(u[4] * 4))
    draws = torch.stack([_rint(g, 0, 2, B * n), _rint(g, 0, 4, B * n),
                         _rint(g, 0, 1 << 23, B * n), _rint(g, 0, 2, B * n),
                         _rint(g, 2, 7, B * n)], dim=1).to(torch.int64)
    spawn = table(*rain._spawn_params(cfg, H, W, draws))     # [9, B * n]
    spawn = spawn.reshape(9, B, n).permute(1, 0, 2).contiguous()
    want_cd = torch.where(_bern(g, 0.4, B, n), 0, -1).to(torch.int32)
    return (clouds.contiguous(), _bern(g, 0.7, B, R), _rint(g, 0, 3, B),
            spawn, want_cd)


@pytest.mark.parametrize("B,R,n", [(1, 3, 60), (5, 4, 57)])
def test_rain_ticks_kernel_matches_plain(gen, B, R, n):
    """The clouds' tick loop on the card against its plain version per
    world, bit for bit, over runs with exits, cooldowns and respawns."""
    from trafficsimulation_tpu_torch.agents.rain import cloud_ticks_plain
    args = _cloud_inputs(gen, B, R, n)
    got = HE.rain_ticks_batched(*args, 6)
    for b in range(B):
        ref = cloud_ticks_plain(*(a[b] for a in args), 6)
        _same((got[0][b], got[1][b], got[2][b]), ref)
    # a slot whose cloud did not just move took a spawn; an active one
    # that went inactive or took a spawn lost its cloud off the map
    tab = torch.cat([args[0][:, None], got[0]], dim=1)  # [B, n + 1, 9, R]
    act = torch.cat([args[1][:, None], got[1]], dim=1)
    spawned = (tab[:, 1:, :2] != tab[:, :-1, :2] + tab[:, :-1, 2:4]).any(2)
    assert spawned.any()
    assert (act[:, :-1] & (spawned | ~act[:, 1:])).any()
    if B == 1:
        one = HE.rain_ticks(*(a[0] for a in args), 6)
        _same(one, (got[0][0], got[1][0], got[2][0]))


def test_rain_ticks_outside_vmap_is_one_lean_launch(gen, monkeypatch):
    """Outside vmap `rain_ticks` launches once, bit-equal to its plain
    version, and takes no autograd.Function."""
    from trafficsimulation_tpu_torch.agents.rain import cloud_ticks_plain

    def no_function(*a):
        raise AssertionError("rain_ticks went through _RainTicks")
    monkeypatch.setattr(HE._RainTicks, "apply", no_function)
    for n in (1, 23):
        args = [a[0] for a in _cloud_inputs(gen, 1, 3, n)]
        HE.reset_launches()
        got = HE.rain_ticks(*args, 6)
        assert HE.launches["rain_ticks"] == 1
        _same(got, cloud_ticks_plain(*args, 6))


def test_rain_ticks_vmap_launches_once(gen):
    args = _cloud_inputs(gen, 4, 3, 9)
    HE.reset_launches()
    got = torch.func.vmap(lambda *a: HE.rain_ticks(*a, 6))(*args)
    assert HE.launches["rain_ticks"] == 1
    _same(got, HE.rain_ticks_batched(*args, 6))


def _one_world(g, H, W, D):
    sdir4, wnd, planes, masks, inter, dest, randoms = _dm_inputs(g, 1, H, W,
                                                                 D)
    return (sdir4[0], wnd[0], tuple(p[0] for p in planes),
            *(m[0] for m in masks), inter, dest,
            tuple(r[0] for r in randoms))


@pytest.mark.parametrize("shape,tiles", [((64, 96), ((16, 32), (32, 48))),
                                         ((256, 256), ((64, 64), (16, 32)))])
def test_decide_move_tiled_matches_plain_and_k1(gen, shape, tiles):
    """K7 at two tilings against its plain version and against K1 on the
    same inputs, one launch per call."""
    H, W = shape
    cfg = Config(WIDTH=W, HEIGHT=H, VEHICLE_MALFUNCTION_CHANCE=0.01,
                 VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    args = _one_world(gen, H, W, 10)
    k1 = HE.decide_move(cfg, *args)
    for th, tw in tiles:
        n0 = HE.launches["decide_move_tiled"]
        got = HE.decide_move_tiled(cfg, *args, th, tw)
        assert HE.launches["decide_move_tiled"] == n0 + 1
        _same(got, HE.decide_move_tiled_plain(cfg, *args, th, tw))
        _same(got, k1)


@pytest.mark.parametrize("shape,tile,cpt", [((256, 256), (64, 64), 36),
                                            ((256, 256), (16, 32), 12),
                                            ((64, 96), (32, 48), 24)])
def test_decide_move_tiled_runs_one_block_a_window(gen, shape, tile, cpt):
    """K7 on 96 x 96, 48 x 64 and 64 x 80 windows: one block a window
    (the kernel's plan is k7_plan's), one launch a call, equal to its
    plain version and to K1."""
    H, W = shape
    cfg = Config(WIDTH=W, HEIGHT=H, VEHICLE_MALFUNCTION_CHANCE=0.01,
                 VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    args = _one_world(gen, H, W, 10)
    plan = HE.tiled_plan(H, W, *tile)
    assert plan["tiles_per_block"] == cpt and plan["blocks_per_sm"] >= 1
    assert plan["blocks"] == (H // tile[0]) * (W // tile[1])
    n0 = HE.launches["decide_move_tiled"]
    got = HE.decide_move_tiled(cfg, *args, *tile)
    assert HE.launches["decide_move_tiled"] == n0 + 1
    _same(got, HE.decide_move_tiled_plain(cfg, *args, *tile))
    _same(got, HE.decide_move(cfg, *args))


def test_decide_move_tiled_rejects_a_window_past_one_block(gen):
    """128 x 128 tiles make 160 x 160 windows of 100 tiles: ValueError,
    no launch, never another form."""
    H = W = 256
    cfg = Config(WIDTH=W, HEIGHT=H)
    args = _one_world(gen, H, W, 8)
    n0 = HE.launches["decide_move_tiled"]
    with pytest.raises(ValueError, match="past one block"):
        HE.decide_move_tiled(cfg, *args, 128, 128)
    with pytest.raises(ValueError, match="past one block"):
        HE.tiled_plan(H, W, 128, 128)
    assert HE.launches["decide_move_tiled"] == n0


@pytest.mark.parametrize("shape", [(37, 300), (1024, 1024)])
def test_render_kernel_matches_plain(gen, shape):
    from trafficsimulation_tpu_torch.ops import render as R
    H, W = shape
    cell = _rint(gen, 0, 20, H, W).to(torch.uint8)
    stop, rain = _bern(gen, 0.3, H, W), _bern(gen, 0.3, H, W)
    vstate = _rint(gen, 0, 7, H, W).to(torch.uint8)
    n0 = HE.launches["render"]
    got = R.render_planes(cell, stop, rain, vstate)
    assert HE.launches["render"] == n0 + 1
    _same((got,), (R.render_planes_plain(cell, stop, rain, vstate),))


def test_tiled_and_render_reject_what_they_do_not_take(gen):
    from trafficsimulation_tpu_torch.ops import render as R
    H, W = 64, 96
    cfg = Config(WIDTH=W, HEIGHT=H)
    args = list(_one_world(gen, H, W, 8))
    with pytest.raises(ValueError):          # 24 does not divide 64
        HE.decide_move_tiled(cfg, *args, 24, 32)
    bad = list(args)
    bad[1] = args[1].to(torch.int64)         # wnd
    with pytest.raises(TypeError):
        HE.decide_move_tiled(cfg, *bad, 16, 32)
    bad = list(args)
    bad[7] = args[7][:32]                    # dest_id
    with pytest.raises(ValueError):
        HE.decide_move_tiled(cfg, *bad, 16, 32)
    cell = _rint(gen, 0, 18, H, W).to(torch.uint8)
    stop = _bern(gen, 0.3, H, W)
    vstate = torch.zeros((H, W), dtype=torch.uint8, device="cuda")
    with pytest.raises(TypeError):
        R.render_planes(cell.to(torch.int32), stop, stop, vstate)
    with pytest.raises(ValueError):
        R.render_planes(cell, stop[:, :10], stop, vstate)
    with pytest.raises(ValueError):
        R.render_planes(cell, stop, stop, vstate.t())


def _moving_worlds(g, B, H, W, D):
    """K1's arguments for B worlds in which a tenth of the cells hold a
    vehicle without faults, stuck count or allowance and most sdir bytes
    lack the contraflow bit, so most vehicles move, several cells a tick
    at K = 5 sub-rounds."""
    nd = _rint(g, 0, 256, B, D, H, W) & torch.where(
        _bern(g, 0.8, B, D, H, W), 0xF7, 0xFF).to(torch.int32)
    sdir4 = torch.stack([engine.pack_sdir4(x.to(torch.uint8)) for x in nd])
    del nd
    wb = _rint(g, 0, 16, B, 4, H, W)
    wnd = wb[:, 0] | (wb[:, 1] << 8) | (wb[:, 2] << 16) | (wb[:, 3] << 24)
    planes = [_rint(g, -2**31, 2**31, B, H, W) for _ in range(5)] + [
        torch.rand((B, H, W), generator=g, device="cuda")]
    planes[0] = (planes[0] & ((1 << 14) - 2)) | _bern(g, 0.1, B, H, W) | \
        (_rint(g, 0, D, B, H, W) << 18)
    planes[1] &= 0x00FFF000
    masks = tuple(_bern(g, p, B, H, W) for p in (0.02, 0.1, 0.02))
    inter = _bern(g, 0.1, H, W)
    dest_id = torch.where(_bern(g, 0.05, H, W), _rint(g, 0, D, H, W), -1)
    randoms = (torch.rand((B, H, W), generator=g, device="cuda"),
               torch.rand((B, H, W), generator=g, device="cuda"),
               _rint(g, 1, 6, B, H, W), _rint(g, -2**31, 2**31, B, H, W))
    return sdir4, wnd, tuple(planes), masks, inter, dest_id, randoms


# K1's forms at a ragged shape (a partial 32 x 8 tile at the grid's edge)
# and at about 1M cells, where a thread owns several cells
_K1_SHAPES = {("one", "small"): (1, 37, 300), ("one", "1M"): (1, 1024, 1024),
              ("batch", "small"): (3, 37, 300),
              ("batch", "1M"): (16, 256, 256),
              ("hier", "small"): (1, 40, 304),
              ("hier", "1M"): (1, 1024, 1024)}


def _k1_call(g, form, size, speed):
    """(kernel call, plain call, vehicles) of one K1 form."""
    from trafficsimulation_tpu_torch.ops import hier
    B, H, W = _K1_SHAPES[(form, size)]
    if form == "hier":
        kw = dict(HIER_TILE=8, HIER_LMAX=8) if size == "small" else {}
        cfg = Config(WIDTH=W, HEIGHT=H, ROUTING_HIER=True,
                     VEHICLE_MAX_SPEED=speed,
                     VEHICLE_MALFUNCTION_CHANCE=0.01,
                     VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3, **kw)
        dense4, local4, wnd, planes, masks, dest_id, randoms = \
            _hier_inputs(g, cfg)
        consts = hier.kernel_consts(cfg)
        return (lambda: HE.decide_move(cfg, dense4, wnd, planes, *masks,
                                       dest_id, randoms,
                                       hier=(local4, consts)),
                lambda: HE.decide_move_core(
                    cfg, dense4, wnd, *planes, *masks, dest_id, *randoms,
                    select=lambda d: hier.hier_select(cfg, dense4, local4,
                                                      d)),
                int((planes[0] & 1).sum()))
    cfg = Config(WIDTH=W, HEIGHT=H, VEHICLE_MAX_SPEED=speed,
                 VEHICLE_MALFUNCTION_CHANCE=0.01,
                 VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    sdir4, wnd, planes, masks, inter, dest, randoms = _moving_worlds(
        g, B, H, W, 10)
    n_veh = int((planes[0] & 1).sum())
    if form == "batch":
        return (lambda: HE.decide_move_batched(cfg, sdir4, wnd, planes,
                                               *masks, inter, dest, randoms),
                lambda: HE.decide_move_core_batched(cfg, sdir4, wnd, planes,
                                                    *masks, inter, dest,
                                                    randoms), n_veh)
    one = (sdir4[0], wnd[0], tuple(p[0] for p in planes),
           *(m[0] for m in masks), inter, dest, tuple(r[0] for r in randoms))
    return (lambda: HE.decide_move(cfg, *one),
            lambda: HE.decide_move_core(cfg, one[0], one[1], *one[2],
                                        *one[3:8], *one[8]), n_veh)


@pytest.mark.parametrize("size", ["small", "1M"])
@pytest.mark.parametrize("speed", [2, 5])
@pytest.mark.parametrize("form", ["one", "batch", "hier"])
def test_decide_move_one_launch_matches_plain(gen, form, speed, size):
    """K1's cooperative launch in each form against its plain version, at
    K = 2 and 5 sub-rounds, with most vehicles moving: one wrapper call,
    bit-equal."""
    kern, plain, n_veh = _k1_call(gen, form, size, speed)
    n0 = dict(HE.launches)
    got = kern()
    assert HE.launches["decide_move"] == n0["decide_move"] + 1
    assert HE.launches["select_rows"] == n0["select_rows"]
    _same(got, plain())
    moved = int(((got[6] & HE.FLAG_MOVED) != 0).sum())
    assert moved > 0.3 * n_veh


@pytest.mark.parametrize("form", ["one", "batch", "hier"])
def test_decide_move_runs_one_device_kernel(gen, form):
    """Each K1 call runs exactly one kernel on the device (the profiler's
    count), the cooperative one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kern, _, _ = _k1_call(gen, form, "small", 5)
    kern()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kern()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "dm_coop" in names[0], names


@pytest.mark.parametrize("name", ["order", "zero_runs", "signed_zero_bases",
                                  "cancel", "rows32", "config5", "dropped",
                                  "subnormal", "flushed_negative_zero",
                                  "beyond_shared_memory"])
def test_ordered_add_kernel_matches_plain(gen, name):
    """The order-keeping compaction against the plain version on the
    CPU test's adversarial cases (tests/test_torch_ordered_add.py),
    subnormals, sums that flush to -0 and dropped indices included, and
    on rows whose work area
    exceeds shared memory (device memory, the same algorithm)."""
    from test_torch_ordered_add import _case
    if name == "beyond_shared_memory":
        rng = np.random.default_rng(5)
        R, T, n = 3, 5184, 40000
        base = rng.normal(0, 30, (R, T)).astype(np.float32)
        base[:, ::7] = -0.0
        idx = rng.integers(-3, T + 3, (R, n))
        idx[:, ::2] = 0
        vals = np.where(rng.random((R, n)) < 0.7,
                        np.where(rng.random((R, n)) < 0.5, 0.0, -0.0),
                        rng.normal(0, 1e3, (R, n))).astype(np.float32)
    else:
        base, idx, vals = _case(name)
    cpu = [torch.from_numpy(x) for x in (base, idx, vals)]
    n0 = HE.launches["ordered_add"]
    got = HE.ordered_add(*[x.cuda() for x in cpu])
    assert HE.launches["ordered_add"] == n0 + 1
    _same((got.cpu(),), (HE.ordered_add_plain(*cpu),))


# ---- per-world geometry (a batch of different cities, config #4) ------------

def _geo_batch(g, B, H, W):
    return (_rint(g, 0, 16, B, H, W).to(torch.uint8), _bern(g, 0.5, B, H, W),
            _bern(g, 0.1, B, H, W))


@pytest.mark.parametrize("mix", ["both", "inter", "dest"])
def test_decide_move_per_world_geometry_matches_plain(gen, mix):
    """K1 with intersection and dest_id one plane a world: one launch,
    each world equal to its plain version; under vmap with the geometry
    batched, or one of its planes shared, one launch and no per-world
    map."""
    B, H, W, D = 3, 37, 300, 10
    cfg = Config(WIDTH=W, HEIGHT=H, VEHICLE_MALFUNCTION_CHANCE=0.01,
                 VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    sdir4, wnd, planes, masks, _, _, randoms = _dm_inputs(gen, B, H, W, D)
    inter = _bern(gen, 0.1, B, H, W)
    dest = _rint(gen, -1, D, B, H, W)
    gd = {"both": (0, 0), "inter": (0, None), "dest": (None, 0)}[mix]
    if mix == "inter":
        dest = dest[0]
    elif mix == "dest":
        inter = inter[0]
    ref = HE.decide_move_core_batched(cfg, sdir4, wnd, planes, *masks,
                                      inter, dest, randoms)
    n0 = HE.launches["decide_move"]
    if mix == "both":
        got = HE.decide_move_batched(cfg, sdir4, wnd, planes, *masks, inter,
                                     dest, randoms)
        assert HE.launches["decide_move"] == n0 + 1
        _same(got, ref)
    vm = torch.func.vmap(lambda *a: HE.decide_move(
        cfg, a[0], a[1], a[2:8], *a[8:13], a[13:]),
        in_dims=(0,) * 11 + gd + (0,) * 4)(
        sdir4, wnd, *planes, *masks, inter, dest, *randoms)
    assert HE.launches["decide_move"] == n0 + 1 + (mix == "both")
    _same(vm, ref)


def test_decide_move_world_groups_in_one_launch(gen):
    """A batch with more tiles than one resident grid (1024 worlds of
    64^2, config #4's shape) runs as world groups in one launch: equal
    to the same worlds launched in batches that fit one grid, and world
    by world to the plain version on a few worlds."""
    B, H, W, D = 1024, 64, 64, 8
    plan = HE.dm_plan(B, H, W, form="coop")
    assert plan["groups"] > 1, plan
    assert HE.dm_plan(16, H, W)["groups"] == 1
    cfg = Config(WIDTH=W, HEIGHT=H, VEHICLE_MALFUNCTION_CHANCE=0.01,
                 VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    sdir4, wnd, planes, masks, _, _, randoms = _dm_inputs(gen, B, H, W, D)
    inter = _bern(gen, 0.1, B, H, W)
    dest = _rint(gen, -1, D, B, H, W)
    n0 = HE.launches["decide_move"]
    got = HE.decide_move_batched(cfg, sdir4, wnd, planes, *masks, inter,
                                 dest, randoms, form="coop")
    assert HE.launches["decide_move"] == n0 + 1
    step = 128
    assert HE.dm_plan(step, H, W)["groups"] == 1
    for b0 in range(0, B, step):
        s = slice(b0, b0 + step)
        part = HE.decide_move_batched(
            cfg, sdir4[s], wnd[s], tuple(p[s] for p in planes),
            *(m[s] for m in masks), inter[s], dest[s],
            tuple(r[s] for r in randoms), form="coop")
        _same([o[s] for o in got], part)
    for b in (0, 527, B - 1):
        ref = HE.decide_move_core(
            cfg, sdir4[b], wnd[b], *(p[b] for p in planes),
            *(m[b] for m in masks), inter[b], dest[b],
            *(r[b] for r in randoms))
        _same([o[b] for o in got], ref)


@pytest.mark.parametrize("B,H,W,speed,moving", [
    (1024, 64, 64, 5, False), (1024, 64, 64, 5, True), (3, 64, 64, 5, False),
    (5, 60, 50, 2, True), (2, 128, 128, 5, True)])
def test_decide_move_worlds_form_matches_plain(gen, B, H, W, speed, moving):
    """K1's block-per-world form (one block owns one world, its keys and
    pub bytes in shared memory): one device kernel a call, each world
    equal to its plain version and to the cooperative form, at config
    #4's shape, a batch too small to choose it, a ragged world and the
    largest square world one block holds, on dense random planes with
    each world's own geometry or with most vehicles moving; the form
    `dm_plan` reports is the shape's (`k1_form`)."""
    D = 8
    cfg = Config(WIDTH=W, HEIGHT=H, VEHICLE_MALFUNCTION_CHANCE=0.01,
                 VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3,
                 VEHICLE_MAX_SPEED=speed)
    if moving:
        sdir4, wnd, planes, masks, inter, dest, randoms = _moving_worlds(
            gen, B, H, W, D)
    else:
        sdir4, wnd, planes, masks, _, _, randoms = _dm_inputs(gen, B, H, W,
                                                              D)
        inter = _bern(gen, 0.1, B, H, W)
        dest = _rint(gen, -1, D, B, H, W)
    plan = HE.dm_plan(B, H, W)
    assert plan["form"] == HE.k1_form(B, H, W, *HE.card_numbers())
    assert plan["form"] == ("worlds" if B == 1024 else "coop"), plan
    wplan = HE.dm_plan(B, H, W, form="worlds")
    assert wplan["blocks_per_sm"] >= 1 and wplan["blocks"] == B, wplan
    n0 = dict(HE.launches)
    got = HE.decide_move_batched(cfg, sdir4, wnd, planes, *masks, inter,
                                 dest, randoms, form="worlds")
    assert HE.launches["decide_move_blocks"] == n0["decide_move_blocks"] + 1
    assert HE.launches["decide_move"] == n0["decide_move"]
    geo = (lambda t, b: t[b]) if inter.dim() == 3 else (lambda t, b: t)
    for b in sorted({0, B // 2, B - 1}):
        ref = HE.decide_move_core(
            cfg, sdir4[b], wnd[b], *(p[b] for p in planes),
            *(m[b] for m in masks), geo(inter, b), geo(dest, b),
            *(r[b] for r in randoms))
        _same([o[b] for o in got], ref)
    if moving:
        assert int(((got[6] & HE.FLAG_MOVED) != 0).sum()) > 0
    if B <= 16:
        _same(got, HE.decide_move_core_batched(cfg, sdir4, wnd, planes,
                                               *masks, inter, dest, randoms))
    # the cooperative form on the same inputs: the same bits
    _same(got, HE.decide_move_batched(cfg, sdir4, wnd, planes, *masks, inter,
                                      dest, randoms, form="coop"))
    names, n = _device_kernels(lambda: HE.decide_move_batched(
        cfg, sdir4, wnd, planes, *masks, inter, dest, randoms,
        form="worlds"))
    assert n == 1 and "dm_worlds" in names[0], names


def test_decide_move_worlds_form_rejects_a_world_too_large(gen):
    """A world past one block's shared memory (or past 64 tiles) fails in
    the block-per-world form; it never runs in another form."""
    B, H, W, D = 2, 128, 160, 8
    assert HE.k1_form(B, H, W, *HE.card_numbers()) == "coop"
    cfg = Config(WIDTH=W, HEIGHT=H)
    sdir4, wnd, planes, masks, _, _, randoms = _dm_inputs(gen, B, H, W, D)
    with pytest.raises(RuntimeError, match="tsim_decide_move_worlds"):
        HE.decide_move_batched(cfg, sdir4, wnd, planes, *masks,
                               _bern(gen, 0.1, B, H, W),
                               _rint(gen, -1, D, B, H, W), randoms,
                               form="worlds")


@pytest.mark.parametrize("D", [8, 10])
def test_sdir_stacks_kernel_matches_plain(gen, D):
    """K2 over a batch of key stacks (one K0 and one set of legal planes
    a world, or either shared): one launch, equal to the plain version;
    under vmap with K0 batched, K2 once and K5 not at all."""
    H, W, B = 33, 270, 3
    q = _rint(gen, 0, 60000, B, D, 4, H, W)
    q = torch.where(_bern(gen, 0.15, B, D, 4, H, W), 65535, q)
    K0 = engine.costs_u16_to_keys(q)
    pen4b = torch.where(_bern(gen, 0.1, B, 4, H, W), 1 << 17,
                        _rint(gen, 0, 3000, B, 4, H, W))
    legal4 = _bern(gen, 0.6, B, 4, H, W).to(torch.int32)
    for k0, lg in ((K0, legal4), (K0[1], legal4), (K0, legal4[2])):
        n0 = dict(HE.launches)
        got = HE.build_sdir_stacks(k0, pen4b, lg, 20)
        assert HE.launches["build_sdir"] == n0["build_sdir"] + 1
        _same((got,), (HE.sdir_encode_batched(k0, pen4b, lg, 20),))
    n0 = dict(HE.launches)
    vm = torch.func.vmap(HE.build_sdir, in_dims=(0, 0, 0, None))(
        K0, pen4b, legal4, 20)
    assert HE.launches["build_sdir"] == n0["build_sdir"] + 1
    assert HE.launches["build_sdir_batched"] == n0["build_sdir_batched"]
    _same((vm,), (HE.sdir_encode_batched(K0, pen4b, legal4, 20),))


@pytest.mark.parametrize("shape", [(3, 37, 300), (1024, 64, 64)])
def test_wavefront_per_world_geometry_matches_plain(gen, shape):
    """K3 with allowed and is_road one plane a world: one launch, equal
    to the plain version (at config #4's batch too, on a few worlds);
    under vmap with the geometry batched, one launch."""
    B, H, W = shape
    cfg = Config(WIDTH=W, HEIGHT=H)
    allowed, road, hard = _geo_batch(gen, B, H, W)
    hard = hard & road
    n0 = HE.launches["build_wavefront"]
    got = HE.build_wavefront_batched(cfg, allowed, road, hard)
    assert HE.launches["build_wavefront"] == n0 + 1
    for b in ((0, 1, 2) if B == 3 else (0, 511, B - 1)):
        _same((got[b],), (HE.wavefront_core(cfg, allowed[b], road[b],
                                            hard[b]),))
    vm = torch.func.vmap(lambda a, r, h: HE.build_wavefront(cfg, a, r, h))(
        allowed, road, hard)
    assert HE.launches["build_wavefront"] == n0 + 2
    _same((vm,), (got,))
    # one geometry plane shared beside a batched one: the vmap rule
    # broadcasts it, one launch
    mixed = torch.func.vmap(
        lambda a, r, h: HE.build_wavefront(cfg, a, r, h),
        in_dims=(None, 0, 0))(allowed[0], road, hard)
    assert HE.launches["build_wavefront"] == n0 + 3
    _same((mixed,), (HE.wavefront_core_batched(cfg, allowed[0], road,
                                               hard),))


# ---- pedestrians -----------------------------------------------------------

_PED_CODES = (2, 2, 2, 17, 15, 16, 9, 10, 11, 12, 0, 1)


def _ped_inputs(gen, B, H, W, hi=2000, per_world=False):
    """Random cell codes (sidewalks the most common), stop maps, counts
    of 0..hi and u32 seeds for B worlds."""
    codes = torch.tensor(_PED_CODES, dtype=torch.uint8, device="cuda")
    cell = codes[_rint(gen, 0, len(_PED_CODES),
                       *((B,) if per_world else ()), H, W).long()]
    stop = _bern(gen, 0.5, B, H, W)
    walk = _rint(gen, 0, hi, B, 4, H, W)
    cross = _rint(gen, 0, hi, B, 4, H, W)
    seeds = _rint(gen, -2**31, 2**31, B, 14).to(torch.int64) & 0xFFFFFFFF
    return walk, cross, cell, stop, seeds


@pytest.mark.parametrize("shape,hi", [((37, 53), 2000), ((37, 300), 20000),
                                      ((256, 256), 50)])
def test_step_pedestrians_kernel_matches_plain(gen, shape, hi):
    """One world: one launch, bit-equal to the plain version on every
    output (ragged shapes; counts large enough that every fractional
    split rounds)."""
    from trafficsimulation_tpu_torch.agents.pedestrians import \
        step_pedestrians_plain
    H, W = shape
    cfg = Config(WIDTH=W, HEIGHT=H, PEDESTRIANS_ENABLED=True,
                 PEDESTRIANS_PER_DAY=2_000_000)
    walk, cross, cell, stop, seeds = _ped_inputs(gen, 1, H, W, hi)
    args = (walk[0], cross[0], cell, stop[0], seeds[0])
    n_side = sidewalk_count(cell)
    n0 = HE.launches["step_pedestrians"]
    got = HE.step_pedestrians(cfg, *args, n_side)
    assert HE.launches["step_pedestrians"] == n0 + 1
    ref = step_pedestrians_plain(cfg, *args)
    _same(got, ref)
    assert bool(ref[2].any())
    _, n = _device_kernels(lambda: HE.step_pedestrians(cfg, *args, n_side))
    assert n == 1


@pytest.mark.parametrize("per_world", [False, True])
def test_step_pedestrians_batched_and_vmapped(gen, per_world):
    """B = 3 worlds, cell_type shared or one plane a world: the batched
    kernel and the wrapper under torch.func.vmap each launch once and
    equal the plain version world by world."""
    from trafficsimulation_tpu_torch.agents.pedestrians import \
        step_pedestrians_plain
    B, H, W = 3, 45, 70
    cfg = Config(WIDTH=W, HEIGHT=H, PEDESTRIANS_ENABLED=True,
                 PEDESTRIANS_PER_DAY=2_000_000)
    walk, cross, cell, stop, seeds = _ped_inputs(gen, B, H, W,
                                                 per_world=per_world)
    n_side = sidewalk_count(cell)
    n0 = HE.launches["step_pedestrians"]
    got = HE.step_pedestrians_batched(cfg, walk, cross, cell, stop, seeds,
                                      n_side)
    assert HE.launches["step_pedestrians"] == n0 + 1
    gd = 0 if per_world else None
    vm = torch.func.vmap(
        lambda w, c, g, s, k, n: HE.step_pedestrians(cfg, w, c, g, s, k, n),
        in_dims=(0, 0, gd, 0, 0, gd))(walk, cross, cell, stop, seeds, n_side)
    assert HE.launches["step_pedestrians"] == n0 + 2
    for b in range(B):
        ref = step_pedestrians_plain(cfg, walk[b], cross[b],
                                     cell[b] if per_world else cell,
                                     stop[b], seeds[b])
        _same(tuple(g[b] for g in got), ref)
        _same(tuple(v[b] for v in vm), ref)
