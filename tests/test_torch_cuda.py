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


@pytest.mark.parametrize("algo,R", [("QUEUE_ACTUATED", 5),
                                    ("QUEUE_ACTUATED", 3),
                                    ("FIXED_TIME", 5),
                                    ("NEIGHBOR_PRESSURE_CONTROL", 5),
                                    ("NEIGHBOR_GREEN_WAVE", 4)])
def test_mega_kernel_matches_plain(gen, algo, R):
    """One segment of R ticks: K9 against `segment_plain` on the same
    inputs, from a world that has run a few ticks (lights switching,
    vehicles moving, trips spawning)."""
    from trafficsimulation_tpu_torch import sim
    from trafficsimulation_tpu_torch.ops import megakernel
    cfg, world = _mega_world(algo)
    world = sim.run_chunk(cfg, world, 7)
    es = sim._enter_engine(cfg, world)
    cs = megakernel.build_chunk_static(cfg, world)
    draws, _ = engine.tick_draws(cfg, sim._key_np(world.key), R)
    args, _ = megakernel.segment_inputs(
        cfg, world, es, cs, engine.routing_planes(cfg, world, es), R,
        torch.from_numpy(draws).cuda())
    n0 = HE.launches["mega"]
    got = HE.mega_segment(cfg, args)
    torch.cuda.synchronize()
    assert HE.launches["mega"] == n0 + 1
    _same_mega(got, megakernel.segment_plain(cfg, args))
    # a second launch gives the same bits (reproducible reductions)
    _same_mega(HE.mega_segment(cfg, args), got)


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
    with pytest.raises(TypeError):
        HE.mega_segment(cfg, {**args, "pb": args["pb"].to(torch.int64)})
    with pytest.raises(ValueError):
        HE.mega_segment(cfg, {**args, "pa": args["pa"].t()})


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
