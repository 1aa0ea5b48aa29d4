"""The plain PyTorch versions of the port's four kernels are bit-equal to
the JAX functions they replace, on the inputs the JAX package's own
kernel tests use (tests/test_pallas_engine.py): the XLA path of each
and, where the JAX test does, the Pallas kernel in interpret mode.

K1 decide+move (`decide_move_core`), K2 the sdir encode, K3 the
overtake wavefront, K4 the inclusive prefix planes.  The CUDA kernels
are held against these plain versions on the card (test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu.config import Config
from trafficsimulation_tpu.ops import engine as jengine
from trafficsimulation_tpu.ops import pallas_engine
from trafficsimulation_tpu.ops.routing import _shift_plane as jshift
from trafficsimulation_tpu.sim import _enter_engine

from trafficsimulation_tpu_torch.ops import engine as tengine
from trafficsimulation_tpu_torch.ops import hopper_engine as HE

from test_engine import make_world, put_vehicle, two_lane_road, CFG, H, W

torch.set_num_threads(2)


def T(x) -> torch.Tensor:
    """JAX array -> torch tensor (u32 as int32 bits)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def N(x) -> np.ndarray:
    """JAX or torch array -> numpy, u32 as int32 bits, for comparison."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype in (np.uint32, np.float32) else a


def _assert_same(ref, got, names):
    for n, a, b in zip(names, ref, got):
        a, b = N(a), N(b)
        assert a.shape == b.shape, (n, a.shape, b.shape)
        assert np.array_equal(a, b), \
            f"{n}: {int((a != b).sum())} entries differ"


def _decide_both(cfg, sdir4, wnd, planes, masks, dest, randoms):
    ref = pallas_engine.decide_move_core(
        cfg, jshift, lambda d: jengine.select_dest_rows(sdir4, d), wnd,
        *planes, *masks, dest, *randoms)
    got = HE.decide_move(cfg, T(sdir4), T(wnd), tuple(T(p) for p in planes),
                         *(T(m) for m in masks), T(dest),
                         tuple(T(r) for r in randoms))
    return ref, got


NAMES = ("pa", "pb", "pc", "pd", "pe", "pl", "flags")


def test_decide_move_plain_matches_jax_two_lane():
    """K1 plain on the two-lane synth world of the JAX kernel test."""
    cell, dirs, rc, dest_cell = two_lane_road()
    world = make_world(CFG, cell, dirs, rc, [dest_cell])
    world = put_vehicle(world, 0, 4 * W + 10, dest=0, parked=True)
    world = put_vehicle(world, 1, 4 * W + 7, dest=0)
    world = put_vehicle(world, 2, 4 * W + 3, dest=0)
    world = put_vehicle(world, 3, 5 * W + 20, dest=0, heading=3)
    es = _enter_engine(CFG, world)
    sd, wnd, _ = jengine.routing_planes(CFG, world, es)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(7), 4)
    randoms = (jax.random.uniform(k1, (H, W)),
               jax.random.uniform(k2, (H, W)),
               jax.random.randint(k3, (H, W), CFG.VEHICLE_MIN_SPEED,
                                  CFG.VEHICLE_MAX_SPEED + 1),
               jax.random.bits(k4, (H, W)))
    planes = (es.pa, es.pb, es.pc, es.pd, es.pe, es.pl)
    masks = (jnp.zeros((H, W), bool), es.rain_map, jnp.zeros((H, W), bool),
             world.grid.intersection)
    ref, got = _decide_both(CFG, sd, wnd, planes, masks, world.grid.dest_id,
                            randoms)
    _assert_same(ref, got, NAMES)
    assert (np.asarray(ref[6]) & HE.FLAG_MOVED).any()


@pytest.mark.parametrize("seed", [0, 3])
def test_decide_move_plain_matches_jax_random_dense(seed):
    """K1 plain on dense random planes (every fault flag, random sdir and
    wavefront bytes), 64^2, the five default sub-rounds, fault rolls
    that fire."""
    Hh, Ww, D = 64, 64, 8
    cfg = Config(WIDTH=Ww, HEIGHT=Hh, RAIN_ENABLED=True,
                 VEHICLE_MALFUNCTION_ACTIVE=True,
                 VEHICLE_SIDESWIPE_COLLISION_ACTIVE=True,
                 VEHICLE_MALFUNCTION_CHANCE=0.01,
                 VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3,
                 VEHICLE_MIN_SPEED=1, VEHICLE_MAX_SPEED=5,
                 MAX_VEHICLES=64, MAX_FIELD_DESTS=8)
    ks = jax.random.split(jax.random.PRNGKey(seed), 16)
    sdir = jengine.pack_sdir4(jax.random.randint(
        ks[0], (D, Hh, Ww), 0, 256).astype(jnp.uint8))
    wb = jax.random.randint(ks[1], (4, Hh, Ww), 0, 16)
    wnd = (wb[0] | (wb[1] << 8) | (wb[2] << 16)
           | (wb[3] << 24)).astype(jnp.int32)
    planes = tuple(jax.random.bits(ks[i + 2], (Hh, Ww))
                   for i in range(5)) + (
        jax.random.uniform(ks[7], (Hh, Ww)),)
    masks = (jax.random.bernoulli(ks[8], 0.15, (Hh, Ww)),
             jax.random.bernoulli(ks[9], 0.1, (Hh, Ww)),
             jax.random.bernoulli(ks[10], 0.02, (Hh, Ww)),
             jax.random.bernoulli(ks[11], 0.1, (Hh, Ww)))
    dest = jax.random.randint(ks[12], (Hh, Ww), -1, D)
    randoms = (jax.random.uniform(ks[13], (Hh, Ww)),
               jax.random.uniform(ks[14], (Hh, Ww)),
               jax.random.randint(ks[15], (Hh, Ww), 1, 6),
               jax.random.bits(ks[0], (Hh, Ww)))
    ref, got = _decide_both(cfg, sdir, wnd, planes, masks, dest, randoms)
    _assert_same(ref, got, NAMES)
    flags = np.asarray(ref[6])
    assert (flags & HE.FLAG_MOVED).any()
    assert (flags & HE.FLAG_NEW_MAL).any() and (flags & HE.FLAG_NEW_COL).any()


def _sdir_inputs(seed, D, Hh, Ww):
    rng = np.random.default_rng(seed)
    Q = rng.integers(0, 60000, (D, 4, Hh, Ww)).astype(np.uint16)
    Q = np.where(rng.random(Q.shape) < 0.15, 65535, Q).astype(np.uint16)
    allowed = rng.integers(0, 16, (Hh, Ww)).astype(np.uint8)
    is_road = rng.random((Hh, Ww)) < 0.7
    soft2 = rng.integers(0, 5000, (Hh, Ww)).astype(np.int32)
    hard = rng.random((Hh, Ww)) < 0.1
    return Q, allowed, is_road, soft2, hard


@pytest.mark.parametrize("D", [8, 10])
def test_sdir_plain_matches_xla_and_pallas(D):
    """K2 plain == engine.build_sdir (XLA) == build_sdir_pallas
    (interpret), with unreachable (INF_U16) keys and hard-blocked (2^17)
    pens; D = 10 checks the padded last word."""
    Hh, Ww = 16, 128
    cfg = CFG
    Q, allowed, is_road, soft2, hard = _sdir_inputs(9, D, Hh, Ww)
    K0 = jengine.costs_u16_to_keys(jnp.asarray(Q))
    args = (jnp.asarray(allowed), jnp.asarray(is_road), jnp.asarray(soft2),
            jnp.asarray(hard))
    xla = np.asarray(jengine.build_sdir(cfg, K0, *args, force_xla=True))
    legal, pen_m, _ = jengine._entry_costs(cfg, *args)
    pen4 = jnp.stack(pen_m)
    legal4 = jnp.stack([lg.astype(jnp.int32) for lg in legal])
    # the port's K0 from the same u16 costs, and its own entry costs
    tK0 = tengine.costs_u16_to_keys(torch.from_numpy(Q.astype(np.int32)))
    assert np.array_equal(N(K0), N(tK0))
    got = tengine.build_sdir(cfg, tK0, *(torch.from_numpy(np.array(a))
                                         for a in (allowed, is_road, soft2,
                                                   hard)))
    assert np.array_equal(xla, N(got))
    tp2 = int(round(2 * cfg.VEHICLE_TURN_PENALTY))
    plain = HE.sdir_encode(T(K0), T(pen4), T(legal4), tp2)
    assert np.array_equal(xla, N(plain))
    if D % 4 == 0:
        kern = np.asarray(pallas_engine.build_sdir_pallas(
            cfg, K0, pen4, legal4, interpret=True))
        assert np.array_equal(kern, N(plain))


def test_pack_and_select_match_jax():
    rng = np.random.default_rng(1)
    D, Hh, Ww = 10, 8, 16
    sd = rng.integers(0, 256, (D, Hh, Ww)).astype(np.uint8)
    dest = rng.integers(-1, 16, (Hh, Ww)).astype(np.int32)
    ref4 = jengine.pack_sdir4(jnp.asarray(sd))
    got4 = tengine.pack_sdir4(torch.from_numpy(sd))
    assert np.array_equal(N(ref4), N(got4))
    assert np.array_equal(
        np.asarray(jengine.select_dest_rows(ref4, jnp.asarray(dest))),
        N(HE.select_dest_rows(got4, torch.from_numpy(dest))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wavefront_plain_matches_core_and_pallas(seed):
    """K3 plain == wavefront_core (padded shifts) == the Pallas kernel in
    interpret mode, on random geometry."""
    cfg = Config(WIDTH=32, HEIGHT=32,
                 VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS=6)
    rng = np.random.default_rng(seed)
    allowed = rng.integers(0, 16, (32, 32)).astype(np.int32)
    road = rng.random((32, 32)) < 0.5
    hard = (rng.random((32, 32)) < 0.1) & road
    ref = np.asarray(pallas_engine.wavefront_core(
        cfg, jshift, jnp.asarray(allowed), jnp.asarray(road),
        jnp.asarray(hard)))
    kern = np.asarray(pallas_engine.build_wavefront_pallas(
        cfg, jnp.asarray(allowed), jnp.asarray(road), jnp.asarray(hard),
        interpret=True))
    got = HE.build_wavefront(cfg, torch.from_numpy(allowed.astype(np.uint8)),
                             torch.from_numpy(road), torch.from_numpy(hard))
    assert np.array_equal(ref, N(got))
    assert np.array_equal(kern, N(got))
    assert (N(got) != 0x07070707).any()


@pytest.mark.parametrize("shape", [(8, 16), (32, 32), (16, 64)])
def test_prefix_plain_matches_pallas(shape):
    """K4 plain == prefix_planes_pallas (interpret) on random planes."""
    rng = np.random.default_rng(4)
    occ = rng.integers(0, 2, shape).astype(np.int32)
    gh, gv = pallas_engine.prefix_planes_pallas(jnp.asarray(occ),
                                                interpret=True)
    th, tv = HE.prefix_planes(torch.from_numpy(occ))
    assert np.array_equal(np.asarray(gh), N(th))
    assert np.array_equal(np.asarray(gv), N(tv))


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors every wrapper runs its plain version and counts no
    kernel launch."""
    HE.reset_launches()
    occ = torch.ones((4, 8), dtype=torch.int32)
    HE.prefix_planes(occ)
    cfg = Config(WIDTH=8, HEIGHT=4)
    z = torch.zeros((4, 8), dtype=torch.bool)
    HE.build_wavefront(cfg, torch.zeros((4, 8), dtype=torch.uint8), z, z)
    HE.build_sdir(torch.zeros((4, 4, 4, 8), dtype=torch.int32),
                  torch.zeros((4, 4, 8), dtype=torch.int32),
                  torch.zeros((4, 4, 8), dtype=torch.int32), 20)
    assert all(v == 0 for v in HE.launches.values())
    with pytest.raises(ValueError):
        HE.prefix_planes(occ.to("meta"))
