"""The port's routing layer against the JAX package: the value-iterated
cost fields and their key encoding (f32 fields and i32 keys bit-equal),
the density map, the dynamic soft-cost plane `soft2` and the routing
planes built from them."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu.config import Config
from trafficsimulation_tpu.core.synth import crossroad_world
from trafficsimulation_tpu.ops import engine as jengine
from trafficsimulation_tpu.ops import routing as jrouting
from trafficsimulation_tpu.ops.density import density_map as jdensity
from trafficsimulation_tpu.sim import _enter_engine

from trafficsimulation_tpu_torch import snapshot
from trafficsimulation_tpu_torch import sim as tsim
from trafficsimulation_tpu_torch.core.transfer import world_from_numpy
from trafficsimulation_tpu_torch.ops import engine as tengine
from trafficsimulation_tpu_torch.ops import routing as trouting
from trafficsimulation_tpu_torch.ops.density import density_map as tdensity

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_snapshot import world_to_leaves  # noqa: E402

torch.set_num_threads(2)


def T(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def _fields_both(cfg, allowed, rc, pos, valid, road):
    Fj = jrouting.compute_cost_fields(cfg, jnp.asarray(allowed),
                                      jnp.asarray(rc), jnp.asarray(pos),
                                      jnp.asarray(valid),
                                      is_road=jnp.asarray(road))
    Kj = jengine.field_to_keys(cfg, Fj, jnp.asarray(rc))
    Ft = trouting.compute_cost_fields(cfg, T(allowed), T(rc), T(pos),
                                      T(valid), is_road=T(road))
    Kt = tengine.field_to_keys(cfg, Ft, T(rc))
    return np.asarray(Fj), np.asarray(Kj), Ft.numpy(), Kt.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cost_fields_and_keys_match_jax_random(seed):
    """Random 32^2 lane graphs: f32 fields bit-equal, keys equal."""
    rng = np.random.default_rng(seed)
    cfg = Config(WIDTH=32, HEIGHT=32)
    allowed = rng.integers(0, 16, (32, 32)).astype(np.uint8)
    rc = rng.integers(0, 4, (32, 32)).astype(np.uint8)
    road = rng.random((32, 32)) < 0.6
    pos = rng.integers(0, 32 * 32, 6).astype(np.int32)
    valid = np.array([True, True, True, False, True, True])
    Fj, Kj, Ft, Kt = _fields_both(cfg, allowed, rc, pos, valid, road)
    assert np.array_equal(Fj.view(np.int32), Ft.view(np.int32))
    assert np.array_equal(Kj, Kt)
    assert (Kt >> 2 < (1 << 19)).any() and (Kt >> 2 >= (1 << 19)).any()


def test_cost_fields_and_keys_match_jax_crossroad():
    cfg = Config(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8)
    w = crossroad_world(cfg)
    g, d = w.grid, w.dests
    Fj, Kj, Ft, Kt = _fields_both(cfg, g.allowed_dirs, g.road_class,
                                  d.pos[:8], d.valid[:8], g.is_road)
    assert np.array_equal(Fj.view(np.int32), Ft.view(np.int32))
    assert np.array_equal(Kj, Kt)
    assert np.array_equal(np.asarray(w.cost_field), Kt)


def test_build_field_matches_generated_world(small_cfg, small_world):
    """`snapshot.build_field` on a generated 64^2 world rebuilds the key
    stack `init_world` made, byte for byte."""
    leaves = world_to_leaves(small_world)
    ref = leaves.pop("cost_field")
    world = snapshot.build_field(small_cfg, world_from_numpy(leaves, "cpu"))
    assert snapshot.field_sha256(world.cost_field) == \
        snapshot.field_sha256(torch.from_numpy(np.array(ref)))
    assert np.array_equal(snapshot.field_row_sums(world.cost_field),
                          ref.reshape(ref.shape[0], -1).astype(
                              np.int64).sum(1))


def test_density_map_matches_jax():
    rng = np.random.default_rng(3)
    occ = rng.random((48, 40)) < 0.3
    road = rng.random((48, 40)) < 0.6
    for r in (1, 4, 10):
        a = np.asarray(jax.jit(jdensity, static_argnums=2)(
            jnp.asarray(occ), jnp.asarray(road), r))
        b = tdensity(T(occ), T(road), r).numpy()
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), r


def _jax_soft2(cfg, pa, stop_map, density):
    """engine.routing_planes' soft2 lines (ops/engine.py:635-649), jitted
    as the JAX tick runs them."""
    present = (pa & 1) == 1
    stranded = present & (jengine._bit(pa, jengine.PA_COL_SH)
                          | jengine._bit(pa, jengine.PA_MAL_SH)
                          | jengine._bit(pa, jengine.PA_PARKED_SH))
    occ_moving = present & ~stranded
    vp = cfg.VEHICLE_OBSTACLE_PENALTY_VEHICLE * (
        1.0 + cfg.VEHICLE_DYNAMIC_PENALTY_SCALE * density)
    soft = jnp.where(occ_moving, vp, 0.0) + jnp.where(
        stop_map, jnp.float32(cfg.VEHICLE_OBSTACLE_PENALTY_STOP), 0.0)
    return jnp.round(2.0 * soft).astype(jnp.int32), stranded


def _dense_state(small_cfg, small_world):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from bench import inject_vehicles
    world = inject_vehicles(small_cfg, small_world, 200)
    rng = np.random.default_rng(5)
    stop = jnp.asarray(rng.random(world.stop_map.shape) < 0.1)
    es = _enter_engine(small_cfg, world)
    # strand a few vehicles so `hard` is not empty
    pa = np.asarray(es.pa).copy()
    pa[(pa & 1 == 1) & (rng.random(pa.shape) < 0.1)] |= np.uint32(1 << 14)
    es = es.replace(pa=jnp.asarray(pa), stop_map=stop)
    return world, es


def test_soft2_plane_matches_jax(small_cfg, small_world):
    world, es = _dense_state(small_cfg, small_world)
    present = (es.pa & 1) == 1
    density = jdensity(present, world.grid.is_road,
                       small_cfg.VEHICLE_AWARENESS_RANGE)
    soft2, hard = jax.jit(functools.partial(_jax_soft2, small_cfg))(
        es.pa, es.stop_map, density)
    t2, th = tengine.soft_penalties(
        small_cfg, T(np.asarray(es.pa).view(np.int32)), T(es.stop_map),
        T(density))
    assert np.array_equal(np.asarray(soft2), t2.numpy())
    assert np.array_equal(np.asarray(hard), th.numpy())
    assert (t2.numpy() > 0).any()


def test_routing_planes_match_jax(small_cfg, small_world):
    """sdir4, wnd and density from the JAX `routing_planes` (jitted) and
    the port's, on a loaded 64^2 world with stops and stranded cars."""
    world, es = _dense_state(small_cfg, small_world)
    ref = jax.jit(functools.partial(jengine.routing_planes, small_cfg))(
        world, es)
    tw = world_from_numpy(world_to_leaves(world), "cpu")
    tes = tsim._enter_engine(small_cfg, tw).replace(
        pa=T(np.asarray(es.pa).view(np.int32)), stop_map=T(es.stop_map))
    got = tengine.routing_planes(small_cfg, tw, tes)
    for name, a, b in zip(("sdir4", "wnd", "density"), ref, got):
        a = np.asarray(a)
        b = b.numpy()
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), name
