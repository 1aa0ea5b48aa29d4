"""The PyTorch port's tick as a whole against the JAX package: the same
world goes through JAX's `run_chunk` and the port's, and every leaf of
the end state must agree.

Integer and bool leaves must be equal.  f32 leaves (the service load
`pl`/`vehicles.load`, the metric duration sums, the rain cloud floats,
density, block tanks) are compared with rtol=1e-6, atol=0, but should in
fact be exact: `pl` is only moved, never summed; the rain floats are
elementwise IEEE ops in the JAX order (the one multiply-add XLA fuses is
fused in the port too); the metric sums add integer multiples of
TIME_PER_STEP_IN_SECONDS far below 2^24.  Any drift therefore means a
changed op order.

The worlds run with VEHICLE_MAX_SPEED=2: XLA's CPU compile of the JAX
`run_chunk` grows steeply with the unrolled movement sub-rounds (about
16 s at 2 sub-rounds, 98 s at the default 5, for a 5-tick chunk).  The
5-sub-round decide + move is held against JAX in test_torch_kernels.py,
and at the headline's full size by chip_smoke.py.
"""

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
from trafficsimulation_tpu import sim as jsim

from trafficsimulation_tpu_torch import sim as tsim
from trafficsimulation_tpu_torch.core.transfer import (world_from_numpy,
                                                       world_to_numpy)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_snapshot import world_to_leaves  # noqa: E402

torch.set_num_threads(2)

CROSS = Config(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64,
               RAIN_SPAWN_CHANCE=0.5, RAIN_RADIUS_MIN=3, RAIN_RADIUS_MAX=9,
               VEHICLE_MAX_SPEED=2)
N_TICKS = 23


def assert_leaves_match(ref: dict, got: dict, skip=("cost_field",)):
    """Every leaf of `ref` equals `got`: integers and bools exactly, f32
    within rtol=1e-6 (see the module docstring)."""
    bad = []
    for k, a in ref.items():
        if k in skip:
            continue
        assert k in got, f"port has no leaf {k}"
        b = got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (k, a.shape, a.dtype, b.shape, b.dtype)
        if np.issubdtype(a.dtype, np.floating):
            if not np.allclose(a, b, rtol=1e-6, atol=0.0):
                bad.append((k, int((a != b).sum())))
        elif not np.array_equal(a, b):
            bad.append((k, int((a != b).sum())))
    assert not bad, f"leaves differ (name, entries): {bad}"


def _run_both(cfg, world, n):
    leaves = world_to_leaves(world)
    end_jax = jax.jit(functools.partial(jsim.run_chunk, cfg, n=n))(world)
    port = world_from_numpy(leaves, "cpu")
    end_port = tsim.run_chunk(cfg, port, n)
    return end_jax, world_to_leaves(end_jax), world_to_numpy(end_port)


@functools.cache
def _crossroad_run():
    return _run_both(CROSS, crossroad_world(CROSS), N_TICKS)


def test_run_chunk_crossroad_matches_jax():
    _, ref, got = _crossroad_run()
    assert_leaves_match(ref, got)
    # the run exercised spawns, moves and rain
    assert ref["metrics.created_internal"] + ref["metrics.created_through"] > 0
    assert ref["rain.active"].any() or ref["rain.cooldown"] > 0


def _put_service_vehicle(world, slot, flat, dest, heading, kind, block,
                         load):
    v = world.vehicles
    i = jnp.asarray([slot])
    v = v.replace(active=v.active.at[i].set(True), pos=v.pos.at[i].set(flat),
                  heading=v.heading.at[i].set(heading),
                  dest=v.dest.at[i].set(dest), kind=v.kind.at[i].set(kind),
                  service_block=v.service_block.at[i].set(block),
                  load=v.load.at[i].set(load))
    vm = world.veh_map.reshape(-1).at[flat].set(slot)
    return world.replace(vehicles=v, veh_map=vm.reshape(world.veh_map.shape))


def test_run_chunk_service_vehicles_match_jax():
    """A food and a waste service vehicle bound for the crossroad's two
    block entrances: arrival, parking, the load transfer into the block
    tank (`food.index_add`), the service countdown and the next trip."""
    W = CROSS.WIDTH
    world = crossroad_world(CROSS)
    world = _put_service_vehicle(world, 60, 15 * W + 2, 0, 1, 2, 0, 50.0)
    world = _put_service_vehicle(world, 61, 16 * W + 30, 1, 3, 3, 1, 0.0)
    _, ref, got = _run_both(CROSS, world, N_TICKS)
    assert_leaves_match(ref, got)
    assert ref["vehicles.service_phase"][60] == 1
    assert ref["vehicles.load"][60] < 50.0          # food was delivered


def test_run_chunk_small_world_matches_jax(small_cfg, small_world):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from bench import inject_vehicles
    cfg = small_cfg.replace(VEHICLE_MAX_SPEED=2)
    world = inject_vehicles(cfg, small_world, 200)
    _, ref, got = _run_both(cfg, world, N_TICKS)
    assert_leaves_match(ref, got)
    assert ref["vehicles.active"].sum() >= 150


def test_step_world_matches_jax():
    """One tick through `step_world` (routing planes and free slots
    built inside the tick)."""
    world = _crossroad_run()[0]
    leaves = world_to_leaves(world)
    ref = world_to_leaves(jax.jit(functools.partial(
        jsim.step_world, CROSS))(world))
    got = world_to_numpy(tsim.step_world(CROSS,
                                         world_from_numpy(leaves, "cpu")))
    assert_leaves_match(ref, got)


def test_traffic_sim_stats_keys(small_cfg, small_world):
    """`TrafficSim.stats` returns the JAX keys and values for one world."""
    leaves = world_to_leaves(small_world)
    port = tsim.TrafficSim.from_world(small_cfg,
                                      world_from_numpy(leaves, "cpu"))

    class _JaxSim(jsim.TrafficSim):
        def __init__(self, cfg, world):
            self.cfg, self.world = cfg, world

    ref = _JaxSim(small_cfg, small_world).stats()
    got = port.stats()
    assert ref.keys() == got.keys()
    for k in ref:
        assert ref[k] == pytest.approx(got[k]), k


def test_step_raises_when_demand_runs_out():
    world = crossroad_world(CROSS)      # 48 trips < 2 * spawn window
    port = tsim.TrafficSim.from_world(
        CROSS, world_from_numpy(world_to_leaves(world), "cpu"))
    with pytest.raises(NotImplementedError, match="generate_days"):
        port.step(3)
