"""The port's light control against the JAX package on the generated
64^2 world: per-group queue reductions (through the K4 prefix planes),
the five FSM controllers, the phase commit, the host overrides and the
run-based stop map, over 30 ticks of random occupancy."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu.lights import fsm as jfsm

from trafficsimulation_tpu_torch.core.transfer import world_from_numpy
from trafficsimulation_tpu_torch.lights import fsm as tfsm

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_snapshot import world_to_leaves  # noqa: E402

torch.set_num_threads(2)

N_TICKS = 30


def T(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def _same(a, b, what):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype and np.array_equal(a, b), what


def _lights_same(jl, tl, what):
    for f in ("current_phase", "pending_phase", "transition_timer",
              "clearance_timer", "ft_phase", "fixed_time_timer",
              "queue_timer", "gap_timer", "last_arrival", "ns_pressure",
              "ew_pressure", "rl_timer", "light_stop"):
        _same(getattr(jl, f), getattr(tl, f), f"{what}: {f}")


@pytest.mark.parametrize("algo", ["FIXED_TIME", "QUEUE_ACTUATED",
                                  "PRESSURE_CONTROL",
                                  "NEIGHBOR_PRESSURE_CONTROL",
                                  "NEIGHBOR_GREEN_WAVE"])
def test_lights_match_jax_over_random_ticks(small_cfg, small_world, algo):
    cfg = small_cfg.replace(TRAFFIC_LIGHT_AGENT_ALGORITHM=algo)
    caps = cfg.capacities()
    G = caps.max_groups
    w = small_world
    tw = world_from_numpy(world_to_leaves(w), "cpu")
    jl = jfsm.init_lights_state(cfg, G, w.lights_static.valid.shape[0],
                                w.groups_static.valid)
    tl = tfsm.init_lights_state(cfg, G, tw.lights_static.valid.shape[0],
                                tw.groups_static.valid)
    _lights_same(jl, tl, "init")
    rng = np.random.default_rng(11)
    road = np.asarray(w.grid.is_road)
    L = w.lights_static.valid.shape[0]
    switched = 0
    for t in range(N_TICKS):
        occ = road & (rng.random(road.shape) < rng.uniform(0.05, 0.6))
        red_j = jfsm.group_reductions(w.grid, jnp.asarray(occ), G,
                                      gs=w.groups_static, use_pallas=False)
        red_t = tfsm.group_reductions(tw.grid, T(occ), G, tw.groups_static)
        for i, (a, b) in enumerate(zip(red_j, red_t)):
            _same(a, b, f"tick {t} reduction {i}")
        jl = jfsm.run_controllers(cfg, w.grid, w.groups_static, jl,
                                  jnp.asarray(occ), reductions=red_j[:4])
        tl = tfsm.run_controllers(cfg, tw.grid, tw.groups_static, tl,
                                  T(occ), reductions=red_t[:4])
        _lights_same(jl, tl, f"tick {t} controllers")
        before = np.asarray(jl.current_phase).copy()
        jl = jfsm.execute_phase_change(cfg, w.lights_static,
                                       w.groups_static, jl, red_j[4])
        tl = tfsm.execute_phase_change(cfg, tw.lights_static,
                                       tw.groups_static, tl, red_t[4])
        _lights_same(jl, tl, f"tick {t} phase change")
        switched += int((np.asarray(jl.current_phase) != before).sum())
        force = rng.choice([-1, -1, -1, 0, 1], size=L).astype(np.int8)
        jl = jfsm.apply_light_overrides(jl, jnp.asarray(force))
        tl = tfsm.apply_light_overrides(tl, T(force))
        _lights_same(jl, tl, f"tick {t} overrides")
        _same(jfsm.build_stop_map(w.grid, w.lights_static, jl),
              tfsm.build_stop_map(tw.grid, tw.lights_static, tl),
              f"tick {t} stop map")
    assert switched > 0


def test_rl_controllers_raise(small_cfg, small_world):
    cfg = small_cfg.replace(TRAFFIC_LIGHT_AGENT_ALGORITHM="RL_A2C_BATCHED")
    tw = world_from_numpy(world_to_leaves(small_world), "cpu")
    occ = torch.zeros(tw.grid.is_road.shape, dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="item 14"):
        tfsm.run_controllers(cfg, tw.grid, tw.groups_static, tw.lights, occ)
