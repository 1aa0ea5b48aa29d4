#!/usr/bin/env python
"""Write the JAX reference digest of the RL light controllers.

The machine that runs the PyTorch port has no JAX.  For each of the
three controller families (NEIGHBOR_RL_BATCHED: REINFORCE, 10 x 128,
SRL_INPUT_DIMENSIONS = 13; RL_A2C_BATCHED: 10 x 256; GAT_DQN_BATCHED:
GAT 16, 2 x 32, replay 10,000) this digest holds, as the JAX package
computes them with `jax.jit`:

  * `crossroad`: the synthetic crossroad (`core.synth.crossroad_world`,
    32 x 32, key PRNGKey(0)), every leaf but the key stack at init and
    after 23 ticks of `run_chunk`;
  * `headline256`: BASELINE config #2 as `bench.py` builds it (256 x 256
    from seed 0, MAX_FIELD_DESTS=640, `measure_and_shrink`,
    `inject_vehicles(..., 10_000)`) with the RL controller's train state
    initialised as `measure_and_shrink` does it (the world key, the
    shrunk group count): the same leaves at init and after 23 ticks.

Training is held off for the window (SRL_UPDATE_EVERY above the window's
transitions, GAT_BATCH_SIZE above the replay capacity; A2C's 32-tick
rollout is longer than 23 ticks), so the 23 ticks exercise the features,
the nets' forward passes, the sampled actions, the phase mechanics and
the buffers, and every integer leaf must come out exact.  All other
settings are the Config's defaults.

Each world is a dict: leaf path -> dtype, shape and sha256 (f32 leaves
also carry their float64 sum, sum of magnitudes and maximum).  The port
draws its initial parameters from another generator than flax's
(`rl/nets.py`), so the initial parameters of each family also ship as
arrays (`data/rl_params.npz`, flax's names, both worlds share them: the
key is PRNGKey(0) in both and no net depends on the group count); the
digest holds their sha256s.

Run from the repository root, on the CPU (~15 min on 8 cores):

    JAX_PLATFORMS=cpu python tools/make_torch_rl_digest.py

It writes `trafficsimulation_tpu_torch/data/rl_digest.json` and
`trafficsimulation_tpu_torch/data/rl_params.npz`.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data")
OUT = os.path.join(DATA, "rl_digest.json")
PARAMS = os.path.join(DATA, "rl_params.npz")
FAMILIES = ("NEIGHBOR_RL_BATCHED", "RL_A2C_BATCHED", "GAT_DQN_BATCHED")
TICKS = 23
CROSSROAD = dict(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64,
                 VEHICLE_MAX_SPEED=2)
HEADLINE = dict(WIDTH=256, HEIGHT=256, MAX_VEHICLES=10_000,
                MAX_FIELD_DESTS=640)
HEADLINE_VEHICLES = 10_000


def hold_off(cfg, algo):
    """`cfg` with the RL family `algo` and its training held off for the
    window."""
    return dataclasses.replace(
        cfg, TRAFFIC_LIGHT_AGENT_ALGORITHM=algo, SRL_UPDATE_EVERY=10 ** 6,
        GAT_BATCH_SIZE=cfg.GAT_MEMORY_CAPACITY + 1)


def params_of(leaves: dict) -> dict:
    """The initial parameters by flax name ("Dense_0.kernel", ...)."""
    pre = "rl.params.params."
    return {k[len(pre):]: v for k, v in leaves.items() if k.startswith(pre)}


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax
    from trafficsimulation_tpu.utils import xla_cache_dir
    jax.config.update("jax_compilation_cache_dir", xla_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    from make_torch_hier_digest import cfg_kwargs, leaf_digest
    from make_torch_snapshot import build_headline, world_to_leaves
    from trafficsimulation_tpu.config import Config
    from trafficsimulation_tpu.core.synth import crossroad_world
    from trafficsimulation_tpu.rl.controllers import init_rl_state
    from trafficsimulation_tpu.sim import run_chunk

    def digest(world) -> dict:
        return {k: leaf_digest(v) for k, v in world_to_leaves(world).items()
                if k != "cost_field"}

    def run(cfg, world) -> dict:
        leaves0 = world_to_leaves(world)
        end = jax.block_until_ready(jax.jit(functools.partial(
            run_chunk, cfg, n=TICKS))(world))
        ps = params_of(leaves0)
        return ps, {
            "init": digest(world), f"tick{TICKS}": digest(end),
            "params_sha256": {k: hashlib.sha256(v.tobytes()).hexdigest()
                              for k, v in ps.items()},
            "counts": {"active_vehicles": int(np.asarray(
                end.vehicles.active).sum()),
                "groups": int(np.asarray(end.groups_static.valid).sum()),
                "switched": int((np.asarray(end.lights.current_phase) >= 0)
                                .sum())}}

    out = {"families": list(FAMILIES), "ticks": TICKS}
    params, secs = {}, {}

    t = time.perf_counter()
    cross = {"cfg": cfg_kwargs(Config(**CROSSROAD))}
    for algo in FAMILIES:
        cfg = hold_off(Config(**CROSSROAD), algo)
        ps, cross[algo] = run(cfg, crossroad_world(
            cfg, key=jax.random.PRNGKey(0)))
        params[algo] = ps
        print("crossroad", algo, cross[algo]["counts"],
              round(time.perf_counter() - t, 1), flush=True)
    out["crossroad"] = cross
    secs["crossroad"] = time.perf_counter() - t

    t = time.perf_counter()
    cfg2, world = build_headline()
    head = {"cfg": cfg_kwargs(cfg2), "seed": 0,
            "n_vehicles": HEADLINE_VEHICLES}
    print("headline built", round(time.perf_counter() - t, 1), flush=True)
    for algo in FAMILIES:
        cfg = hold_off(cfg2, algo)
        w = world.replace(rl=init_rl_state(
            cfg, cfg.capacities().max_groups, world.key))
        ps, head[algo] = run(cfg, w)
        for k, v in ps.items():
            assert np.array_equal(v, params[algo][k]), (algo, k)
        print("headline256", algo, head[algo]["counts"],
              round(time.perf_counter() - t, 1), flush=True)
    out["headline256"] = head
    secs["headline256"] = time.perf_counter() - t

    with open(OUT, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
    np.savez_compressed(PARAMS, **{f"{algo}.{k}": v
                                   for algo, ps in params.items()
                                   for k, v in ps.items()})
    print(json.dumps({"out": [os.path.relpath(p, ROOT) for p in (OUT,
                                                                PARAMS)],
                      "bytes": [os.path.getsize(p) for p in (OUT, PARAMS)],
                      "seconds": {k: round(v, 1) for k, v in secs.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
