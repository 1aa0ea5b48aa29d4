#!/usr/bin/env python
"""Write the JAX reference digest of the pedestrian and no-traffic
configurations.

The machine that runs the PyTorch port has no JAX.  This digest holds,
as the JAX package computes them with `jax.jit`:

  * `config3`: BASELINE config #3 exactly as `bench.py` `bench_config3`
    builds it (256x256 from seed 0, MAX_VEHICLES=4096,
    MAX_FIELD_DESTS=640, pedestrians on at 200k a day, then
    `measure_and_shrink` and `inject_vehicles(..., 4000)`): every leaf
    at init and after 100 and 200 ticks of the jitted `run_chunk` (two
    chunks of 100, the bench's chunk);
  * `cross_ped`: the synthetic crossroad (`core.synth.crossroad_world`
    under `__graft_entry__.dryrun_cfg()` with the FSM light controller
    in place of the RL one) with pedestrians on at a high rate, at init
    and after 20 ticks;
  * `cross_notraffic`: the same crossroad with ENABLE_TRAFFIC=False and
    pedestrians off, at init and after 40 ticks;
  * `config1`: BASELINE config #1 (`bench_config1`: 100x100,
    ENABLE_TRAFFIC=False, MAX_FIELD_DESTS=64, MAX_VEHICLES=256, no
    shrink): seeds 0-3 at init, and seed 0 after 200 ticks.

Each world is a dict: leaf path -> dtype, shape and sha256 (f32 leaves
also carry their float64 sum, sum of magnitudes and maximum).  Beside
them: each configuration's constructor arguments (the shrunk ones for
config #3) and a few counts (active vehicles and pedestrians).

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python tools/make_torch_ped_digest.py

It writes `trafficsimulation_tpu_torch/data/ped_digest.json`.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data",
                   "ped_digest.json")
# BASELINE config #3 (`bench.py` `bench_config3`), letter for letter
CONFIG3 = dict(WIDTH=256, HEIGHT=256, MAX_VEHICLES=4096,
               MAX_FIELD_DESTS=640, PEDESTRIANS_ENABLED=True,
               PEDESTRIANS_PER_DAY=200_000)
CONFIG3_VEHICLES = 4000
CONFIG3_CHUNK = 100
CONFIG3_CHUNKS = 2
# BASELINE config #1 (`bench.py` `bench_config1`), letter for letter
CONFIG1 = dict(WIDTH=100, HEIGHT=100, ENABLE_TRAFFIC=False,
               MAX_FIELD_DESTS=64, MAX_VEHICLES=256)
CONFIG1_SEEDS = 4
CONFIG1_TICKS = 200
# the crossroad: dryrun_cfg() with an FSM controller; pedestrians at
# ~139 expected spawns a tick (p ~ 0.15 a sidewalk cell)
CROSS_FSM = dict(TRAFFIC_LIGHT_AGENT_ALGORITHM="QUEUE_ACTUATED")
CROSS_PED = dict(PEDESTRIANS_ENABLED=True, PEDESTRIANS_PER_DAY=2_000_000)
CROSS_PED_TICKS = 20
CROSS_NOTRAFFIC = dict(ENABLE_TRAFFIC=False)
CROSS_NOTRAFFIC_TICKS = 40


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax
    from trafficsimulation_tpu.utils import xla_cache_dir
    jax.config.update("jax_compilation_cache_dir", xla_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    import bench
    from __graft_entry__ import dryrun_cfg
    from make_torch_hier_digest import cfg_kwargs, leaf_digest
    from make_torch_snapshot import world_to_leaves
    from trafficsimulation_tpu.config import Config
    from trafficsimulation_tpu.core.synth import crossroad_world
    from trafficsimulation_tpu.sim import (init_world, measure_and_shrink,
                                           run_chunk)

    def digest(world) -> dict:
        return {k: leaf_digest(v) for k, v in world_to_leaves(world).items()}

    def counts(world) -> dict:
        return {"active_vehicles": int(np.asarray(
                    world.vehicles.active).sum()),
                "active_pedestrians": int(np.asarray(world.peds.walk).sum()
                                          + np.asarray(world.peds.cross).sum()),
                "crossing_pedestrians": int(np.asarray(
                    world.peds.cross).sum())}

    out, secs = {}, {}

    # ---- the crossroads ---------------------------------------------------
    for name, extra, ticks in (("cross_ped", CROSS_PED, CROSS_PED_TICKS),
                               ("cross_notraffic", CROSS_NOTRAFFIC,
                                CROSS_NOTRAFFIC_TICKS)):
        t = time.perf_counter()
        cfg = dataclasses.replace(dryrun_cfg(), **CROSS_FSM, **extra)
        w0 = crossroad_world(cfg)
        w1 = jax.block_until_ready(jax.jit(functools.partial(
            run_chunk, cfg, n=ticks))(w0))
        out[name] = {"cfg": cfg_kwargs(cfg), "ticks": ticks,
                     "init": digest(w0), "end": digest(w1),
                     "counts": counts(w1)}
        secs[name] = time.perf_counter() - t
        print(name, out[name]["counts"], round(secs[name], 1), flush=True)

    # ---- config #1 ----------------------------------------------------------
    t = time.perf_counter()
    cfg1 = Config(**CONFIG1)
    gen = jax.jit(functools.partial(init_world, cfg1))
    worlds = [jax.block_until_ready(gen(jax.random.PRNGKey(s)))
              for s in range(CONFIG1_SEEDS)]
    end = jax.block_until_ready(jax.jit(functools.partial(
        run_chunk, cfg1, n=CONFIG1_TICKS))(worlds[0]))
    out["config1"] = {
        "cfg": cfg_kwargs(cfg1), "ticks": CONFIG1_TICKS,
        "init": [digest(w) for w in worlds], "end": digest(end),
        "lights": int(np.asarray(worlds[0].lights_static.valid).sum()),
        "counts": counts(end)}
    secs["config1"] = time.perf_counter() - t
    print("config1", out["config1"]["lights"], round(secs["config1"], 1),
          flush=True)
    del worlds, end

    # ---- config #3 ----------------------------------------------------------
    t = time.perf_counter()
    cfg3 = Config(**CONFIG3)
    world = jax.jit(functools.partial(init_world, cfg3))(
        jax.random.PRNGKey(0))
    cfg3, world = measure_and_shrink(cfg3, world)
    world = bench.inject_vehicles(cfg3, world, CONFIG3_VEHICLES)
    rec = {"cfg": cfg_kwargs(cfg3), "seed": 0,
           "n_vehicles": CONFIG3_VEHICLES, "chunk": CONFIG3_CHUNK,
           "init": digest(world), "counts_init": counts(world)}
    chunk = jax.jit(functools.partial(run_chunk, cfg3, n=CONFIG3_CHUNK))
    for i in range(1, CONFIG3_CHUNKS + 1):
        world = jax.block_until_ready(chunk(world))
        rec[f"tick{i * CONFIG3_CHUNK}"] = digest(world)
        rec[f"counts{i * CONFIG3_CHUNK}"] = counts(world)
        print("config3", i * CONFIG3_CHUNK, rec[f"counts{i * CONFIG3_CHUNK}"],
              round(time.perf_counter() - t, 1), flush=True)
    out["config3"] = rec
    secs["config3"] = time.perf_counter() - t

    with open(OUT, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
    print(json.dumps({"out": os.path.relpath(OUT, ROOT),
                      "bytes": os.path.getsize(OUT),
                      "seconds": {k: round(v, 1) for k, v in secs.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
