#!/usr/bin/env python
"""Write the JAX reference digest of a hierarchical-routing world.

The machine that runs the PyTorch port has no JAX.  BASELINE config #5
(1024x1024, 100k vehicles, `ROUTING_HIER`) is too large to build with
JAX on a CPU, so this digest holds the same configuration cut to 512x512
(a quarter of the area, so a quarter of the vehicles and of the daily
demand; `HIER_TILE` stays 64, so a tile's 3x3 window covers only part of
the grid and both the windowed bytes and the hub rows are used):

  * `init`: dtype, shape and sha256 of every leaf of the world after
    `sim.init_world_hier(cfg, PRNGKey(0))` and
    `bench.inject_vehicles(cfg, world, N_VEHICLES)`;
  * `end`: the same after `run_chunk(cfg, world, n=20)`;
  * f32 leaves also carry their float64 sum, sum of magnitudes and
    maximum, so that a mismatch can be sized;
  * `cfg`: the constructor arguments of the config `init_world_hier`
    returns (shrunk capacities, the dense row count).

Run from the repository root (several minutes on 8 CPU cores):

    JAX_PLATFORMS=cpu python tools/make_torch_hier_digest.py

It writes `trafficsimulation_tpu_torch/data/config5_hier512_digest.json`.
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
OUT = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data",
                   "config5_hier512_digest.json")
N_TICKS = 20
N_VEHICLES = 25_000
BASE_CFG = dict(WIDTH=512, HEIGHT=512, MAX_VEHICLES=N_VEHICLES,
                ROUTING_HIER=True,
                INTERNAL_POPULATION_TRAFFIC_PER_DAY=25_000,
                PASSING_POPULATION_TRAFFIC_PER_DAY=5_000)
SEED = 0


def leaf_digest(a: np.ndarray) -> dict:
    a = np.asarray(a)
    out = {"dtype": str(a.dtype), "shape": list(a.shape),
           "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    if np.issubdtype(a.dtype, np.floating):
        d = a.astype(np.float64)
        out.update(sum=float(d.sum()), abs_sum=float(np.abs(d).sum()),
                   max=float(d.max()) if d.size else 0.0)
    return out


def cfg_kwargs(cfg) -> dict:
    """The non-default constructor arguments of `cfg` (JSON-able)."""
    from trafficsimulation_tpu.config import Config
    base = Config()
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if v != getattr(base, f.name):
            out[f.name] = ([[k, int(n)] for k, n in v]
                           if f.name == "CAP_OVERRIDES" else v)
    return out


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax
    from trafficsimulation_tpu.utils import xla_cache_dir
    jax.config.update("jax_compilation_cache_dir", xla_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    from bench import inject_vehicles
    from make_torch_snapshot import world_to_leaves
    from trafficsimulation_tpu.config import Config
    from trafficsimulation_tpu.sim import init_world_hier, run_chunk

    t0 = time.perf_counter()
    cfg, world = init_world_hier(Config(**BASE_CFG),
                                 jax.random.PRNGKey(SEED))
    t_init = time.perf_counter() - t0
    world = jax.block_until_ready(inject_vehicles(cfg, world, N_VEHICLES))
    init = {k: leaf_digest(v) for k, v in world_to_leaves(world).items()}
    t1 = time.perf_counter()
    end = jax.jit(functools.partial(run_chunk, cfg, n=N_TICKS))(world)
    end = jax.block_until_ready(end)
    t_run = time.perf_counter() - t1
    leaves = world_to_leaves(end)
    digest = {
        "base_cfg": BASE_CFG, "seed": SEED, "n_vehicles": N_VEHICLES,
        "ticks": N_TICKS, "cfg": cfg_kwargs(cfg),
        "init": init,
        "end": {k: leaf_digest(v) for k, v in leaves.items()},
        "end_metrics": {k[8:]: float(v) for k, v in leaves.items()
                        if k.startswith("metrics.")},
        "active_vehicles": int(leaves["vehicles.active"].sum()),
    }
    with open(OUT, "w") as f:
        json.dump(digest, f, indent=0, sort_keys=True)
    print(json.dumps({"out": os.path.relpath(OUT, ROOT),
                      "bytes": os.path.getsize(OUT),
                      "dense_rows": int(cfg.MAX_FIELD_DESTS),
                      "active_vehicles": digest["active_vehicles"],
                      "init_s": round(t_init, 1),
                      "run_chunk_s": round(t_run, 1)}), flush=True)


if __name__ == "__main__":
    main()
