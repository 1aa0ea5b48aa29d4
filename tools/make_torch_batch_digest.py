#!/usr/bin/env python
"""Write the JAX reference digest of the per-world-geometry world batch.

The machine that runs the PyTorch port has no JAX.  This digest holds
BASELINE config #4 (`bench.py` `bench_config4`: 64x64 worlds, each from
its own key of `jax.random.split(PRNGKey(0), 1024)`), for its first
worlds, as the JAX package computes them:

  * `init`: worlds 0-3 through `jax.jit(jax.vmap(partial(init_world,
    cfg)))`, as `parallel.mesh.init_world_batch` and the bench build them;
  * `chunk10`, `chunk50`: the same four worlds after 10 and after 50
    ticks of `jax.vmap(partial(run_chunk, cfg, n=...))` from init, the
    bench's stepping (its first 50-tick chunk);
  * `run_batch3`: worlds 0-1 after 3 ticks of `parallel.mesh.run_batch`
    (`step_world` under vmap, routing rebuilt every tick);
  * `plain_init0`: world 0 through a plain `jax.jit(init_world)`, to
    show whether vmap changed any float fold of the generator.

Each entry is a list with one dict per world: leaf path -> dtype, shape
and sha256 (f32 leaves also carry their float64 sum, sum of magnitudes
and maximum, so that a mismatch can be sized).

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python tools/make_torch_batch_digest.py

It writes `trafficsimulation_tpu_torch/data/config4_batch_digest.json`.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data",
                   "config4_batch_digest.json")
CFG = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
           MAX_FIELD_DESTS=32, MAX_VEHICLES=256,
           INTERNAL_POPULATION_TRAFFIC_PER_DAY=2000,
           PASSING_POPULATION_TRAFFIC_PER_DAY=500)
N_SPLIT = 1024            # the bench's key split
N_WORLDS = 4              # worlds 0..3 of it
N_RUN_BATCH = 2           # worlds 0..1 through run_batch
TICKS = (10, 50)
RUN_BATCH_TICKS = 3


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax
    from trafficsimulation_tpu.utils import xla_cache_dir
    jax.config.update("jax_compilation_cache_dir", xla_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    from make_torch_hier_digest import leaf_digest
    from make_torch_snapshot import world_to_leaves
    from trafficsimulation_tpu.config import Config
    from trafficsimulation_tpu.parallel.mesh import run_batch
    from trafficsimulation_tpu.sim import init_world, run_chunk

    cfg = Config(**CFG)
    keys = jax.random.split(jax.random.PRNGKey(0), N_SPLIT)[:N_WORLDS]

    def per_world(batch, n):
        leaves = world_to_leaves(batch)
        return [{k: leaf_digest(v[b]) for k, v in leaves.items()}
                for b in range(n)]

    secs = {}
    t = time.perf_counter()
    worlds = jax.block_until_ready(
        jax.jit(jax.vmap(functools.partial(init_world, cfg)))(keys))
    secs["init"] = time.perf_counter() - t
    digest = {"cfg": CFG, "n_split": N_SPLIT, "worlds": N_WORLDS,
              "init": per_world(worlds, N_WORLDS)}
    for n in TICKS:
        t = time.perf_counter()
        out = jax.block_until_ready(jax.jit(jax.vmap(
            functools.partial(run_chunk, cfg, n=n)))(worlds))
        secs[f"chunk{n}"] = time.perf_counter() - t
        digest[f"chunk{n}"] = per_world(out, N_WORLDS)
        digest[f"chunk{n}_active"] = [
            int(a) for a in np.asarray(out.vehicles.active).sum(-1)]
    t = time.perf_counter()
    pair = jax.tree.map(lambda a: a[:N_RUN_BATCH], worlds)
    out = jax.block_until_ready(run_batch(cfg, pair, RUN_BATCH_TICKS))
    secs["run_batch"] = time.perf_counter() - t
    digest["run_batch3"] = per_world(out, N_RUN_BATCH)
    t = time.perf_counter()
    w0 = jax.block_until_ready(
        jax.jit(functools.partial(init_world, cfg))(keys[0]))
    secs["plain_init"] = time.perf_counter() - t
    plain = {k: leaf_digest(v) for k, v in world_to_leaves(w0).items()}
    digest["plain_init0"] = [plain]
    digest["plain_vs_vmap_init0_differ"] = sorted(
        k for k in plain if plain[k]["sha256"]
        != digest["init"][0][k]["sha256"])
    with open(OUT, "w") as f:
        json.dump(digest, f, indent=0, sort_keys=True)
    print(json.dumps({"out": os.path.relpath(OUT, ROOT),
                      "bytes": os.path.getsize(OUT),
                      "plain_vs_vmap_differ":
                          digest["plain_vs_vmap_init0_differ"],
                      "active": {n: digest[f"chunk{n}_active"]
                                 for n in TICKS},
                      "seconds": {k: round(v, 1) for k, v in secs.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
