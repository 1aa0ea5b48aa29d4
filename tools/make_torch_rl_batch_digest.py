#!/usr/bin/env python
"""Write the JAX reference digest of the RL light controllers in world
batches.

The machine that runs the PyTorch port has no JAX.  For each RL family
(NEIGHBOR_RL_BATCHED: REINFORCE; RL_A2C_BATCHED, also with
A2C_INTERLEAVED_GAE; GAT_DQN_BATCHED), with narrow nets (2 x 32) and the
update cadences cut so that every world trains at least 3 times in
`TICKS` ticks, this digest holds, as the JAX package computes them:

  * `shared`: the synthetic crossroad (`core.synth.crossroad_world`,
    32 x 32, key PRNGKey(0)) as a shared-geometry batch of B = 4
    (`parallel.mesh.tile_dynamic` with keys `split(PRNGKey(0), 4)`: the
    train state broadcast to every world) after `TICKS` ticks of
    `jax.jit(run_batch_shared)` (`run_chunk` under `jax.vmap`);
  * `per_world`: B = 3 generated 64 x 64 cities (config #4's generator
    settings, VEHICLE_MAX_SPEED = 2, worlds 0-2 of
    `init_world_batch(cfg, PRNGKey(0), 3)`: each world's train state
    from its own key) at init, after `TICKS` ticks of
    `jax.jit(jax.vmap(run_chunk))`, and after `RUN_BATCH_TICKS` ticks of
    `parallel.mesh.run_batch` (`step_world` under vmap).  The cities
    have different numbers of light groups, so REINFORCE's and
    GAT-DQN's worlds train on different ticks.

Each entry is a list with one dict per world: leaf path -> dtype, shape
and sha256 (f32 leaves also carry their float64 sum, sum of magnitudes
and maximum), the key stack (`cost_field`) left out (`init` of the
shared batch: world 0 only, the others differ from it only in their
key); `counts` holds each world's Adam count at the end.  The trained
floats (`NEAR`: parameters, target parameters, Adam's moments, A2C's
value outputs), which the port's batched products reach in other
summation orders, are also written whole to `rl_batch_trained.npz`,
keyed `kind|name|phase|world|leaf`, for an element-by-element check;
for `per_world` also those of JAX's own single-world runs of each world
(`jax.jit(run_chunk)` unbatched, phases `single12` and `single4`): how
far JAX's batched and single-world compiles of the same run lie apart,
the spread that the port's batch is allowed beside the tolerance.

Run from the repository root, on the CPU (14 min on 8 cores from an
empty XLA cache before the single-world runs were added, most of it
compiles; the three per-world cases with them took 8 min with the
batched runs' compiles cached; `--cases` reruns some cases into the
existing files):

    JAX_PLATFORMS=cpu python tools/make_torch_rl_batch_digest.py

It writes `trafficsimulation_tpu_torch/data/rl_batch_digest.json` and
`rl_batch_trained.npz`.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data",
                   "rl_batch_digest.json")
OUT_NPZ = os.path.join(os.path.dirname(OUT), "rl_batch_trained.npz")
NEAR = ("rl.params.", "rl.target_params.", "rl.opt_state.0.mu.",
        "rl.opt_state.0.nu.", "rl.roll_v")
TICKS = 12
RUN_BATCH_TICKS = 4
SHARED_B = 4
PER_WORLD_B = 3
CROSSROAD = dict(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64,
                 VEHICLE_MAX_SPEED=2)
CITY = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
            MAX_FIELD_DESTS=32, MAX_VEHICLES=256,
            INTERNAL_POPULATION_TRAFFIC_PER_DAY=2000,
            PASSING_POPULATION_TRAFFIC_PER_DAY=500, VEHICLE_MAX_SPEED=2)
NARROW = dict(SRL_HIDDEN_LAYERS=2, SRL_HIDDEN_LAYER_SIZE=32,
              SRL_BATCH_SIZE=8, A2C_HIDDEN_LAYERS=2,
              A2C_HIDDEN_LAYER_SIZE=32, A2C_UPDATE_EVERY=4,
              GAT_MEMORY_CAPACITY=512, EPS_INITIAL=0.5)
# the crossroad has one light group, the cities 10-16
CASES = {
    "shared": {
        "NEIGHBOR_RL_BATCHED": dict(SRL_UPDATE_EVERY=3),
        "RL_A2C_BATCHED": {},
        "RL_A2C_BATCHED+interleaved": dict(A2C_INTERLEAVED_GAE=True),
        "GAT_DQN_BATCHED": dict(GAT_BATCH_SIZE=4),
    },
    "per_world": {
        "NEIGHBOR_RL_BATCHED": dict(SRL_UPDATE_EVERY=24),
        "RL_A2C_BATCHED": {},
        "GAT_DQN_BATCHED": dict(GAT_BATCH_SIZE=16),
    },
}


def case_kwargs(kind: str, name: str) -> dict:
    """The Config arguments of a case (the family is the name up to
    '+')."""
    base = CROSSROAD if kind == "shared" else CITY
    return dict(base, **NARROW, **CASES[kind][name],
                TRAFFIC_LIGHT_AGENT_ALGORITHM=name.split("+")[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="",
                    help="comma-separated kind/name to rerun, merged into "
                    "the existing file (default: all)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax
    from trafficsimulation_tpu.utils import xla_cache_dir
    jax.config.update("jax_compilation_cache_dir", xla_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    from make_torch_hier_digest import leaf_digest
    from make_torch_snapshot import world_to_leaves
    from trafficsimulation_tpu.config import Config
    from trafficsimulation_tpu.core.synth import crossroad_world
    from trafficsimulation_tpu.parallel.mesh import (
        SHARED_GEOMETRY_FIELDS, init_world_batch, run_batch,
        run_batch_shared, tile_dynamic)
    from trafficsimulation_tpu.sim import run_chunk

    def batched(path: str) -> bool:
        top, _, rest = path.partition(".")
        if top in SHARED_GEOMETRY_FIELDS:
            return False
        return rest == "cursor" if top == "demand" else True

    def per_world(batch, n, shared: bool) -> list:
        leaves = {k: v for k, v in world_to_leaves(batch).items()
                  if k != "cost_field"}
        return [{k: leaf_digest(v[b] if not shared or batched(k) else v)
                 for k, v in leaves.items()} for b in range(n)]

    def trained(key: str, batch, n, shared: bool):
        """The NEAR leaves of each world, whole, into `arrays`."""
        for k, v in world_to_leaves(batch).items():
            if k.startswith(NEAR):
                for b in range(n):
                    arrays[f"{key}|{b}|{k}"] = np.asarray(
                        v[b] if not shared or batched(k) else v)

    def counts(batch) -> list:
        return [int(c) for c in np.asarray(batch.rl.opt_state[0].count)]

    todo = [c.split("/") for c in args.cases.split(",") if c] or [
        (kind, name) for kind in CASES for name in CASES[kind]]
    out = {"ticks": TICKS, "run_batch_ticks": RUN_BATCH_TICKS,
           "shared_b": SHARED_B, "per_world_b": PER_WORLD_B,
           "shared": {}, "per_world": {}}
    arrays = {}
    if args.cases and os.path.exists(OUT):
        with open(OUT) as f:
            out = json.load(f)
        with np.load(OUT_NPZ) as z:
            arrays = {k: z[k] for k in z.files}
    secs = {}
    for kind, name in todo:
        t = time.perf_counter()
        kw = case_kwargs(kind, name)
        cfg = Config(**kw)
        rec = {"cfg": kw}
        if kind == "shared":
            world = crossroad_world(cfg, key=jax.random.PRNGKey(0))
            keys = jax.random.split(jax.random.PRNGKey(0), SHARED_B)
            batch = tile_dynamic(world, keys)
            rec["init"] = per_world(batch, 1, True)
            end = jax.block_until_ready(jax.jit(functools.partial(
                run_batch_shared, cfg, n_ticks=TICKS))(batch))
            rec[f"tick{TICKS}"] = per_world(end, SHARED_B, True)
            trained(f"{kind}|{name}|tick{TICKS}", end, SHARED_B, True)
            rec["counts"] = counts(end)
        else:
            worlds = jax.block_until_ready(init_world_batch(
                cfg, jax.random.PRNGKey(0), PER_WORLD_B, None))
            rec["init"] = per_world(worlds, PER_WORLD_B, False)
            end = jax.block_until_ready(jax.jit(jax.vmap(functools.partial(
                run_chunk, cfg, n=TICKS)))(worlds))
            rec[f"tick{TICKS}"] = per_world(end, PER_WORLD_B, False)
            trained(f"{kind}|{name}|tick{TICKS}", end, PER_WORLD_B, False)
            rec["counts"] = counts(end)
            rb = jax.block_until_ready(jax.jit(functools.partial(
                run_batch, cfg, n_ticks=RUN_BATCH_TICKS))(worlds))
            rec[f"run_batch{RUN_BATCH_TICKS}"] = per_world(
                rb, PER_WORLD_B, False)
            for ticks in (TICKS, RUN_BATCH_TICKS):
                one = jax.jit(functools.partial(run_chunk, cfg, n=ticks))
                for b in range(PER_WORLD_B):
                    end_b = jax.block_until_ready(one(jax.tree_util.tree_map(
                        lambda x: x[b], worlds)))
                    for k, v in world_to_leaves(end_b).items():
                        if k.startswith(NEAR):
                            arrays[f"{kind}|{name}|single{ticks}|{b}|{k}"] = \
                                np.asarray(v)
            trained(f"{kind}|{name}|run_batch{RUN_BATCH_TICKS}", rb,
                    PER_WORLD_B, False)
            rec["run_batch_counts"] = counts(rb)
        out[kind][name] = rec
        secs[f"{kind}/{name}"] = round(time.perf_counter() - t, 1)
        print(kind, name, rec["counts"], secs[f"{kind}/{name}"], flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
    np.savez_compressed(OUT_NPZ, **arrays)
    print(json.dumps({"out": os.path.relpath(OUT, ROOT),
                      "bytes": os.path.getsize(OUT),
                      "npz_bytes": os.path.getsize(OUT_NPZ),
                      "seconds": secs}),
          flush=True)


if __name__ == "__main__":
    main()
