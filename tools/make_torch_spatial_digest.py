#!/usr/bin/env python
"""Write the JAX reference digests of one world split over devices by rows.

The machine that runs the PyTorch port has no JAX.  These digests hold
what the JAX package's spatial path (`parallel/spatial.py`) computes on a
mesh of 8 CPU devices (`--xla_force_host_platform_device_count=8`, as
`tests/test_parallel.py::test_spatial_sharding_matches_unsharded` runs
it): `spatial_chunk_fn(cfg, n)(shard_world(w0, spatial_mesh(8)))`, n
ticks with every `[..., H, W]` plane split along H, H / 8 rows a device.
One case a file (`--cases`, all by default):

  * `crossroad`: the dry run's configuration (`__graft_entry__.
    dryrun_cfg()`: the 32 x 32 synthetic crossroad, A2C training with an
    update every tick), 4 ticks -> `spatial_digest.json` and
    `spatial_trained.npz`;
  * `hier`: a 64^2 city under hierarchical routing (`HIER_TILE` 16,
    `HIER_LMAX` 8, as `tests/test_torch_hier.py`: `init_world_hier` from
    key 0, then `bench.inject_vehicles` of 200), 20 ticks ->
    `spatial_hier_digest.json`;
  * `peds`: a 64^2 city with pedestrians (config #4's geometry with
    `PEDESTRIANS_ENABLED` and 2,000,000 pedestrians a day, so that
    walkers cross the 8-row slab edges: `init_world` from key 1, then
    160 vehicles injected), 20 ticks -> `spatial_peds_digest.json`.

Before it writes a case it runs the same chunk unsharded
(`spatial_chunk_fn(cfg, n)(w0)`) and requires every integer and bool
leaf to be equal; whether each float leaf is equal too is recorded
(`float_equal`).  A digest is one dict, leaf path -> dtype, shape and
sha256 (f32 leaves also their float64 sum, sum of magnitudes and
maximum), of the sharded end state (`digest`) and of the start state
(`init`, for the hierarchical and pedestrian cities).  The crossroad's
trained floats (`NEAR`: A2C's parameters, Adam's moments and the value
outputs), which the port's products reach in other summation orders,
are also written whole to `spatial_trained.npz`, keyed by leaf path.

Run from the repository root, on the CPU (a few minutes a case, most of
it the two compiles):

    JAX_PLATFORMS=cpu python tools/make_torch_spatial_digest.py \
        [--cases crossroad,hier,peds]

It writes the files under `trafficsimulation_tpu_torch/data/`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
          if "host_platform_device_count" not in f]
os.environ["XLA_FLAGS"] = " ".join(
    _flags + ["--xla_force_host_platform_device_count=8"])

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data")
OUT = os.path.join(DATA, "spatial_digest.json")
OUT_NPZ = os.path.join(DATA, "spatial_trained.npz")
NEAR = ("rl.params.", "rl.opt_state.0.mu.", "rl.opt_state.0.nu.",
        "rl.roll_v")
DEVICES = 8
TICKS = 4
# the cities of the `hier` and `peds` cases (tests/test_torch_spatial_hier
# .py and test_torch_spatial_peds.py build the same)
HIER_KW = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
               MAX_VEHICLES=256, ROUTING_HIER=True, HIER_TILE=16,
               HIER_LMAX=8, INTERNAL_POPULATION_TRAFFIC_PER_DAY=2000,
               PASSING_POPULATION_TRAFFIC_PER_DAY=500)
HIER_KEY, HIER_VEHICLES, HIER_TICKS = 0, 200, 20
PEDS_KW = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
               MAX_FIELD_DESTS=32, MAX_VEHICLES=256,
               INTERNAL_POPULATION_TRAFFIC_PER_DAY=2000,
               PASSING_POPULATION_TRAFFIC_PER_DAY=500,
               PEDESTRIANS_ENABLED=True, PEDESTRIANS_PER_DAY=2_000_000)
PEDS_KEY, PEDS_VEHICLES, PEDS_TICKS = 1, 160, 20


def split_run(cfg, w0, ticks):
    """(end state's leaves, float_equal, seconds): the sharded chunk,
    required equal to the unsharded one on every integer leaf."""
    import jax
    from make_torch_snapshot import world_to_leaves
    from trafficsimulation_tpu.parallel.spatial import (
        shard_world, spatial_chunk_fn, spatial_mesh)
    secs = {}
    t = time.perf_counter()
    whole = world_to_leaves(jax.block_until_ready(
        spatial_chunk_fn(cfg, ticks)(w0)))
    secs["unsharded"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    mesh = spatial_mesh(DEVICES)
    ws = jax.block_until_ready(
        spatial_chunk_fn(cfg, ticks)(shard_world(w0, mesh)))
    secs["sharded"] = round(time.perf_counter() - t, 1)
    if len(ws.veh_map.sharding.device_set) != DEVICES:
        raise AssertionError("the world is not laid out over the mesh")
    split = world_to_leaves(ws)

    if set(split) != set(whole):
        raise AssertionError(sorted(set(split) ^ set(whole)))
    float_equal = {}
    for k, a in split.items():
        b = whole[k]
        same = a.shape == b.shape and a.tobytes() == b.tobytes()
        if np.issubdtype(a.dtype, np.floating):
            float_equal[k] = same
        elif not same:
            raise AssertionError(f"{k}: the split run differs from the "
                                 "unsharded one")
    return split, float_equal, secs


def write(path, out):
    with open(path, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)


def case_crossroad():
    import __graft_entry__ as ge
    from make_torch_hier_digest import leaf_digest
    from trafficsimulation_tpu.core.synth import crossroad_world
    cfg = ge.dryrun_cfg()
    split, float_equal, secs = split_run(cfg, crossroad_world(cfg), TICKS)
    write(OUT, {"cfg_source": "__graft_entry__.dryrun_cfg()",
                "devices": DEVICES, "ticks": TICKS,
                "digest": {k: leaf_digest(v) for k, v in split.items()},
                "float_equal": float_equal})
    np.savez_compressed(OUT_NPZ, **{k: v for k, v in split.items()
                                    if k.startswith(NEAR)})
    return OUT, float_equal, secs


def case_city(name, kw, key, vehicles, ticks):
    import jax
    from bench import inject_vehicles
    from make_torch_hier_digest import leaf_digest
    from make_torch_snapshot import world_to_leaves
    from trafficsimulation_tpu import sim
    from trafficsimulation_tpu.config import Config
    cfg = Config(**kw)
    if cfg.ROUTING_HIER:
        cfg, w0 = sim.init_world_hier(cfg, jax.random.PRNGKey(key))
    else:
        w0 = jax.jit(lambda k: sim.init_world(cfg, k))(
            jax.random.PRNGKey(key))
    w0 = inject_vehicles(cfg, w0, vehicles)
    init = {k: leaf_digest(v) for k, v in world_to_leaves(w0).items()}
    split, float_equal, secs = split_run(cfg, w0, ticks)
    path = os.path.join(DATA, f"spatial_{name}_digest.json")
    write(path, {"cfg": kw, "key": key, "vehicles": vehicles,
                 "devices": DEVICES, "ticks": ticks, "init": init,
                 "digest": {k: leaf_digest(v) for k, v in split.items()},
                 "float_equal": float_equal})
    return path, float_equal, secs


CASES = {
    "crossroad": case_crossroad,
    "hier": lambda: case_city("hier", HIER_KW, HIER_KEY, HIER_VEHICLES,
                              HIER_TICKS),
    "peds": lambda: case_city("peds", PEDS_KW, PEDS_KEY, PEDS_VEHICLES,
                              PEDS_TICKS)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated cases (default: all)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from trafficsimulation_tpu.utils import xla_cache_dir
    jax.config.update("jax_compilation_cache_dir", xla_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    for name in args.cases.split(","):
        path, float_equal, secs = CASES[name]()
        print(json.dumps({"case": name, "out": os.path.relpath(path, ROOT),
                          "bytes": os.path.getsize(path),
                          "floats_unequal": sorted(
                              k for k, v in float_equal.items() if not v),
                          "seconds": secs}), flush=True)


if __name__ == "__main__":
    main()
