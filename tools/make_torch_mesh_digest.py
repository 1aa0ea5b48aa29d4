#!/usr/bin/env python
"""Write the JAX reference digest of the sharded world batches.

The machine that runs the PyTorch port has no JAX.  This digest holds
what the JAX package computes on a mesh of 8 CPU devices
(`--xla_force_host_platform_device_count=8`, as `__graft_entry__.
dryrun_multichip` sets it; XLA's default optimisation level, as
`tests/test_parallel.py` runs the same step) for the dry run's
configuration (`__graft_entry__.dryrun_cfg()`: the 32 x 32 synthetic
crossroad, A2C training with an update every tick):

  * `dryrun`: the crossroad broadcast to 8 worlds with keys
    `split(PRNGKey(0), 8)`, laid out over the 8 devices along `worlds`,
    after 1 tick (`_dryrun_multichip_impl`) and after 2 ticks
    (`tests/test_parallel.py::test_sharded_world_batch`) of
    `jax.jit(jax.vmap(step_world))`; the all-reduced
    `created_internal + created_through` after the first tick, and
    whether world b's first parameter leaf moved;
  * `run_batch`: 4 worlds with keys `split(PRNGKey(0), 4)` on a 4-device
    mesh (`make_mesh(4)`) after 3 ticks of `jax.jit(run_batch)`, and
    `fleet_metrics` of them (`tests/test_parallel.py::test_mesh_helpers`).

Each entry is a list with one dict per world: leaf path -> dtype, shape
and sha256 (f32 leaves also carry their float64 sum, sum of magnitudes
and maximum).  The trained floats (`NEAR`: the A2C parameters, Adam's
moments and the value outputs), which the port's products reach in
other summation orders, are also written whole to `mesh_trained.npz`,
keyed `phase|world|leaf`.

Run from the repository root, on the CPU (a few minutes, most of it the
two compiles):

    JAX_PLATFORMS=cpu python tools/make_torch_mesh_digest.py

It writes `trafficsimulation_tpu_torch/data/mesh_digest.json` and
`mesh_trained.npz`.
"""

from __future__ import annotations

import functools
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
OUT = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data",
                   "mesh_digest.json")
OUT_NPZ = os.path.join(os.path.dirname(OUT), "mesh_trained.npz")
NEAR = ("rl.params.", "rl.opt_state.0.mu.", "rl.opt_state.0.nu.",
        "rl.roll_v")
DRYRUN_WORLDS = 8
DRYRUN_TICKS = 2
RUN_BATCH_WORLDS = 4
RUN_BATCH_TICKS = 3


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    jax.config.update("jax_platforms", "cpu")
    from trafficsimulation_tpu.utils import xla_cache_dir
    jax.config.update("jax_compilation_cache_dir", xla_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    import __graft_entry__ as ge
    from make_torch_hier_digest import leaf_digest
    from make_torch_snapshot import world_to_leaves
    from trafficsimulation_tpu.core.synth import crossroad_world
    from trafficsimulation_tpu.parallel.mesh import (
        fleet_metrics, make_mesh, run_batch)
    from trafficsimulation_tpu.sim import step_world

    cfg = ge.dryrun_cfg()
    w0 = crossroad_world(cfg)
    arrays = {}

    def shard(n, mesh):
        batch = jax.tree.map(
            lambda a: jnp.broadcast_to(a[None], (n,) + a.shape), w0)
        batch = batch.replace(key=jax.random.split(jax.random.PRNGKey(0), n))
        return jax.device_put(batch, NamedSharding(mesh, P("worlds")))

    def per_world(phase, batch, n):
        leaves = world_to_leaves(batch)
        for k, v in leaves.items():
            if k.startswith(NEAR):
                for b in range(n):
                    arrays[f"{phase}|{b}|{k}"] = np.asarray(v[b])
        return [{k: leaf_digest(v[b]) for k, v in leaves.items()}
                for b in range(n)]

    out = {"cfg_source": "__graft_entry__.dryrun_cfg()",
           "dryrun_worlds": DRYRUN_WORLDS, "run_batch_worlds":
           RUN_BATCH_WORLDS, "run_batch_ticks": RUN_BATCH_TICKS}
    secs = {}
    t = time.perf_counter()
    mesh8 = Mesh(np.asarray(jax.devices()[:DRYRUN_WORLDS]), ("worlds",))
    step = jax.jit(jax.vmap(functools.partial(step_world, cfg)))
    batch = shard(DRYRUN_WORLDS, mesh8)
    p0 = np.asarray(jax.tree_util.tree_leaves(w0.rl.params)[0])
    for tick in range(1, DRYRUN_TICKS + 1):
        batch = jax.block_until_ready(step(batch))
        if len(batch.veh_map.sharding.device_set) != DRYRUN_WORLDS:
            raise AssertionError("the batch is not laid out over the mesh")
        out[f"dryrun_tick{tick}"] = per_world(f"dryrun_tick{tick}", batch,
                                              DRYRUN_WORLDS)
        if tick == 1:
            total = jax.jit(lambda ws: jnp.sum(
                ws.metrics.created_internal
                + ws.metrics.created_through))(batch)
            out["dryrun_total"] = int(total)
            p1 = np.asarray(jax.tree_util.tree_leaves(batch.rl.params)[0])
            out["dryrun_moved"] = [bool(not np.allclose(p0, p1[b]))
                                   for b in range(DRYRUN_WORLDS)]
    secs["dryrun"] = round(time.perf_counter() - t, 1)

    t = time.perf_counter()
    mesh4 = make_mesh(RUN_BATCH_WORLDS)
    worlds = jax.block_until_ready(jax.jit(functools.partial(
        run_batch, cfg, n_ticks=RUN_BATCH_TICKS))(
            shard(RUN_BATCH_WORLDS, mesh4)))
    out[f"run_batch{RUN_BATCH_TICKS}"] = per_world(
        f"run_batch{RUN_BATCH_TICKS}", worlds, RUN_BATCH_WORLDS)
    out["fleet_metrics"] = {k: int(v) for k, v in
                            fleet_metrics(worlds).items()}
    secs["run_batch"] = round(time.perf_counter() - t, 1)

    with open(OUT, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
    np.savez_compressed(OUT_NPZ, **arrays)
    print(json.dumps({"out": os.path.relpath(OUT, ROOT),
                      "bytes": os.path.getsize(OUT),
                      "npz_bytes": os.path.getsize(OUT_NPZ),
                      "total": out["dryrun_total"],
                      "moved": out["dryrun_moved"],
                      "fleet": out["fleet_metrics"], "seconds": secs}),
          flush=True)


if __name__ == "__main__":
    main()
