#!/usr/bin/env python
"""Write the JAX reference digest of one world split over devices by rows.

The machine that runs the PyTorch port has no JAX.  This digest holds
what the JAX package's spatial path (`parallel/spatial.py`) computes on a
mesh of 8 CPU devices (`--xla_force_host_platform_device_count=8`, as
`tests/test_parallel.py::test_spatial_sharding_matches_unsharded` runs
it) for the dry run's configuration (`__graft_entry__.dryrun_cfg()`: the
32 x 32 synthetic crossroad, A2C training with an update every tick):
`spatial_chunk_fn(cfg, 4)(shard_world(w0, spatial_mesh(8)))`, 4 ticks
with every `[..., H, W]` plane split along H, 4 rows a device.

Before it writes anything it runs the same chunk unsharded
(`spatial_chunk_fn(cfg, 4)(w0)`) and requires every integer and bool
leaf to be equal; whether each float leaf is equal too is recorded
(`float_equal`).  The digest is one dict, leaf path -> dtype, shape and
sha256 (f32 leaves also their float64 sum, sum of magnitudes and
maximum), of the sharded end state.  The trained floats (`NEAR`: A2C's
parameters, Adam's moments and the value outputs), which the port's
products reach in other summation orders, are also written whole to
`spatial_trained.npz`, keyed by leaf path.

Run from the repository root, on the CPU (a few minutes, most of it the
two compiles):

    JAX_PLATFORMS=cpu python tools/make_torch_spatial_digest.py

It writes `trafficsimulation_tpu_torch/data/spatial_digest.json` and
`spatial_trained.npz`.
"""

from __future__ import annotations

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
                   "spatial_digest.json")
OUT_NPZ = os.path.join(os.path.dirname(OUT), "spatial_trained.npz")
NEAR = ("rl.params.", "rl.opt_state.0.mu.", "rl.opt_state.0.nu.",
        "rl.roll_v")
DEVICES = 8
TICKS = 4


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from trafficsimulation_tpu.utils import xla_cache_dir
    jax.config.update("jax_compilation_cache_dir", xla_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    import __graft_entry__ as ge
    from make_torch_hier_digest import leaf_digest
    from make_torch_snapshot import world_to_leaves
    from trafficsimulation_tpu.core.synth import crossroad_world
    from trafficsimulation_tpu.parallel.spatial import (
        shard_world, spatial_chunk_fn, spatial_mesh)

    cfg = ge.dryrun_cfg()
    w0 = crossroad_world(cfg)
    secs = {}
    t = time.perf_counter()
    whole = world_to_leaves(jax.block_until_ready(
        spatial_chunk_fn(cfg, TICKS)(w0)))
    secs["unsharded"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    mesh = spatial_mesh(DEVICES)
    ws = jax.block_until_ready(
        spatial_chunk_fn(cfg, TICKS)(shard_world(w0, mesh)))
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

    out = {"cfg_source": "__graft_entry__.dryrun_cfg()",
           "devices": DEVICES, "ticks": TICKS,
           "digest": {k: leaf_digest(v) for k, v in split.items()},
           "float_equal": float_equal}
    with open(OUT, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
    np.savez_compressed(OUT_NPZ, **{k: v for k, v in split.items()
                                    if k.startswith(NEAR)})
    print(json.dumps({"out": os.path.relpath(OUT, ROOT),
                      "bytes": os.path.getsize(OUT),
                      "npz_bytes": os.path.getsize(OUT_NPZ),
                      "floats_unequal": sorted(
                          k for k, v in float_equal.items() if not v),
                      "seconds": secs}), flush=True)


if __name__ == "__main__":
    main()
