#!/usr/bin/env python
"""Write the headline-world snapshot that seeds the PyTorch port.

The machine that runs the PyTorch port has no JAX, and world generation
is not ported yet, so the port starts from a snapshot of the JAX
package's BASELINE config #2 world (256x256, 10k vehicles, full dense
routing):

  * every leaf of the world after `init_world(PRNGKey(0))`,
    `measure_and_shrink` and `bench.inject_vehicles(cfg, world, 10_000)`,
    EXCEPT the [D, 4, H, W] key stack `cost_field` (637 MB), which the
    port rebuilds on its device (`trafficsimulation_tpu_torch.snapshot.
    build_field`);
  * the config overrides that rebuild the shrunk `Config` (JSON);
  * the sha256 of the JAX key stack's bytes and its per-row int64 sums,
    so that a rebuilt stack can be checked and a mismatch located;
  * JAX's own end state after `run_chunk(cfg, world, n=23)` (4 full
    routing segments plus a remainder of 3), under the prefix `ref.`.

Run from the repository root (about 7 minutes on 8 CPU cores):

    JAX_PLATFORMS=cpu python tools/make_torch_snapshot.py

It writes `trafficsimulation_tpu_torch/data/headline256_seed0.npz`.
`world_to_leaves` is also the JAX half of the leaf mapping that the
port's tests use (`trafficsimulation_tpu_torch.core.transfer`).
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data",
                   "headline256_seed0.npz")
N_TICKS = 23
N_VEHICLES = 10_000
BASE_CFG = dict(WIDTH=256, HEIGHT=256, MAX_VEHICLES=N_VEHICLES,
                MAX_FIELD_DESTS=640)

# dynamic leaves of the end state that the port must reproduce
REF_PREFIXES = ("vehicles.", "lights.", "metrics.", "rain.", "blocks.")
REF_NAMES = ("demand.cursor", "tick", "key", "elapsed", "veh_map",
             "stuck_map", "stop_map", "rain_map", "density")


def _key_name(k) -> str:
    """One step of a JAX tree path: a struct field, a dict key (the RL
    params and optimizer moments) or a tuple index (optax's state)."""
    for attr in ("name", "key", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(f"unknown tree path entry {k!r}")


def world_to_leaves(world) -> dict:
    """Flatten a JAX `World` (or any flax struct) into numpy arrays keyed
    by their attribute path ("grid.cell_type", "vehicles.active",
    "rl.params.params.Dense_0.kernel", "rl.opt_state.0.count", ...).
    `None` fields (rl, local_sdir4, dests.rid under dense routing) carry
    no leaves."""
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(world)
    return {".".join(_key_name(k) for k in path): np.asarray(leaf)
            for path, leaf in flat}


def cfg_overrides(cfg) -> dict:
    """The JSON-able constructor arguments that rebuild `cfg`."""
    out = dict(BASE_CFG)
    out["MAX_FIELD_DESTS"] = int(cfg.MAX_FIELD_DESTS)
    out["CAP_OVERRIDES"] = [[k, int(v)] for k, v in cfg.CAP_OVERRIDES]
    return out


def build_headline():
    """(cfg, world) exactly as `bench.bench_headline` builds them."""
    import jax
    from bench import inject_vehicles
    from trafficsimulation_tpu.config import Config
    from trafficsimulation_tpu.sim import init_world, measure_and_shrink

    cfg = Config(**BASE_CFG)
    world = jax.jit(functools.partial(init_world, cfg))(
        jax.random.PRNGKey(0))
    cfg, world = measure_and_shrink(cfg, world)
    world = inject_vehicles(cfg, world, N_VEHICLES)
    return cfg, jax.block_until_ready(world)


def main():
    sys.path.insert(0, ROOT)
    import jax
    from trafficsimulation_tpu.sim import run_chunk

    t0 = time.perf_counter()
    cfg, world = build_headline()
    t_init = time.perf_counter() - t0
    leaves = world_to_leaves(world)
    field = leaves.pop("cost_field")
    assert field.dtype == np.int32 and field.flags.c_contiguous
    out = {k: v for k, v in leaves.items()}
    out["meta.cfg_json"] = np.array(json.dumps(cfg_overrides(cfg)))
    out["meta.field_sha256"] = np.array(
        hashlib.sha256(field.tobytes()).hexdigest())
    out["meta.field_row_sums"] = field.reshape(field.shape[0], -1).astype(
        np.int64).sum(axis=1)
    out["meta.field_shape"] = np.array(field.shape, np.int64)
    out["meta.ref_ticks"] = np.array(N_TICKS, np.int64)
    del field

    t1 = time.perf_counter()
    end = jax.jit(functools.partial(run_chunk, cfg, n=N_TICKS))(world)
    end = jax.block_until_ready(end)
    t_run = time.perf_counter() - t1
    for k, v in world_to_leaves(end).items():
        if k.startswith(REF_PREFIXES) or k in REF_NAMES:
            out["ref." + k] = v

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    act = leaves["vehicles.active"].sum()
    print(json.dumps({
        "out": os.path.relpath(OUT, ROOT),
        "bytes": os.path.getsize(OUT),
        "D": int(cfg.MAX_FIELD_DESTS),
        "active_vehicles": int(act),
        "init_s": round(t_init, 1), "run_chunk_s": round(t_run, 1),
        "total_s": round(time.perf_counter() - t0, 1),
        "created": int(out["ref.metrics.created_internal"]
                       + out["ref.metrics.created_through"]),
        "completed": int(out["ref.metrics.completed_internal"]
                         + out["ref.metrics.completed_through"]),
    }), flush=True)


if __name__ == "__main__":
    main()
