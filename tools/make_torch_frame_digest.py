#!/usr/bin/env python
"""Write the digest of JAX's framebuffer of the headline end state.

The machine that runs the PyTorch port has no JAX.  The headline
snapshot (`trafficsimulation_tpu_torch/data/headline256_seed0.npz`,
written by `tools/make_torch_snapshot.py`) holds JAX's world and its end
state after `run_chunk(23)`; this script renders that end state with the
JAX package's `render_frame`, as `TrafficSim.render` calls it (jitted, no
pending-phase overlay, the config's portrayal level and dummy overlay),
and writes the frame's sha256, shape and per-channel sums.  The port's
`chip_smoke.py` renders its own 23-tick end state on the card and holds
it to this digest.

Run from the repository root (seconds on a CPU):

    JAX_PLATFORMS=cpu python tools/make_torch_frame_digest.py

It writes `trafficsimulation_tpu_torch/data/headline256_frame_digest.json`.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data",
                        "headline256_seed0.npz")
OUT = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data",
                   "headline256_frame_digest.json")


def frame_digest(frame: np.ndarray) -> dict:
    frame = np.ascontiguousarray(frame)
    return {"sha256": hashlib.sha256(frame.tobytes()).hexdigest(),
            "shape": list(frame.shape), "dtype": str(frame.dtype),
            "channel_sums": [int(s) for s in frame.reshape(-1, 3).astype(
                np.int64).sum(axis=0)]}


def main():
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    from trafficsimulation_tpu.config import Config
    from trafficsimulation_tpu.core.state import Vehicles
    from trafficsimulation_tpu.ops.render import render_frame

    with np.load(SNAPSHOT) as z:
        data = {k: z[k] for k in z.files}
    kw = json.loads(str(data["meta.cfg_json"]))
    kw["CAP_OVERRIDES"] = tuple(tuple(p) for p in kw["CAP_OVERRIDES"])
    cfg = Config(**kw)
    ticks = int(data["meta.ref_ticks"])
    end = {k[4:]: v for k, v in data.items() if k.startswith("ref.")}

    class Grid:          # the two fields render_frame reads
        cell_type = jnp.asarray(data["grid.cell_type"])
        intersection = jnp.asarray(data["grid.intersection"])
    vehicles = Vehicles(**{f: jnp.asarray(end["vehicles." + f])
                           for f in Vehicles.__dataclass_fields__})
    render = jax.jit(lambda stop, rain, vm, v: render_frame(
        Grid, stop, rain, vm, v, pending_mask=jnp.zeros_like(stop),
        level=cfg.AGENT_PORTRAYAL_LEVEL,
        dummy_overlay=cfg.USE_DUMMY_AGENTS))
    frame = np.asarray(render(jnp.asarray(end["stop_map"]),
                              jnp.asarray(end["rain_map"]),
                              jnp.asarray(end["veh_map"]), vehicles))
    out = {"ticks": ticks, "level": cfg.AGENT_PORTRAYAL_LEVEL,
           "dummy_overlay": cfg.USE_DUMMY_AGENTS, **frame_digest(frame),
           "rain_cells": int(end["rain_map"].sum()),
           "occupied_cells": int((end["veh_map"] >= 0).sum())}
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({"out": os.path.relpath(OUT, ROOT), **out}))


if __name__ == "__main__":
    main()
