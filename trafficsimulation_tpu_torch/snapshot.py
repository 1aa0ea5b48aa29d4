"""A snapshot of a JAX world, the port's reference for the headline.

The headline world (BASELINE config #2: 256x256, 10k vehicles, D = 608
field rows; `HEADLINE_CFG`, seed 0, `HEADLINE_VEHICLES` injected) ships
as `data/headline256_seed0.npz`, written by `tools/make_torch_snapshot.py`
with the JAX package.  It holds every leaf of the world except the
637 MB key stack `cost_field` (which `build_field` rebuilds on the
device with the port's own value iteration), JAX's key-stack sha256,
and its end state after a short `run_chunk` (keys `ref.*`).  The port
generates the same world itself (`sim.init_world`); the snapshot is what
that world and its run are held to.

npz layout: world leaves keyed by attribute path ("grid.cell_type");
`meta.cfg_json` the `Config` keyword arguments; `meta.field_sha256`,
`meta.field_row_sums`, `meta.field_shape`, `meta.ref_ticks`; `ref.<path>`
the reference end state.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from .config import Config

from .core.state import World
from .core.transfer import world_from_numpy
from .ops import routing
from .ops.engine import field_to_keys

HEADLINE = Path(__file__).resolve().parent / "data" / "headline256_seed0.npz"
HEADLINE_CFG = dict(WIDTH=256, HEIGHT=256, MAX_VEHICLES=10_000,
                    MAX_FIELD_DESTS=640)
HEADLINE_SEED = 0
HEADLINE_VEHICLES = 10_000
# JAX's config #5 world cut to 512^2 (tools/make_torch_hier_digest.py)
HIER_DIGEST = Path(__file__).resolve().parent / "data" / \
    "config5_hier512_digest.json"


def config_from_json(text: str) -> Config:
    kw = json.loads(text)
    if "CAP_OVERRIDES" in kw:
        kw["CAP_OVERRIDES"] = tuple(tuple(p) for p in kw["CAP_OVERRIDES"])
    return Config(**kw)


def load_snapshot(path=HEADLINE, device="cuda"):
    """(cfg, world without cost_field, reference) from a snapshot file,
    the world on `device` (the card unless the caller asks otherwise).
    `reference`: {"field_sha256", "field_row_sums", "field_shape",
    "ticks", "end": {leaf path: numpy array}} (entries absent from the
    file are missing)."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    cfg = config_from_json(str(data.pop("meta.cfg_json")))
    ref = {"end": {}}
    for k in list(data):
        if k.startswith("ref."):
            ref["end"][k[4:]] = data.pop(k)
        elif k.startswith("meta."):
            v = data.pop(k)
            name = k[5:]
            if name == "field_sha256":
                ref[name] = str(v)
            elif name == "field_shape":
                ref[name] = tuple(int(x) for x in v)
            elif name == "ref_ticks":
                ref["ticks"] = int(v)
            else:
                ref[name] = v
    return cfg, world_from_numpy(data, device), ref


def build_field(cfg: Config, world: World) -> World:
    """Fill `cost_field` on the world's device: value iteration
    (`routing.compute_cost_fields`) over the first D destinations, then
    the key encoding (`engine.field_to_keys`)."""
    g, d = world.grid, world.dests
    D = d.valid.shape[0]
    DF = min(D, cfg.MAX_FIELD_DESTS or D)
    F = routing.compute_cost_fields(cfg, g.allowed_dirs, g.road_class,
                                    d.pos[:DF], d.valid[:DF],
                                    is_road=g.is_road)
    K = field_to_keys(cfg, F, g.road_class)
    del F
    return world.replace(cost_field=K)


def field_sha256(K: torch.Tensor) -> str:
    return hashlib.sha256(K.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def field_row_sums(K: torch.Tensor) -> np.ndarray:
    return K.reshape(K.shape[0], -1).to(torch.int64).sum(dim=1).cpu().numpy()
