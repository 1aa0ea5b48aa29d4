"""Checkpoint / resume of the full simulation state (the JAX package's
`checkpoint.py`, orbax there).

`save` writes the config the way JAX's does (`config.json`: every field
that is not a tuple, list or dict) and every tensor of the world, the RL
controller's parameters and optimizer state among them, keyed by path
(`core.transfer.world_leaves`) with `torch.save` (`world.pt`).
`restore` brings the world back on the template's device (the card when
there is no template), so a run, a training RL controller included,
resumes bit for bit on the same device.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from .config import Config
from .core.transfer import (with_port_statics, world_from_leaves,
                             world_leaves)

WORLD_FILE = "world.pt"


def save(path: str, world, cfg: Config):
    """Persist world + config under `path` (created if needed)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({k: v for k, v in dataclasses.asdict(cfg).items()
                   if not isinstance(v, (tuple, list, dict))}, f, indent=1)
    torch.save(world_leaves(world), os.path.join(path, WORLD_FILE))


def restore(path: str, template=None, device=None):
    """Restore a world saved with :func:`save` on `device`, else on the
    device of `template` (a World, e.g. a freshly initialized one), else
    on the card.  Only files that `save` wrote are to be restored:
    `torch.load` runs with `weights_only=True`, which loads tensors and
    plain containers only."""
    if device is None:
        device = (template.grid.is_road.device if template is not None
                  else "cuda")
    leaves = torch.load(os.path.join(os.path.abspath(path), WORLD_FILE),
                        map_location=device, weights_only=True)
    return with_port_statics(world_from_leaves(leaves))
