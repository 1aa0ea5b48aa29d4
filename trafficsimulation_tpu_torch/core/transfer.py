"""Carry a world across frameworks as numpy leaves keyed by path.

The JAX package's world is a flax pytree; flattened with its attribute
paths ("grid.cell_type", "vehicles.active", ...) it becomes a dict of
numpy arrays.  `world_from_numpy` builds the port's `World` from such a
dict on a device, and `world_to_numpy` gives the same dict back.  The
JAX half of the mapping (`jax.tree_util` then `np.asarray`) lives in the
tests and in `tools/make_torch_snapshot.py`, never in this package.

uint32 leaves (the PRNG key) travel as `.view(np.int32)` and come back
as `.view(np.uint32)`.  Fields absent from the dict (`rl`,
`local_sdir4`, `dests.rid`, or `cost_field` in a snapshot) stay None.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .state import NESTED, World

# leaves whose JAX dtype is uint32 (carried as int32 bits in torch)
U32_LEAVES = frozenset({"key"})


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")          # keeps 0-d leaves 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _build(cls, leaves: dict, prefix: str, device):
    kw = {}
    nested = NESTED.get(cls, {})
    for f in dataclasses.fields(cls):
        name = prefix + f.name
        if f.name in nested:
            kw[f.name] = _build(nested[f.name], leaves, name + ".", device)
        elif name in leaves:
            kw[f.name] = _to_tensor(leaves[name], device)
        else:
            kw[f.name] = None
    return cls(**kw)


def world_from_numpy(leaves: dict, device) -> World:
    """The port's `World` on `device` from JAX leaves keyed by path."""
    return _build(World, leaves, "", device)


def _flatten(obj, prefix: str, out: dict):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        name = prefix + f.name
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            _flatten(v, name + ".", out)
        else:
            a = v.detach().cpu().numpy()
            out[name] = a.view(np.uint32) if name in U32_LEAVES else a
    return out


def world_to_numpy(world: World) -> dict:
    """Numpy leaves keyed by path, in the JAX package's dtypes."""
    return _flatten(world, "", {})
