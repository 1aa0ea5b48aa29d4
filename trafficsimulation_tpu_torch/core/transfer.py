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

`world_leaves` / `world_from_leaves` are the same mapping with the
tensors kept as they are: the form in which `torch.func.vmap` carries a
batch of worlds (`parallel/mesh.py`).
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


def _build(cls, leaves: dict, prefix: str, conv):
    kw = {}
    nested = NESTED.get(cls, {})
    for f in dataclasses.fields(cls):
        name = prefix + f.name
        if f.name in nested:
            kw[f.name] = _build(nested[f.name], leaves, name + ".", conv)
        elif name in leaves:
            kw[f.name] = conv(leaves[name])
        else:
            kw[f.name] = None
    return cls(**kw)


def world_from_numpy(leaves: dict, device) -> World:
    """The port's `World` on `device` from JAX leaves keyed by path."""
    return _build(World, leaves, "", lambda a: _to_tensor(a, device))


def world_from_leaves(leaves: dict) -> World:
    """The `World` whose tensors are `leaves` (keyed by path)."""
    return _build(World, leaves, "", lambda t: t)


def _flatten(obj, prefix: str, out: dict, conv):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        name = prefix + f.name
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            _flatten(v, name + ".", out, conv)
        else:
            out[name] = conv(name, v)
    return out


def _numpy_leaf(name, t):
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in U32_LEAVES else a


def world_to_numpy(world: World) -> dict:
    """Numpy leaves keyed by path, in the JAX package's dtypes."""
    return _flatten(world, "", {}, _numpy_leaf)


def world_leaves(world: World) -> dict:
    """The world's tensors keyed by path (None fields left out)."""
    return _flatten(world, "", {}, lambda name, t: t)
