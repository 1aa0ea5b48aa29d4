# Frozen copy of trafficsimulation_tpu_torch/core/transfer.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
"""Carry a world as leaves keyed by path ("grid.cell_type",
"vehicles.active", ...): `world_leaves` / `world_from_leaves` with the
tensors as they are, `world_to_numpy` / `world_from_numpy` as numpy
arrays in the JAX package's paths and dtypes (the JAX world flattened by
its attribute paths is the same dict).

uint32 leaves (the PRNG key) travel as `.view(np.int32)` in torch and
as uint32 in numpy.  Fields absent from the dict stay None.  The port's
own leaves (`PORT_ONLY`: statics derived from JAX's) stay out of the
numpy dict, and `world_from_numpy` derives them again.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .state import NESTED, World, sidewalk_count

# leaves whose JAX dtype is uint32 (carried as int32 bits in torch)
U32_LEAVES = frozenset({"key"})
# the port's own leaves, derived from JAX's: no JAX world has them
PORT_ONLY = frozenset({"grid.n_side"})


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
    """The `World` on `device` from numpy leaves keyed by JAX's paths,
    with the port-only statics derived."""
    world = _build(World, leaves, "", lambda a: _to_tensor(a, device))
    return world.replace(grid=world.grid.replace(
        n_side=sidewalk_count(world.grid.cell_type)))


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
        elif isinstance(v, dict):
            for k, t in v.items():
                out[f"{name}.{k}"] = conv(f"{name}.{k}", t)
        else:
            out[name] = conv(name, v)
    return out


def _numpy_leaf(name, t):
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in U32_LEAVES else a


def world_to_numpy(world: World) -> dict:
    """Numpy leaves keyed by JAX's paths, in the JAX package's dtypes
    (the port-only leaves left out)."""
    return {k: v for k, v in _flatten(world, "", {}, _numpy_leaf).items()
            if k not in PORT_ONLY}


def world_leaves(world: World) -> dict:
    """The world's tensors keyed by path (None fields left out)."""
    return _flatten(world, "", {}, lambda name, t: t)
