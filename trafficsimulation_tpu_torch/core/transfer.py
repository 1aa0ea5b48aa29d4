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
The port-only leaves (`PORT_ONLY`: statics the port derives from JAX's
leaves) stay out of the numpy dict, and `world_from_numpy` derives them
again (`with_port_statics`).

An RL controller's train state (`rl/controllers.py`) travels too.  JAX
keeps the flax params as {"params": {...}} and optax's state as the
tuple (ScaleByAdamState, EmptyState), so its leaves are named
"rl.params.params.Dense_0.kernel", "rl.opt_state.0.count",
"rl.opt_state.0.mu.params.Dense_0.kernel", ...; the port's are
"rl.params.Dense_0.kernel", "rl.opt_state.count",
"rl.opt_state.mu.Dense_0.kernel", ...  Kernels keep flax's [in, out]
layout on both sides (`rl/nets.py`), so the numpy dicts carry JAX's
names and arrays unchanged, and a JAX world with a trained controller
becomes a port world that acts the same, and back.

`world_leaves` / `world_from_leaves` are the same mapping with the
tensors kept as they are: the form in which `torch.func.vmap` carries a
batch of worlds (`parallel/mesh.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .state import NESTED, World, sidewalk_count
from ..rl.controllers import TRAIN_TYPES, Adam

# leaves whose JAX dtype is uint32 (carried as int32 bits in torch)
U32_LEAVES = frozenset({"key"})
# the port's own leaves, derived from JAX's: no JAX world has them
PORT_ONLY = frozenset({"grid.n_side"})


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")          # keeps 0-d leaves 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


# port leaf prefix -> JAX leaf prefix of a train state's nested trees
_RL_JAX = (("rl.params.", "rl.params.params."),
           ("rl.target_params.", "rl.target_params.params."),
           ("rl.opt_state.count", "rl.opt_state.0.count"),
           ("rl.opt_state.mu.", "rl.opt_state.0.mu.params."),
           ("rl.opt_state.nu.", "rl.opt_state.0.nu.params."))


def _rename(name: str, to_jax: bool) -> str:
    for port, jax in _RL_JAX:
        a, b = (port, jax) if to_jax else (jax, port)
        if name.startswith(a):
            return b + name[len(a):]
    return name


def _sub(leaves: dict, prefix: str, conv) -> dict:
    return {k[len(prefix):]: conv(v) for k, v in leaves.items()
            if k.startswith(prefix)}


def _build_rl(leaves: dict, conv):
    """The train state whose leaves are under "rl." (port names), or
    None: its class is the one whose last field is there."""
    for cls in TRAIN_TYPES:
        fields = dataclasses.fields(cls)
        if "rl." + fields[-1].name not in leaves:
            continue
        kw = {}
        for f in fields:
            name = "rl." + f.name
            if f.name == "opt_state":
                kw[f.name] = Adam(count=conv(leaves[name + ".count"]),
                                  mu=_sub(leaves, name + ".mu.", conv),
                                  nu=_sub(leaves, name + ".nu.", conv))
            elif f.name.endswith("params"):
                kw[f.name] = _sub(leaves, name + ".", conv)
            else:
                kw[f.name] = conv(leaves[name])
        return cls(**kw)
    return None


def _build(cls, leaves: dict, prefix: str, conv):
    kw = {}
    nested = NESTED.get(cls, {})
    for f in dataclasses.fields(cls):
        name = prefix + f.name
        if f.name in nested:
            kw[f.name] = _build(nested[f.name], leaves, name + ".", conv)
        elif name == "rl":
            kw[f.name] = _build_rl(leaves, conv)
        elif name in leaves:
            kw[f.name] = conv(leaves[name])
        else:
            kw[f.name] = None
    return cls(**kw)


def with_port_statics(world: World) -> World:
    """The world with its port-only statics (`PORT_ONLY`) derived where
    they are missing (and its cell plane is there)."""
    if world.grid.n_side is not None or world.grid.cell_type is None:
        return world
    return world.replace(grid=world.grid.replace(
        n_side=sidewalk_count(world.grid.cell_type)))


def world_from_numpy(leaves: dict, device) -> World:
    """The port's `World` on `device` from JAX leaves keyed by path."""
    leaves = {_rename(k, False): v for k, v in leaves.items()}
    return with_port_statics(
        _build(World, leaves, "", lambda a: _to_tensor(a, device)))


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
    return {_rename(k, True): v
            for k, v in _flatten(world, "", {}, _numpy_leaf).items()
            if k not in PORT_ONLY}


def world_leaves(world: World) -> dict:
    """The world's tensors keyed by path (None fields left out)."""
    return _flatten(world, "", {}, lambda name, t: t)


def with_rl_params(world: World, params: dict) -> World:
    """The world with its RL controller's parameters replaced by
    `params` (numpy arrays keyed by flax's names, "Dense_0.kernel", ...;
    a GAT controller's target network too), on the world's device."""
    dev = world.key.device
    new = {k: _to_tensor(v, dev) for k, v in params.items()}
    if set(new) != set(world.rl.params):
        raise ValueError(f"parameter names differ from the controller's: "
                         f"{sorted(set(new) ^ set(world.rl.params))}")
    rl = world.rl.replace(params=new)
    if hasattr(rl, "target_params"):
        rl = rl.replace(target_params=dict(new))
    return world.replace(rl=rl)
