"""Rollouts of one city with shared geometry (BASELINE config #2 as a
policy search scores it): every rollout tiles the set-up's world at
tick 0 into B worlds with the rollout's keys (`parallel.mesh.
tile_dynamic`, the geometry stored once) and runs `parallel.mesh.
run_batch_shared` (`sim.advance` under `torch.func.vmap`).  B is the
cell's `batch`, capped as the JAX bench caps it (`bench.py`:
`batch_cap_bytes` over the world's dynamic bytes)."""

import sys

import torch


def dynamic_bytes(pkg, world) -> int:
    """The bytes of the leaves a rollout copies (all but the geometry)."""
    return sum(t.numel() * t.element_size()
               for k, t in pkg.transfer.world_leaves(world).items()
               if k.split(".")[0] not in pkg.mesh.SHARED_GEOMETRY_FIELDS)


def worlds(pkg, cfg, start, cell) -> int:
    """The batch's worlds: the cell's `batch`, capped."""
    dyn = dynamic_bytes(pkg, start)
    B = max(1, min(int(cell["batch"]), int(cell["batch_cap_bytes"] / dyn)))
    print(f"shared rollouts: {dyn} dynamic bytes a world, B = {B} "
          f"(asked {cell['batch']}, cap {cell['batch_cap_bytes']:.3g} "
          "bytes)", file=sys.stderr)
    return B


def sample(worlds: list):
    """What the set-up steps build for the reference: the one city."""
    return None


def begin(pkg, cfg, start, keys):
    return pkg.mesh.tile_dynamic(start, keys)


def chunk(pkg, cfg, batch, n: int):
    return pkg.mesh.run_batch_shared(cfg, batch, n)


def world(pkg, batch, b: int):
    return pkg.mesh.world_at(batch, b)


def start_worlds(prog, start, sample: list) -> list:
    """The program's start worlds that the check compares: the one city."""
    return [start]


def ref_starts(ref, start) -> list:
    return [start]


def ref_rollout(ref, starts: list, keys) -> list:
    """The reference's sampled rollouts at their start: the one city with
    each sampled world's key of the rollout (uint32 [k, 2]), as
    `tile_dynamic` gives each world its key."""
    start, = starts
    return [start.replace(key=torch.from_numpy(k.view("int32").copy()).to(
        start.key.device)) for k in keys]
