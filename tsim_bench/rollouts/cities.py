"""Rollouts of a batch of different cities (BASELINE config #4, a
parameter sweep): every rollout starts from the set-up's worlds at tick
0 with the rollout's own keys, put in place of the worlds' key leaf,
and runs `parallel.mesh.run_chunk_batch` (`sim.advance` under
`torch.func.vmap`, every leaf batched)."""

import torch


def worlds(pkg, cfg, start, cell) -> int:
    """The batch's worlds: every city."""
    return int(start.key.shape[0])


def sample(worlds: list):
    """What the set-up steps build for the reference: the sampled cities."""
    return worlds


def begin(pkg, cfg, start, keys):
    leaves = pkg.transfer.world_leaves(start)
    leaves["key"] = torch.from_numpy(keys.view("int32").copy()).to(
        start.key.device)
    return pkg.transfer.world_from_leaves(leaves)


def chunk(pkg, cfg, batch, n: int):
    return pkg.mesh.run_chunk_batch(cfg, batch, n)


def world(pkg, batch, b: int):
    return pkg.mesh.world_at(batch, b)


def start_worlds(prog, start, sample: list) -> list:
    """The program's start worlds that the check compares: the sample."""
    return [prog.mesh.world_at(start, b) for b in sample]


def ref_starts(ref, start) -> list:
    """The reference's start worlds, in the order of `start_worlds`: it
    built the sample alone, one world each."""
    return list(start)


def ref_rollout(ref, starts: list, keys) -> list:
    """The reference's sampled worlds at the start of a rollout: each
    sampled city with its key of the rollout (uint32 [k, 2])."""
    return [with_key(w, k) for w, k in zip(starts, keys)]


def with_key(world, key):
    return world.replace(key=torch.from_numpy(
        key.view("int32").copy()).to(world.key.device))
