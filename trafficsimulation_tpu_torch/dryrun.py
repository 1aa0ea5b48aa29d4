"""The multi-GPU dry run (the JAX package's `__graft_entry__.
dryrun_multichip`): the full training step on a batch of worlds sharded
along the `worlds` axis, one rank a GPU.

`dryrun_cfg()` is the JAX dry run's configuration letter for letter:
tiny shapes, every subsystem on, A2C light-controller training inside
the step with an update every tick.  `dryrun_multichip(n_ranks, n_worlds,
backend=...)` spawns n_ranks ranks (`parallel/launch.spawn`); each builds
the synthetic crossroad (`core/synth.crossroad_world`), takes its slice
of the batch of n_worlds copies with keys `split(PRNGKey(0), n_worlds)`,
runs one tick of `batched_step` (lights, the A2C update, movement,
demand, rain, blocks), all-reduces `created_internal + created_through`
over the group, and asserts that the A2C update moved the parameters of
every world it holds.  On one GPU the ranks share it over "gloo".
"""

from __future__ import annotations

import time

import numpy as np
import torch.distributed as dist

from . import prng
from .config import Config


def dryrun_cfg() -> Config:
    """Config for the multi-chip dry run: tiny shapes, every subsystem
    on (A2C light-controller TRAINING inside the step).  The synthetic
    crossroad world supplies the geometry, so the generation pipeline is
    not part of the run: the sharded object is the training step."""
    return Config(
        WIDTH=32, HEIGHT=32,
        MAX_FIELD_DESTS=8,
        # the dry run proves sharding correctness, not throughput: every
        # knob that only scales the work is at its minimum (2 movement
        # sub-rounds, 2 x 32 A2C nets)
        VEHICLE_MAX_SPEED=2,
        VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS=3,
        TRAFFIC_LIGHT_AGENT_ALGORITHM="RL_A2C_BATCHED",
        A2C_HIDDEN_LAYERS=2, A2C_HIDDEN_LAYER_SIZE=32, A2C_BATCH_SIZE=32,
        A2C_UPDATE_EVERY=1,   # the very first tick takes a gradient step
        CAP_OVERRIDES=(
            ("max_lights", 8), ("max_groups", 4), ("max_blocks", 4),
            ("max_dests", 8), ("max_exits", 8), ("max_entrances_hw", 8),
            ("max_queue_cells", 64), ("max_vehicles", 64),
            ("max_trips", 64), ("max_spawns_per_tick", 8)))


# the trained floats of the dry run's worlds, held within a tolerance
TRAINED = ("rl.params.", "rl.opt_state.0.mu.", "rl.opt_state.0.nu.",
           "rl.roll_v")


def dryrun_rank(mesh, n_worlds: int = 8, ticks: int = 1) -> dict:
    """The dry run in one rank of `mesh`: its slice of the batch, `ticks`
    ticks of `batched_step`; the group's `created_internal +
    created_through` after the first tick (every rank the same), the
    launches of this rank's run, when it started (`time.time()`) and its
    seconds, and on rank 0 the digests of every
    world after each tick (`gather_world_digests`, the trained floats
    whole).  Raises if the A2C update left a world's parameters where
    they were."""
    from .core import synth
    from .ops import hopper_engine as HE
    from .parallel import mesh as M
    started = time.time()
    cfg = dryrun_cfg()
    w0 = synth.crossroad_world(cfg, device=mesh.device)
    keys = prng.split(prng.PRNGKey(0), n_worlds)[mesh.worlds(n_worlds)]
    batch = M.tile_world(w0, keys)
    step = M.batched_step(cfg)
    out = {"rank": mesh.rank, "digests": []}
    HE.reset_launches()
    for t in range(ticks):
        batch = step(batch)
        if t == 0:
            m = batch.metrics
            total = (m.created_internal + m.created_through).sum().long()
            total = total.reshape(1).to(mesh.device)
            dist.all_reduce(total, group=mesh.group)
            out["total"] = int(total)
            first = sorted(w0.rl.params)[0]
            p0 = w0.rl.params[first].cpu().numpy()
            p1 = batch.rl.params[first].cpu().numpy()
            still = [b for b in range(len(p1)) if np.allclose(p0, p1[b])]
            if still:
                raise AssertionError(f"rank {mesh.rank}: A2C training did "
                                     f"not update the parameters of its "
                                     f"worlds {still}")
        out["digests"].append(M.gather_world_digests(batch, mesh,
                                                     whole=TRAINED))
    out.update(launches=dict(HE.launches), started_at=started,
               job_s=time.time() - started)
    return out


def dryrun_multichip(n_ranks: int, n_worlds: int = 8, *, backend: str,
                     device=None, ticks: int = 1) -> list:
    """The dry run over n_ranks ranks (`dryrun_rank`), n_worlds worlds in
    all; `backend` "gloo" or "nccl" (no default: see
    `parallel/launch.check_backend`), `device` "cpu" or the GPUs.
    Returns each rank's result; any failing rank fails the call."""
    from .parallel import launch
    return launch.spawn(dryrun_rank, n_ranks, backend, device,
                        args=(n_worlds, ticks))
