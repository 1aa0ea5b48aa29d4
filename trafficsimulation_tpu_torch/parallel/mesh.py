"""World batches on one device (the JAX package's `parallel/mesh.py`,
its one-device part): batches of different cities, and shared-geometry
batches of one city.

Per-world geometry (BASELINE config #4, the parameter-sweep axis): every
leaf of the world carries a leading batch dim B.  `init_world_batch`
generates the cities from one key each (`sim.init_worlds`: the host
draws of all worlds side by side, each device stage once for the batch);
`run_chunk_batch` runs the chunk body (`sim.advance`) under
`torch.func.vmap` with every leaf on dim 0, as the JAX bench runs
`jax.vmap(run_chunk)`, and `run_batch` steps `sim.step_device` under
vmap tick by tick (JAX's `run_batch`: routing rebuilt every tick).  Each
world's key chain is walked on the host.  The kernels' vmap rules launch
K1, K2 (`build_sdir_stacks`), K3 and K4 once per call for the whole
batch, each world reading its own geometry (under the megakernel gate,
K9 once a segment, one block a world); world b advances exactly as a
single-world run of world b.

Shared geometry:
The geometry and static tables (`SHARED_GEOMETRY_FIELDS`), the
[D, 4, H, W] key stack among them, are stored once for the whole batch;
every other leaf of the world gains a leading batch dim B, and the trip
table is shared while each world keeps its own consumption cursor.  The
rollouts diverge through their per-world keys.  `run_batch_shared` runs
the single-world chunk body (`sim.advance`) under `torch.func.vmap`
with these axes, as the JAX version runs `run_chunk` under `jax.vmap`:
each kernel wrapper's vmap rule launches its batched kernel once per
tick or segment for the whole batch (K5 reads the shared key stack once
per segment; under the megakernel gate K9 once a segment, the shared
chunk tables read by every world), and the dense light reductions
become one batched matrix product.  World b of the batch advances exactly as a single-world
`sim.run_chunk` of the same world with key b.

RL light controllers: every world has its own train state (parameters,
Adam moments, buffers; per-world leaves in both batch kinds, so
`tile_dynamic` copies the one world's state to every world, as JAX
broadcasts it).  The host plan of a chunk (`rl/controllers.plan_ticks`)
covers the batch, its tensors entering the vmapped body with in-dim 0;
in a tick where only some worlds train, every world computes the update
and keeps it where its flag is set (JAX's `lax.cond` under vmap).  The
controllers' dense layers are batched matrix products; no kernel or op
loops over the worlds.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import prng
from ..config import Config
from ..core.state import World
from ..core.transfer import world_from_leaves, world_leaves
from ..lights.fsm import dense_reducers_profitable


def init_world_batch(cfg: Config, key, n_worlds: int, mesh=None,
                     device="cuda", timings=None) -> World:
    """n_worlds cities, each from its own key of `prng.split(key,
    n_worlds)` as JAX's `init_world_batch` splits it, every leaf with a
    leading world dim, on `device`.  `mesh`: multi-GPU sharding is not
    ported (ROADMAP Queue 1 item 15), so anything but None raises.
    `timings`: a dict that receives the seconds by stage and
    `generate_all_sec` (`sim.init_worlds`).  Under an RL config each
    world's train state comes from its own key."""
    if mesh is not None:
        raise NotImplementedError(
            "sharding a world batch over devices is not ported yet "
            "(ROADMAP Queue 1 item 15)")
    from ..sim import init_worlds
    return init_worlds(cfg, prng.split(np.asarray(key, np.uint32), n_worlds),
                       device, timings)


def _vmapped(cfg: Config, worlds: World, n: int, fn, in_dims=0,
             out_dims=0) -> World:
    """`fn(world, draws, rl_plan)` under `torch.func.vmap` over a batch,
    after walking every world's key chain n ticks on the host
    (`sim._chain`: the [B, n, N_DRAWS] draws and, under an RL
    controller, the batch's plan, whose tensors go in with in-dim 0 and
    whose host flags hold for every world); the keys after n ticks."""
    from ..sim import _chain, _key_tensor
    dev = worlds.grid.is_road.device
    draws, plan, keys = _chain(cfg, worlds, n)

    def body(lv, dr, pt):
        return world_leaves(fn(world_from_leaves(lv), dr,
                               None if plan is None else plan.of(pt)))

    out = torch.func.vmap(body, in_dims=(in_dims, 0, 0), out_dims=out_dims)(
        world_leaves(worlds), torch.from_numpy(draws).to(dev),
        {} if plan is None else plan.tensors)
    out["key"] = _key_tensor(keys, dev)
    return world_from_leaves(out)


def batched_step(cfg: Config):
    """One tick of every world of a per-world-geometry batch (JAX's
    `batched_step`, `jax.vmap(step_world)`): each world's key chain is
    walked one tick on the host, then `sim.step_device` runs under
    `torch.func.vmap` with every leaf on dim 0 (the RL controller's
    inputs of the tick too)."""
    from ..sim import step_device

    def step(worlds: World) -> World:
        return _vmapped(cfg, worlds, 1, lambda w, dr, plan: step_device(
            cfg, w, dr[0], None if plan is None else plan.tick(0)))
    return step


def run_batch(cfg: Config, worlds: World, n_ticks: int) -> World:
    """n_ticks of `batched_step` (JAX's `run_batch`: `step_world` per
    tick, routing rebuilt every tick), after `assert_demand_window`."""
    step = batched_step(cfg)
    assert_demand_window(cfg, worlds, n_ticks)
    for _ in range(n_ticks):
        worlds = step(worlds)
    return worlds


def run_chunk_batch(cfg: Config, worlds: World, n: int) -> World:
    """n ticks of every world of a per-world-geometry batch, as the JAX
    bench steps config #4 (`jax.vmap(partial(run_chunk, cfg, n=n))`):
    `sim.advance` under `torch.func.vmap` with every leaf on dim 0, the
    routing planes rebuilt every PATHFINDING_COOLDOWN ticks.  The keys'
    chains are walked on the host up front ([B, n, N_DRAWS] draws, and
    the RL plan of the batch)."""
    from ..sim import advance
    if worlds.cost_field is None:
        raise ValueError("worlds.cost_field is not built")
    assert_demand_window(cfg, worlds, n)
    return _vmapped(cfg, worlds, n, lambda w, dr, plan: advance(
        cfg, w, n, dr, rl_plan=plan))


SHARED_GEOMETRY_FIELDS = frozenset({
    "grid", "lights_static", "groups_static", "blocks_static", "dests",
    "cost_field", "nearest_exit", "local_sdir4"})
_DEMAND_DYNAMIC = frozenset({"cursor"})


def _batched(path: str) -> bool:
    """Whether the leaf at `path` carries the batch dim."""
    top, _, rest = path.partition(".")
    if top in SHARED_GEOMETRY_FIELDS:
        return False
    if top == "demand":
        return rest in _DEMAND_DYNAMIC
    return True


def shared_geometry_axes(world: World) -> dict:
    """vmap in_dims / out_dims of a shared-geometry batch, per leaf path
    (`core.transfer.world_leaves`): 0 for per-world leaves, None for the
    shared ones."""
    return {k: (0 if _batched(k) else None) for k in world_leaves(world)}


def tile_dynamic(world: World, keys: torch.Tensor) -> World:
    """Batch ONE world for shared-geometry rollouts: the dynamic leaves
    (an RL controller's train state among them) gain a leading batch dim
    (one per key), each world a copy, as JAX's `tile_dynamic` broadcasts
    them; the geometry stays unbatched and is not copied.  `keys`: [B, 2]
    PRNG keys (uint32 bits as int32, or a numpy uint32 array)."""
    dev = world.grid.is_road.device
    if isinstance(keys, np.ndarray):
        keys = torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32)
                                .copy())
    keys = keys.to(dev)
    B = keys.shape[0]
    out = {}
    for k, t in world_leaves(world).items():
        if k == "key":
            out[k] = keys
        elif _batched(k):
            out[k] = t.unsqueeze(0).expand(B, *t.shape).contiguous()
        else:
            out[k] = t
    return world_from_leaves(out)


def demand_ticks_remaining(worlds: World) -> int:
    """Host-side: how many more ticks the pre-generated trip table
    covers, min over the batch (last valid depart tick - current tick).
    Takes a single world, a batch of cities (per-world tables) or a
    shared-geometry batch (one table, per-world cursors)."""
    dem = worlds.demand
    depart = dem.depart_tick.cpu().numpy()
    valid = dem.valid.cpu().numpy()
    tick = worlds.tick.cpu().numpy()
    last = np.where(valid, depart, -1).max(axis=-1)
    return int(np.min(last) - np.max(tick))


def assert_demand_window(cfg: Config, worlds: World, n_ticks: int) -> None:
    """Fail loudly when a batched rollout would outrun the pre-generated
    demand table: past the table, spawning would silently stop
    mid-rollout, and a batch cannot regenerate it."""
    rem = demand_ticks_remaining(worlds)
    if n_ticks > rem:
        dt = cfg.TIME_PER_STEP_IN_SECONDS
        raise RuntimeError(
            f"batched rollout of {n_ticks} ticks outruns the pre-"
            f"generated demand table ({rem} ticks of coverage left at "
            f"tick {int(worlds.tick.max())}): spawning would silently "
            "stop mid-rollout.  Regenerate the table first, raise "
            f"DEMAND_PREGEN_DAYS (= {cfg.DEMAND_PREGEN_DAYS}, "
            f"{int(cfg.DEMAND_PREGEN_DAYS * 86400 / dt)} ticks), or "
            "roll out in shorter chunks re-generating between them.")


def run_batch_shared(cfg: Config, batch: World, n_ticks: int) -> World:
    """Advance a shared-geometry batch (see `tile_dynamic`) n_ticks on
    the device its tensors lie on.  Each world's key chain is walked on
    the host up front ([B, n, N_DRAWS] draws, and the RL plan of the
    batch); the dense light reductions are on where
    `fsm.dense_reducers_profitable` says so, as in the JAX version."""
    from ..sim import advance, reducer_matrices
    if batch.cost_field is None:
        raise ValueError("batch.cost_field is not built "
                         "(snapshot.build_field)")
    assert_demand_window(cfg, batch, n_ticks)
    dense = (reducer_matrices(cfg, batch) if dense_reducers_profitable(cfg)
             else None)
    axes = shared_geometry_axes(batch)
    return _vmapped(cfg, batch, n_ticks, lambda w, dr, plan: advance(
        cfg, w, n_ticks, dr, dense, plan), in_dims=axes, out_dims=axes)


def fleet_metrics(worlds: World) -> dict:
    """Aggregate metrics over the worlds of a batch (of cities or of
    one city's rollouts)."""
    m = worlds.metrics
    return dict(
        completed=(m.completed_internal + m.completed_through).sum(),
        created=(m.created_internal + m.created_through
                 + m.created_service).sum(),
        live=worlds.vehicles.active.sum())


def world_at(batch: World, b: int) -> World:
    """World b of a batch, as a single world: of a batch of cities
    (every leaf batched) or of a shared-geometry batch."""
    full = batch.grid.is_road.dim() == 3
    return world_from_leaves({k: (t[b] if full or _batched(k) else t)
                              for k, t in world_leaves(batch).items()})
