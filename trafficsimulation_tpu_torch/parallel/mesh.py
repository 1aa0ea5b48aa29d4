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

Sharding over a process group (JAX's `make_mesh` and `P("worlds")`):
one process (rank) a GPU under `torch.distributed`, started by
`parallel/launch.spawn`.  `make_mesh` gives the rank its `Mesh`, and
`mesh.worlds(n)` its contiguous slice of a batch of n worlds.  A rank
builds only its slice (`init_world_batch(..., mesh)`, or
`replicate_world` then `tile_dynamic` with its slice of the keys) and
runs it with the batch runners above, unchanged: every world's draws
come from its own key, so worlds [lo, hi) advance on their rank exactly
as in the unsharded batch, and no world talks to another.  The
kernels choose their form by the rank's own shape (K1's and K9's
cooperative or block-per-world form: bit-equal forms).  The group's
collectives are the demand-window guard (one all-reduce, so that every
rank raises together), `fleet_metrics` (one all-reduce of the three
sums) and the checks' `gather_world_digests`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import prng
from ..config import Config
from ..core.state import World
from ..core.transfer import world_from_leaves, world_leaves, world_to_numpy
from ..lights.fsm import dense_reducers_profitable


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a one-axis mesh of ranks: the process group,
    the rank's index in it (`rank`, 0..size - 1), the group's size, the
    rank's device and the axis name.  A mesh holds the group's first
    `size` ranks, so a mesh rank is also the default group's."""
    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "worlds"

    def worlds(self, n: int) -> slice:
        """This rank's contiguous slice of a batch of n worlds; n must be
        a multiple of the mesh's size (JAX's `P("worlds")` too)."""
        if n % self.size:
            raise ValueError(f"{n} worlds do not split evenly over the "
                             f"{self.size} ranks of the mesh's "
                             f"{self.axis!r} axis")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def rank_device(device, local_rank: int, cuda: bool,
                n_gpus: int) -> torch.device:
    """The device of the rank with index `local_rank` on its host:
    "cpu" where `device` says so, else `cuda:{local_rank % n_gpus}` (an
    explicit "cuda:k" as given).  Without CUDA only "cpu" is taken: a
    rank never falls back to the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not cuda or n_gpus < 1:
        raise RuntimeError("no CUDA device for this rank: pass device='cpu' "
                           "to run the mesh on the CPU")
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        raise ValueError(f"a rank runs on 'cpu' or 'cuda', not {device!r}")
    return dev if dev.index is not None else torch.device(
        "cuda", local_rank % n_gpus)


def make_mesh(n_devices: int | None = None, axis: str = "worlds",
              device=None) -> Mesh | None:
    """The `Mesh` of this rank (JAX's `make_mesh`), called in every rank
    after `torch.distributed.init_process_group` (`parallel/launch.spawn`
    does both).  `n_devices`: the mesh's size, at most the group's; below
    it, the mesh of the first n_devices ranks, as JAX's slices
    `jax.devices()` (every rank must call this then: it makes a process
    group, and the ranks outside the mesh get None).  The device is
    `rank_device(device, LOCAL_RANK)`, made the current CUDA device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs in a rank of a process group: "
                           "call torch.distributed.init_process_group "
                           "first (parallel/launch.spawn does)")
    size, rank = dist.get_world_size(), dist.get_rank()
    n = size if n_devices is None else int(n_devices)
    if not 1 <= n <= size:
        raise ValueError(f"a mesh of {n} devices in a group of {size} ranks")
    cuda = torch.cuda.is_available()
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)), cuda,
                      torch.cuda.device_count() if cuda else 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = dist.group.WORLD if n == size else dist.new_group(
        list(range(n)))
    if rank >= n:
        return None
    return Mesh(group, rank, n, dev, axis)


def init_world_batch(cfg: Config, key, n_worlds: int, mesh=None,
                     device="cuda", timings=None) -> World:
    """n_worlds cities, each from its own key of `prng.split(key,
    n_worlds)` as JAX's `init_world_batch` splits it, every leaf with a
    leading world dim, on `device`.  With a `Mesh`, only this rank's
    slice (`mesh.worlds(n_worlds)`) of the same keys, on the mesh's
    device.  `timings`: a dict that receives the seconds by stage and
    `generate_all_sec` (`sim.init_worlds`).  Under an RL config each
    world's train state comes from its own key."""
    from ..sim import init_worlds
    keys = prng.split(np.asarray(key, np.uint32), n_worlds)
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh: a parallel.mesh.Mesh (make_mesh), not "
                            f"{type(mesh).__name__}")
        keys, device = keys[mesh.worlds(n_worlds)], mesh.device
    return init_worlds(cfg, keys, device, timings)


def replicate_world(world: World | None, mesh: Mesh, src: int = 0) -> World:
    """Rank `src`'s world on every rank of the mesh, on each rank's
    device (JAX's replicated geometry of a shared batch): its leaves'
    bytes packed into one buffer, one broadcast; the leaves come back
    with their dtypes (bool and int8 among them) and shapes.  The other
    ranks pass None.  Then `tile_dynamic(world, keys[mesh.worlds(B)])`
    gives the rank its rollouts."""
    meta = [None]
    if mesh.rank == src:
        leaves = world_leaves(world)
        meta = [[(k, tuple(t.shape), str(t.dtype).split(".")[1])
                 for k, t in leaves.items()]]
    dist.broadcast_object_list(meta, src=src, group=mesh.group)
    spans, off = [], 0
    for k, shape, dt in meta[0]:
        dtype = getattr(torch, dt)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        spans.append((k, shape, dtype, off, n))
        off += -(-n // 16) * 16          # every leaf 16-byte aligned
    if mesh.rank == src:
        buf = torch.zeros(off, dtype=torch.uint8, device=mesh.device)
        for k, _, _, o, n in spans:
            buf[o:o + n] = leaves[k].contiguous().reshape(-1).view(
                torch.uint8).to(mesh.device)
    else:
        buf = torch.empty(off, dtype=torch.uint8, device=mesh.device)
    dist.broadcast(buf, src=src, group=mesh.group)
    if mesh.rank == src and world.grid.is_road.device == mesh.device:
        return world
    return world_from_leaves({k: buf[o:o + n].view(dtype).reshape(shape)
                              for k, shape, dtype, o, n in spans})


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


def run_batch(cfg: Config, worlds: World, n_ticks: int,
              mesh: Mesh | None = None) -> World:
    """n_ticks of `batched_step` (JAX's `run_batch`: `step_world` per
    tick, routing rebuilt every tick), after `assert_demand_window` (over
    the mesh's group with a `mesh`: `worlds` is then the rank's slice)."""
    step = batched_step(cfg)
    assert_demand_window(cfg, worlds, n_ticks, mesh)
    for _ in range(n_ticks):
        worlds = step(worlds)
    return worlds


def run_chunk_batch(cfg: Config, worlds: World, n: int,
                    mesh: Mesh | None = None) -> World:
    """n ticks of every world of a per-world-geometry batch, as the JAX
    bench steps config #4 (`jax.vmap(partial(run_chunk, cfg, n=n))`):
    `sim.advance` under `torch.func.vmap` with every leaf on dim 0, the
    routing planes rebuilt every PATHFINDING_COOLDOWN ticks.  The keys'
    chains are walked on the host up front ([B, n, N_DRAWS] draws, and
    the RL plan of the batch).  `mesh`: `worlds` is the rank's slice,
    and the demand-window guard reduces over the group."""
    from ..sim import advance
    if worlds.cost_field is None:
        raise ValueError("worlds.cost_field is not built")
    assert_demand_window(cfg, worlds, n, mesh)
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


def _tile(world: World, keys, batched) -> World:
    """ONE world as a batch, world b with key b: the leaves where
    `batched(path)` holds copied along a leading batch dim, the others
    as they are.  `keys`: [B, 2] PRNG keys (uint32 bits as int32, or a
    numpy uint32 array)."""
    if isinstance(keys, np.ndarray):
        keys = torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32)
                                .copy())
    B = keys.shape[0]
    out = {k: (t.unsqueeze(0).expand(B, *t.shape).contiguous()
               if batched(k) else t)
           for k, t in world_leaves(world).items()}
    out["key"] = keys.to(world.grid.is_road.device)
    return world_from_leaves(out)


def tile_dynamic(world: World, keys) -> World:
    """Batch ONE world for shared-geometry rollouts: the dynamic leaves
    (an RL controller's train state among them) gain a leading batch dim
    (one per key), each world a copy, as JAX's `tile_dynamic` broadcasts
    them; the geometry stays unbatched and is not copied.  `keys` as
    `_tile`'s."""
    return _tile(world, keys, _batched)


def tile_world(world: World, keys) -> World:
    """A batch of copies of ONE world, every leaf (the geometry too) with
    a leading batch dim, world b with key b: JAX's
    `jax.tree.map(broadcast_to)` of a world then `replace(key=keys)`, as
    the dry run builds its batch."""
    return _tile(world, keys, lambda k: True)


def demand_ticks_remaining(worlds: World) -> int:
    """Host-side: how many more ticks the pre-generated trip table
    covers, min over the batch (last valid depart tick - current tick).
    Takes a single world, a batch of cities (per-world tables) or a
    shared-geometry batch (one table, per-world cursors)."""
    last, tick = _coverage(worlds)
    return last - tick


def _coverage(worlds: World) -> tuple:
    """(the last valid depart tick, min over the batch; the tick, max over
    the batch)."""
    dem = worlds.demand
    depart = dem.depart_tick.cpu().numpy()
    valid = dem.valid.cpu().numpy()
    last = np.where(valid, depart, -1).max(axis=-1)
    return int(np.min(last)), int(worlds.tick.max())


def assert_demand_window(cfg: Config, worlds: World, n_ticks: int,
                         mesh: Mesh | None = None) -> None:
    """Fail loudly when a batched rollout would outrun the pre-generated
    demand table: past the table, spawning would silently stop
    mid-rollout, and a batch cannot regenerate it.  With a `mesh` the
    coverage is the group's (one all-reduce: MIN of the last valid
    depart tick and of minus the tick), so every rank raises together
    and none waits alone at the next collective."""
    last, tick = _coverage(worlds)
    if mesh is not None:
        red = torch.tensor([last, -tick], dtype=torch.int64,
                           device=mesh.device)
        dist.all_reduce(red, op=dist.ReduceOp.MIN, group=mesh.group)
        last, tick = int(red[0]), -int(red[1])
    rem = last - tick
    if n_ticks > rem:
        dt = cfg.TIME_PER_STEP_IN_SECONDS
        raise RuntimeError(
            f"batched rollout of {n_ticks} ticks outruns the pre-"
            f"generated demand table ({rem} ticks of coverage left at "
            f"tick {tick}): spawning would silently "
            "stop mid-rollout.  Regenerate the table first, raise "
            f"DEMAND_PREGEN_DAYS (= {cfg.DEMAND_PREGEN_DAYS}, "
            f"{int(cfg.DEMAND_PREGEN_DAYS * 86400 / dt)} ticks), or "
            "roll out in shorter chunks re-generating between them.")


def run_batch_shared(cfg: Config, batch: World, n_ticks: int,
                     mesh: Mesh | None = None) -> World:
    """Advance a shared-geometry batch (see `tile_dynamic`) n_ticks on
    the device its tensors lie on.  Each world's key chain is walked on
    the host up front ([B, n, N_DRAWS] draws, and the RL plan of the
    batch); the dense light reductions are on where
    `fsm.dense_reducers_profitable` says so, as in the JAX version.
    `mesh`: `batch` holds the rank's rollouts, and the demand-window
    guard reduces over the group."""
    from ..sim import advance, reducer_matrices
    if batch.cost_field is None:
        raise ValueError("batch.cost_field is not built "
                         "(snapshot.build_field)")
    assert_demand_window(cfg, batch, n_ticks, mesh)
    dense = (reducer_matrices(cfg, batch) if dense_reducers_profitable(cfg)
             else None)
    axes = shared_geometry_axes(batch)
    return _vmapped(cfg, batch, n_ticks, lambda w, dr, plan: advance(
        cfg, w, n_ticks, dr, dense, plan), in_dims=axes, out_dims=axes)


def fleet_metrics(worlds: World, mesh: Mesh | None = None) -> dict:
    """Aggregate metrics over the worlds of a batch (of cities or of
    one city's rollouts): int64 sums; with a `mesh`, over every rank's
    worlds (one all-reduce of the three sums, as JAX's sums reduce over
    the sharded batch)."""
    m = worlds.metrics
    sums = torch.stack([
        (m.completed_internal + m.completed_through).sum(),
        (m.created_internal + m.created_through + m.created_service).sum(),
        worlds.vehicles.active.sum()]).long()
    if mesh is not None:
        sums = sums.to(mesh.device)
        dist.all_reduce(sums, group=mesh.group)
    return dict(zip(("completed", "created", "live"), sums.unbind()))


def _row_digests(a: np.ndarray) -> list:
    """`leaf_digest` of each a[b], the float sums taken for all b at
    once."""
    rows = np.ascontiguousarray(a).reshape(a.shape[0], -1)
    head = {"dtype": str(a.dtype), "shape": list(a.shape[1:])}
    out = [dict(head, sha256=hashlib.sha256(r).hexdigest()) for r in rows]
    if np.issubdtype(a.dtype, np.floating):
        d = rows.astype(np.float64)
        sums, mags = d.sum(1), np.abs(d).sum(1)
        top = d.max(1) if d.shape[1] else np.zeros(len(d))
        for o, s, m, t in zip(out, sums, mags, top):
            o.update(sum=float(s), abs_sum=float(m), max=float(t))
    return out


def leaf_digest(a: np.ndarray) -> dict:
    """A leaf's dtype, shape and sha256; an f32 leaf also its float64
    sum, sum of magnitudes and maximum (the JAX digests' form)."""
    return _row_digests(np.asarray(a)[None])[0]


def world_digests(batch: World, whole: tuple = ()) -> list:
    """Per world of a batch (of cities or a shared-geometry batch), in
    order: leaf path (JAX's names, `world_to_numpy`) -> `leaf_digest`,
    with the array itself under "array" where the path starts with one
    of `whole` (trained floats, held within a tolerance)."""
    full = batch.grid.is_road.dim() == 3
    B = int(batch.key.shape[0])
    out = [{} for _ in range(B)]
    for k, a in world_to_numpy(batch).items():
        per = full or _batched(k)
        ds = _row_digests(a) if per else [leaf_digest(a)] * B
        for b in range(B):
            out[b][k] = ds[b]
            if whole and k.startswith(whole):
                out[b][k] = dict(ds[b], array=np.array(a[b] if per else a))
    return out


def gather_world_digests(worlds: World, mesh: Mesh | None, dst: int = 0,
                         whole: tuple = ()) -> list | None:
    """`world_digests` of every rank's worlds, in world order, on rank
    `dst` (None on the others): the checks compare hashes, and no plane
    moves between ranks.  Without a mesh, this process's."""
    mine = world_digests(worlds, whole)
    if mesh is None:
        return mine
    parts = [None] * mesh.size if mesh.rank == dst else None
    dist.gather_object(mine, parts, dst=dst, group=mesh.group)
    return None if parts is None else [d for p in parts for d in p]


def diff_digests(want: dict, got: dict, rtol: float | None = None) -> list:
    """The leaves where world digest `got` differs from `want`: every
    leaf's dtype, shape and sha256; where `rtol` is given, an f32 leaf
    whose bytes differ passes if its sum, sum of magnitudes and maximum
    agree within rtol.  (leaf, reason) pairs."""
    bad = []
    if set(want) != set(got):
        return [(k, "missing") for k in sorted(set(want) ^ set(got))]
    for k, d in want.items():
        g = got[k]
        if (g["dtype"], list(g["shape"])) != (d["dtype"], list(d["shape"])):
            bad.append((k, "dtype/shape"))
        elif g["sha256"] != d["sha256"]:
            near = rtol is not None and "sum" in d and np.allclose(
                [g["sum"], g["abs_sum"], g["max"]],
                [d["sum"], d["abs_sum"], d["max"]], rtol=rtol, atol=0.0)
            if not near:
                bad.append((k, "sha256"))
    return bad


def world_at(batch: World, b: int) -> World:
    """World b of a batch, as a single world: of a batch of cities
    (every leaf batched) or of a shared-geometry batch."""
    full = batch.grid.is_road.dim() == 3
    return world_from_leaves({k: (t[b] if full or _batched(k) else t)
                              for k, t in world_leaves(batch).items()})
