"""Rank bodies of the sharded world batches, for `parallel/launch.spawn`.

`run_jobs(mesh, jobs)` runs a list of jobs in order in every rank of one
spawn (the ranks start once for all of them).  A job is a dict: "kind"
(a function of this module named in `JOBS`), "ranks" (the size of the
job's mesh: the first n ranks, `make_mesh(n)`; all by default) and the
function's keyword arguments.  Each job builds its rank's slice of a
batch, runs it with the port's batch runners, and returns per rank:

  * `worlds`: the rank's [lo, hi) of the batch;
  * `launches`: the kernel launches of the run on this rank
    (`hopper_engine.launches`; none on the CPU, where the wrappers run
    the plain versions) and `forms`: the forms of K1 and K9 it took;
  * `fleet`: `fleet_metrics` over the mesh (every rank the same);
  * `digests` (on rank 0 only): `gather_world_digests` of the end state,
    every world of the batch in order.

Every result also carries `started_at` (`time.time()` when the rank
began the job) and `job_s`.  A rank outside a job's mesh returns None
for it.  `scaling` is timing with no check, for `chip_smoke.py --only
mesh_scaling`.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import prng
from ..config import Config
from ..dryrun import dryrun_rank
from . import mesh as M

# the environment of the megakernel gate (`ops/megakernel.mega_ok`)
_PATH_KEYS = ("TSIM_MEGA_FORCE", "TSIM_NO_MEGAKERNEL", "TSIM_MEGA_INTERPRET")


@contextlib.contextmanager
def path_env(mega: bool):
    """The megakernel path (TSIM_MEGA_FORCE) or the per-tick path
    (TSIM_NO_MEGAKERNEL) inside the block."""
    saved = {k: os.environ.pop(k, None) for k in _PATH_KEYS}
    os.environ["TSIM_MEGA_FORCE" if mega else "TSIM_NO_MEGAKERNEL"] = "1"
    try:
        yield
    finally:
        for k in _PATH_KEYS:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def forms(launches: dict) -> dict:
    """The forms of K1 and K9 a run took, from its launch counts: "worlds"
    (one block a world), "coop" (the cooperative grid) or None."""
    def form(blocks: str, coop: str):
        return ("worlds" if launches.get(blocks) else
                "coop" if launches.get(coop) else None)
    return {"k1": form("decide_move_blocks", "decide_move"),
            "k9": form("mega_worlds", "mega")}


def _sync(mesh: M.Mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _run(mesh: M.Mesh, fn, mega: bool, whole: tuple) -> dict:
    """`fn()` (the rank's run) on one path, its launches counted; the
    result's fleet metrics over the mesh and digests on rank 0."""
    from ..ops import hopper_engine as HE
    with path_env(mega):
        HE.reset_launches()
        _sync(mesh)
        t0 = time.perf_counter()
        end = fn()
        _sync(mesh)
        seconds = time.perf_counter() - t0
        launches = dict(HE.launches)
    fleet = {k: int(v) for k, v in M.fleet_metrics(end, mesh).items()}
    t0 = time.perf_counter()
    digests = M.gather_world_digests(end, mesh, whole=whole)
    return {"rank": mesh.rank, "launches": launches, "forms": forms(launches),
            "seconds": seconds, "fleet": fleet, "digests": digests,
            "digest_s": time.perf_counter() - t0}


def cities(mesh: M.Mesh, cfg: Config, ticks: int, key=None,
           n_worlds: int | None = None, keys=None, paths=(False,),
           whole: tuple = (), init: bool = False) -> dict:
    """A batch of cities: n_worlds from `key` (`init_world_batch(cfg,
    key, n_worlds, mesh)`), or one from each of `keys` [n, 2] (uint32;
    the rank's slice through `sim.init_worlds`); then `run_chunk_batch`
    for `ticks` ticks from init on each path of `paths` (True: the
    megakernel path).  `init`: the digests at init too."""
    t0 = time.perf_counter()
    if keys is None:
        worlds = M.init_world_batch(cfg, key, n_worlds, mesh)
    else:
        from ..sim import init_worlds
        n_worlds = len(keys)
        worlds = init_worlds(cfg, np.asarray(keys, np.uint32)[
            mesh.worlds(n_worlds)], mesh.device)
    _sync(mesh)
    sl = mesh.worlds(n_worlds)
    out = {"worlds": [sl.start, sl.stop], "build_s": time.perf_counter() - t0}
    if init:
        out["init"] = M.gather_world_digests(worlds, mesh, whole=whole)
    for mega in paths:
        out["mega" if mega else "per_tick"] = _run(
            mesh, lambda: M.run_chunk_batch(cfg, worlds, ticks, mesh), mega,
            whole)
    return out


def _world(mesh: M.Mesh, cfg: Config, world: str):
    """The world a batch rolls out, built on rank 0 and sent to the
    others (`replicate_world`): the synthetic crossroad, or
    the headline city generated from its seed as the port's `snapshot`
    names it (`cfg` must be the configuration its `measure_and_shrink`
    gives)."""
    from .. import sim, snapshot
    from ..core import synth
    w = None
    if mesh.rank == 0:
        if world == "crossroad":
            w = synth.crossroad_world(cfg, device=mesh.device)
        elif world == "headline":
            c = Config(**snapshot.HEADLINE_CFG)
            w = sim.init_world(c, prng.PRNGKey(snapshot.HEADLINE_SEED),
                               mesh.device)
            c, w = sim.measure_and_shrink(c, w)
            w = sim.inject_vehicles(c, w, snapshot.HEADLINE_VEHICLES)
            if c != cfg:
                raise AssertionError("the headline's shrunk config differs "
                                     "from the one given")
        else:
            raise ValueError(f"world {world!r}: 'crossroad' or 'headline'")
    return M.replicate_world(w, mesh)


def rollouts(mesh: M.Mesh, cfg: Config, keys, ticks: int,
             world: str = "crossroad", layout: str = "shared",
             paths=(False,), whole: tuple = ()) -> dict:
    """Rollouts of one world (`_world`) with `keys` [B, 2] (uint32), the
    rank's slice of them: a shared-geometry batch (`tile_dynamic`, then
    `run_batch_shared`), or with layout "full" every leaf copied
    (`tile_world`, then `run_batch`); `ticks` ticks on each path of
    `paths`."""
    keys = np.asarray(keys, np.uint32)
    t0 = time.perf_counter()
    w = _world(mesh, cfg, world)
    sl = mesh.worlds(len(keys))
    if layout == "shared":
        batch, run = M.tile_dynamic(w, keys[sl]), M.run_batch_shared
    else:
        batch, run = M.tile_world(w, keys[sl]), M.run_batch
    del w
    _sync(mesh)
    out = {"worlds": [sl.start, sl.stop], "build_s": time.perf_counter() - t0}
    for mega in paths:
        out["mega" if mega else "per_tick"] = _run(
            mesh, lambda: run(cfg, batch, ticks, mesh), mega, whole)
    return out


def scaling(mesh: M.Mesh, cfg: Config, keys, ticks: int,
            profile: int) -> dict:
    """Timing (no check): the rollouts `keys` of the headline city
    (`_world`) split over the mesh, each path warmed one segment, then `ticks`
    ticks between two barriers (wall seconds on this rank) and `profile`
    ticks under torch.profiler (this rank's device busy ms a tick)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    keys = np.asarray(keys, np.uint32)
    w = _world(mesh, cfg, "headline")
    state = {"b": M.tile_dynamic(w, keys[mesh.worlds(len(keys))])}
    R = cfg.PATHFINDING_COOLDOWN

    def run(n):
        state["b"] = M.run_batch_shared(cfg, state["b"], n, mesh)
    out = {"rank": mesh.rank, "worlds": len(keys) // mesh.size}
    for mega in (True, False):
        with path_env(mega):
            run(R)
            _sync(mesh)
            dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            run(ticks)
            _sync(mesh)
            wall = time.perf_counter() - t0
            dist.barrier(group=mesh.group)
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as p:
                t1 = time.perf_counter()
                run(profile)
                _sync(mesh)
                pwall = time.perf_counter() - t1
            busy = sum(e.self_device_time_total for e in p.key_averages()
                       if e.device_type == DeviceType.CUDA) / 1e3 / profile
            out["mega" if mega else "per_tick"] = {
                "wall_s": wall, "ticks": ticks,
                "busy_ms_per_tick": busy,
                "profiled_wall_ms_per_tick": pwall * 1e3 / profile,
                "idle_share": 1 - busy / (pwall * 1e3 / profile)}
            dist.barrier(group=mesh.group)
    return out


def save_world(world, path: str) -> None:
    """Write a world's leaves (on the CPU) to `path`, for a split run's
    source rank to load (`split_world(..., "file", path=path)`): a world
    built once in the parent process, not once more in a rank."""
    from ..core.transfer import world_leaves
    torch.save({k: t.detach().cpu() for k, t in world_leaves(world).items()},
               path)


def split_world(cfg: Config, world: str, device, key=None,
                inject: int = 0, path: str = None):
    """The whole world a split run starts from, built on its source rank
    alone: the synthetic crossroad (`core/synth.crossroad_world`); a
    city generated from `key` (`sim.init_world`, no shrink, as config #4
    runs) with `inject` vehicles; the headline city (`snapshot`'s:
    `cfg` must be the configuration its `measure_and_shrink` gives); or
    the world that `save_world` wrote to `path` ("file")."""
    from .. import sim, snapshot
    from ..core import synth
    if world == "crossroad":
        return synth.crossroad_world(cfg, device=device)
    if world == "city":
        w = sim.init_world(cfg, key, device)
        return sim.inject_vehicles(cfg, w, inject) if inject else w
    if world == "file":
        from ..core.transfer import world_from_leaves
        return world_from_leaves(torch.load(path, map_location=device))
    if world != "headline":
        raise ValueError(f"world {world!r}: 'crossroad', 'city', "
                         "'headline' or 'file'")
    c = Config(**snapshot.HEADLINE_CFG)
    w = sim.init_world(c, prng.PRNGKey(snapshot.HEADLINE_SEED), device)
    c, w = sim.measure_and_shrink(c, w)
    if c != cfg:
        raise AssertionError("the headline's shrunk config differs from the "
                             "one given")
    return sim.inject_vehicles(c, w, snapshot.HEADLINE_VEHICLES)


def _split_source(cfg: Config, world: str, mesh: M.Mesh, key, inject,
                  path=None):
    """Rank 0's source world of the split runs, kept on the CPU between
    them (its device holds only its slab while it runs); None on the
    other ranks."""
    if mesh.rank != 0:
        return None
    from ..core.transfer import world_from_leaves, world_leaves
    if world == "file":
        return split_world(cfg, world, "cpu", path=path)
    w = split_world(cfg, world, mesh.device, key, inject)
    w = world_from_leaves({k: t.cpu() for k, t in world_leaves(w).items()})
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return w


def spatial(mesh: M.Mesh, cfg: Config, ticks: int, world: str = "crossroad",
            splits=(None,), key=None, inject: int = 0,
            mega_env: bool = False, path: str = None) -> dict:
    """One world split by rows (`parallel/spatial.py`) over the first n
    ranks of each n in `splits` (None: all): rank 0 builds it once, or
    loads it from `path` (`split_world`), `shard_world` lays it out,
    `run_chunk_spatial` runs `ticks` ticks on the per-tick path (under
    TSIM_MEGA_FORCE with `mega_env`, which the split must ignore) and
    `gather_world` brings it back.  Per split (keyed by its size) and
    rank: its launches, collectives (`Slab.stats`), rows, resident bytes
    of the key stack and of hierarchical routing's windowed stack, peak
    device memory of the run and seconds; on rank 0 the gathered world's
    leaf digests (`mesh.leaf_digest` of JAX's leaf paths), the trained
    floats whole."""
    from ..core.transfer import world_to_numpy
    from ..dryrun import TRAINED
    from ..ops import hopper_engine as HE
    from . import spatial as SP
    src = _split_source(cfg, world, mesh, key, inject, path)
    out = {}
    for n in splits:
        sm = SP.spatial_mesh(n, mesh.device)
        label = str(n or mesh.size)
        if sm is None:
            out[label] = None
            continue
        t0 = time.perf_counter()
        sw = SP.shard_world(src, sm, cfg)
        _sync(sm)
        shard_s = time.perf_counter() - t0
        if sm.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(sm.device)
        with path_env(mega_env):
            HE.reset_launches()
            dist.barrier(group=sm.group)
            t0 = time.perf_counter()
            sw = SP.run_chunk_spatial(cfg, sw, ticks, sm)
            _sync(sm)
            seconds = time.perf_counter() - t0
            launches = dict(HE.launches)
        slab = sw.slab
        loc = sw.world.local_sdir4
        res = {"rank": sm.rank, "launches": launches, "seconds": seconds,
               "shard_s": shard_s, "stats": dict(slab.stats),
               "own": slab.own, "dec": slab.dec, "route": slab.route,
               "halo": (slab.P, slab.Q),
               "cost_field_bytes": sw.world.cost_field.numel()
               * sw.world.cost_field.element_size(),
               "cost_field_shape": tuple(sw.world.cost_field.shape),
               "local_sdir4_bytes": None if loc is None
               else loc.numel() * loc.element_size(),
               "local_sdir4_shape": None if loc is None else tuple(loc.shape),
               "peak_bytes": (torch.cuda.max_memory_allocated(sm.device)
                              if sm.device.type == "cuda" else None)}
        t0 = time.perf_counter()
        g = SP.gather_world(sw, sm)
        if g is not None:
            res["digests"] = {
                k: dict(M.leaf_digest(a), **({"array": a} if k.startswith(
                    TRAINED) else {}))
                for k, a in world_to_numpy(g).items()}
        res["gather_s"] = time.perf_counter() - t0
        out[label] = res
        del sw, g
        if sm.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def spatial_scaling(mesh: M.Mesh, cfg: Config, ticks: int, profile: int,
                    splits=(None,), world: str = "headline") -> dict:
    """Timing (no check): one world split over the first n ranks of each
    n in `splits`, warmed one routing segment, then `ticks` ticks between
    two barriers (wall seconds on this rank, and the collectives of those
    ticks with their host seconds) and `profile` ticks under
    torch.profiler (this rank's device busy ms a tick)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from . import spatial as SP
    src = _split_source(cfg, world, mesh, None, 0)
    R = cfg.PATHFINDING_COOLDOWN
    out = {}
    for n in splits:
        sm = SP.spatial_mesh(n, mesh.device)
        label = str(n or mesh.size)
        if sm is None:
            out[label] = None
            continue
        state = {"w": SP.shard_world(src, sm, cfg)}

        def run(k):
            state["w"] = SP.run_chunk_spatial(cfg, state["w"], k, sm)
        with path_env(False):
            run(R)
            _sync(sm)
            dist.barrier(group=sm.group)
            st0 = dict(state["w"].slab.stats)
            t0 = time.perf_counter()
            run(ticks)
            _sync(sm)
            wall = time.perf_counter() - t0
            st1 = dict(state["w"].slab.stats)
            dist.barrier(group=sm.group)
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as p:
                t1 = time.perf_counter()
                run(profile)
                _sync(sm)
                pwall = time.perf_counter() - t1
            dist.barrier(group=sm.group)
        busy = sum(e.self_device_time_total for e in p.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3 / profile
        out[label] = {
            "rank": sm.rank, "wall_s": wall, "ticks": ticks,
            "busy_ms_per_tick": busy,
            "profiled_wall_ms_per_tick": pwall * 1e3 / profile,
            "idle_share": 1 - busy / (pwall * 1e3 / profile),
            "collectives_per_tick": (st1["all_reduce"] - st0["all_reduce"])
            / ticks,
            "collective_host_ms_per_tick": (st1["host_s"] - st0["host_s"])
            * 1e3 / ticks,
            "collective_bytes_per_tick": (st1["bytes"] - st0["bytes"])
            / ticks}
        del state
        if sm.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


JOBS = {"cities": cities, "rollouts": rollouts, "scaling": scaling,
        "dryrun": dryrun_rank, "spatial": spatial,
        "spatial_scaling": spatial_scaling}


def run_jobs(mesh: M.Mesh, jobs: list) -> list:
    """Every job of `jobs` in order (see the module docstring); this
    rank's results."""
    out = []
    for job in jobs:
        job = dict(job)
        kind, n = job.pop("kind"), job.pop("ranks", None)
        t0 = time.time()
        sub = mesh if n in (None, mesh.size) else M.make_mesh(
            n, mesh.axis, mesh.device)
        res = None if sub is None else JOBS[kind](sub, **job)
        out.append(None if res is None else dict(
            res, started_at=t0, job_s=time.time() - t0))
    return out
