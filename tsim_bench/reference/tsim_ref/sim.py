# Frozen copy of trafficsimulation_tpu_torch/sim.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
"""Top-level simulation: world init and the plane-engine tick runner
(the JAX package's `sim.py`; its module docstring gives the tick order).

`init_world` generates a world from a key (`gen/generate.py`, demand
from `agents/demand.py`) on a device; `measure_and_shrink` cuts its
padded capacities; `inject_vehicles` is the JAX bench's synthetic load.
The copy keeps what the benchmark's cells run: the FSM light
controllers, no pedestrians, no hierarchical routing.

`run_chunk` advances a world n ticks: it packs the vehicle pool onto the
planes once, rebuilds the routing planes at the chunk start and then
once per PATHFINDING_COOLDOWN ticks, compacts the free pool slots once
per segment, and runs `engine.step_engine` per tick.  Under the
megakernel gate (`ops/megakernel.mega_ok`: TSIM_MEGA_FORCE on the card,
TSIM_MEGA_INTERPRET on either device) each routing segment is one plain
K9 segment instead (`megakernel.run_segment_mega`, with K9's JAX
quirks).  The whole chunk's random draws come from JAX's key chain
walked on the host up front (`engine.tick_chain`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import prng
from .config import Config

from .agents import demand as demand_mod
from .agents.blocks import init_blocks_state
from .agents.rain import init_rain_state
from .core.state import (BlockStatic, DestStatic, Grid, GroupStatic,
                         LightStatic, Metrics, Overrides, Pedestrians,
                         Vehicles, World,
                         sidewalk_count)
from .gen.generate import (city_cost_field, city_draws, city_from_draws,
                           draws_to)
from .lights import fsm
from .ops import engine, megakernel

KBIG = engine.KBIG


def init_vehicles(V: int, device) -> Vehicles:
    def z(dtype, fill=0):
        return torch.full((V,), fill, dtype=dtype, device=device)
    i32, b = torch.int32, torch.bool
    return Vehicles(
        active=z(b), pos=z(i32, -1), heading=z(i32, -1), dest=z(i32, -1),
        base_speed=z(i32), current_speed=z(i32), stuck_ticks=z(i32),
        is_stuck=z(b), stranded_ticks=z(i32), parked=z(b),
        in_collision=z(b), in_malfunction=z(b), contraflow_ticks=z(i32),
        contraflow_key=z(i32), contraflow_steps=z(i32), detour=z(b),
        kind=z(torch.uint8), depart_time=z(torch.float32),
        steps_traveled=z(i32), service_phase=z(torch.uint8),
        load=z(torch.float32), service_timer=z(i32),
        service_block=z(i32, -1))


def init_metrics(device) -> Metrics:
    def z(dtype=torch.int32):
        return torch.zeros((), dtype=dtype, device=device)
    return Metrics(
        created_internal=z(), created_through=z(), created_service=z(),
        completed_internal=z(), completed_through=z(),
        completed_service=z(), errored_internal=z(), errored_through=z(),
        sum_duration_internal=z(torch.float32),
        sum_duration_through=z(torch.float32),
        sum_steps_internal=z(), sum_steps_through=z(),
        collisions_total=z(), malfunctions_total=z(), daily_created=z(),
        daily_finished=z(), last_daily_difference=z(), daily_diff_sum=z(),
        days_completed=z(), day=z())


def _nearest_exit_table(cfg: Config, dests, DF: int,
                        rid: torch.Tensor = None) -> torch.Tensor:
    """Per destination the nearest valid highway-exit destination
    (Manhattan; the first on ties) among the first DF; its routing id
    under hierarchical routing."""
    W = cfg.WIDTH
    dev = dests.pos.device
    exit_ok = dests.valid & (dests.kind == 1) & (
        torch.arange(dests.valid.shape[0], device=dev) < DF)
    px, py = dests.pos % W, torch.div(dests.pos, W, rounding_mode="floor")
    t = []
    for r0 in range(0, px.shape[0], 4096):        # [4096, D] at a time
        man = (px[r0:r0 + 4096, None] - px[None, :]).abs() \
            + (py[r0:r0 + 4096, None] - py[None, :]).abs()
        t.append(torch.argmin(torch.where(exit_ok[None, :], man, 2**30),
                              dim=1))
    t = torch.cat(t).to(torch.int32)
    return t if rid is None else rid[t.long()]


@functools.cache
def trip_layout_cached(cfg: Config):
    return demand_mod.trip_layout(cfg)


def _key_array(key) -> np.ndarray:
    return np.asarray(key, np.uint32).reshape(2)


def init_world(cfg: Config, key, device="cuda") -> World:
    """Generate a world from `key` (uint32 [2], `prng.PRNGKey`) on
    `device`: the city, its key stack of the first MAX_FIELD_DESTS
    destinations, DEMAND_PREGEN_DAYS days of demand and empty dynamic
    state (the JAX `init_world`)."""
    _covered(cfg)
    dev = torch.device(device)
    key = _key_array(key)
    city_d, day_d = _world_draws(cfg, key)
    city = city_from_draws(cfg, draws_to(city_d, dev))
    field = engine.field_to_keys(cfg, city_cost_field(cfg, city[0], city[4]),
                                 city[0].road_class)
    return _assemble(cfg, city, field, draws_to(day_d, dev),
                     _key_tensor(key, dev))


def _covered(cfg: Config) -> None:
    """The copy covers FSM light controllers, no pedestrians and no
    hierarchical routing (what the benchmark's cells run)."""
    if (cfg.ROUTING_HIER or cfg.PEDESTRIANS_ENABLED
            or cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM not in fsm.FSM_ALGOS):
        raise ValueError("the reference covers FSM light controllers "
                         "without pedestrians or hierarchical routing")


def _no_pedestrians(device) -> Pedestrians:
    """The [4, 1, 1] stub the JAX package carries with pedestrians off."""
    z = torch.zeros((4, 1, 1), dtype=torch.int32, device=device)
    return Pedestrians(walk=z, cross=z.clone())


def _world_draws(cfg: Config, key: np.ndarray):
    """The host part of `init_world`: the city's draws (`city_draws`)
    and the demand days' (`demand.days_draws`), numpy; for a stack of
    keys [B, 2] every world's, side by side."""
    kgen, kday = np.moveaxis(prng.split(key, 2), -2, 0)
    return (city_draws(cfg, kgen),
            demand_mod.days_draws(cfg, trip_layout_cached(cfg), kday, 0,
                                  cfg.DEMAND_PREGEN_DAYS))


def _assemble(cfg: Config, city, field, day_draws: dict,
              key: torch.Tensor) -> World:
    """The world of `init_world` from its city, key stack, demand draws
    and key: the demand tables, the nearest-exit table and empty dynamic
    state.  A function of tensors, which runs under vmap."""
    grid, ls, gs, bs, dests = city
    dev = key.device
    caps = cfg.capacities()
    H, W = cfg.HEIGHT, cfg.WIDTH
    DF = field.shape[-4]
    dem = demand_mod.generate_days(
        cfg, trip_layout_cached(cfg), day_draws, 0, cfg.DEMAND_PREGEN_DAYS,
        -1, bs.valid, bs.btype, bs.dest, bs.entrance, dests.valid,
        dests.kind, dests.hw_pos, dests.hw_valid, DF)
    return World(
        grid=grid.replace(n_side=sidewalk_count(grid.cell_type)),
        lights_static=ls, groups_static=gs, blocks_static=bs,
        dests=dests, cost_field=field,
        nearest_exit=_nearest_exit_table(cfg, dests, DF),
        veh_map=torch.full((H, W), -1, dtype=torch.int32, device=dev),
        stop_map=torch.zeros((H, W), dtype=torch.bool, device=dev),
        rain_map=torch.zeros((H, W), dtype=torch.bool, device=dev),
        stuck_map=torch.zeros((H, W), dtype=torch.int32, device=dev),
        density=torch.zeros((H, W), dtype=torch.float32, device=dev),
        vehicles=init_vehicles(caps.max_vehicles, dev),
        lights=fsm.init_lights_state(cfg, caps.max_groups, caps.max_lights,
                                     gs.valid),
        blocks=init_blocks_state(bs),
        rain=init_rain_state(cfg, dev),
        demand=dem,
        metrics=init_metrics(dev),
        peds=_no_pedestrians(dev),
        ped_map=torch.zeros((H, W), dtype=torch.int32, device=dev),
        overrides=Overrides(
            light_force=torch.full((caps.max_lights,), -1, dtype=torch.int8,
                                   device=dev),
            spawn_rain=torch.zeros((), dtype=torch.bool, device=dev)),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
        elapsed=torch.zeros((), dtype=torch.float32, device=dev),
        key=key)


_CITY_TYPES = (Grid, LightStatic, GroupStatic, BlockStatic, DestStatic)


def _pow2(n: int, lo: int = 8) -> int:
    """A measured size rounded up to a padded capacity: the next power of
    two up to 256, else the next multiple of 64."""
    n = max(int(n), lo)
    if n <= 256:
        return 1 << (n - 1).bit_length()
    return ((n + 63) // 64) * 64


def _count(t: torch.Tensor) -> int:
    return int(t.sum())


def measure_and_shrink(cfg: Config, world: World):
    """(cfg2, world2): capacities measured from this world's tables
    (rounded by `_pow2`) and every padded table sliced to them (the JAX
    `measure_and_shrink`).  Valid for this world only."""
    ls, gs, bs, dests = (world.lights_static, world.groups_static,
                         world.blocks_static, world.dests)
    caps = cfg.capacities()
    g = world.grid
    n_queue = min(_pow2(_count(gs.queue_qgroup >= 0) + 1),
                  gs.queue_cells.shape[0])
    n_runs = min(_pow2(_count(gs.run_seg >= 0) + 1), gs.run_seg.shape[0])
    n_lights = min(_pow2(_count(ls.valid) + 1), caps.max_lights)
    n_assign = min(_pow2(_count(ls.assign_valid) + 1),
                   ls.assign_valid.shape[0])
    n_sruns = min(_pow2(_count(ls.srun_light >= 0) + 1),
                  ls.srun_light.shape[0])
    n_groups = min(_pow2(max(int(g.group_id.max()), int(g.queue_group.max()),
                             int(ls.group.max())) + 2), caps.max_groups)
    n_blocks = min(_pow2(int(g.block_id.max()) + 2), caps.max_blocks)
    n_valid_dests = _count(dests.valid)
    n_dests = min(_pow2(n_valid_dests + 1), dests.valid.shape[0])
    n_exits = min(_pow2(_count(dests.hw_valid) + 1),
                  dests.hw_valid.shape[0])
    DF = min(world.cost_field.shape[0],
             max(32, (n_valid_dests + 32) // 32 * 32))
    cfg2 = cfg.replace(CAP_OVERRIDES=(
        ("max_lights", n_lights), ("max_groups", n_groups),
        ("max_blocks", n_blocks), ("max_dests", n_dests),
        ("max_exits", n_exits), ("max_entrances_hw", n_exits),
        ("max_queue_cells", n_queue)), MAX_FIELD_DESTS=DF)

    def cut(obj, n, names=None):
        names = names or [f.name for f in dataclasses.fields(obj)]
        return obj.replace(**{k: getattr(obj, k)[:n] for k in names})

    lights = world.lights
    group_fields = [f.name for f in dataclasses.fields(lights)
                    if f.name != "light_stop"]
    world2 = world.replace(
        lights_static=cut(cut(cut(ls, n_lights, ["valid", "pos", "group",
                                                 "axis"]),
                              n_assign, ["assign_road", "assign_light",
                                         "assign_valid", "sextra_cell",
                                         "sextra_light"]),
                          n_sruns, ["srun_lo", "srun_hi", "srun_light"]),
        groups_static=cut(cut(cut(gs, n_groups, [
            "valid", "neighbor", "intermediates", "bbox",
            "intersection_size", "penalty_score"]), n_queue, [
            "queue_cells", "queue_qgroup", "queue_qbucket"]), n_runs,
            ["run_lo", "run_hi", "run_seg"]),
        blocks_static=cut(bs, n_blocks),
        dests=cut(cut(dests, n_dests, ["valid", "pos", "kind", "block"]),
                  n_exits, ["hw_pos", "hw_valid"]),
        cost_field=world.cost_field[:DF],
        nearest_exit=world.nearest_exit[:n_dests],
        lights=cut(cut(lights, n_lights, ["light_stop"]), n_groups,
                   group_fields),
        blocks=cut(world.blocks, n_blocks),
        overrides=world.overrides.replace(
            light_force=world.overrides.light_force[:n_lights]))
    return cfg2, world2


def inject_vehicles(cfg: Config, world: World, n: int) -> World:
    """The JAX bench's synthetic load (`bench.inject_vehicles` with its
    default seed 0): n vehicles on random free road cells from which some
    field row is reachable, with random valid destinations, drawn by
    numpy exactly as the bench draws them.  The reach mask is reduced on
    the device; one bool plane comes back."""
    rng = np.random.default_rng(0)
    H, W = world.grid.is_road.shape
    K = world.cost_field
    dvalid = world.dests.valid.cpu().numpy()
    if world.dests.rid is not None:
        dids = np.nonzero(dvalid)[0]
        rid = world.dests.rid.cpu().numpy()
        best = torch.full((H, W), KBIG << 2, dtype=torch.int32,
                          device=K.device)
        for r0 in range(0, K.shape[0], 16):
            best = torch.minimum(best, K[r0:r0 + 16].amin(dim=(0, 1)))
    else:
        dids = np.nonzero(dvalid[:K.shape[0]])[0]
        rid = np.arange(dvalid.shape[0])
        best = K[int(dids[0])].amin(dim=0)
    reach = ((best >> 2) < KBIG).reshape(-1).cpu().numpy()
    road = world.grid.is_road.reshape(-1).cpu().numpy()
    occ_ok = world.veh_map.reshape(-1).cpu().numpy() < 0
    cells = np.nonzero(reach & road & occ_ok)[0]
    n = min(n, len(cells), world.vehicles.active.shape[0])
    pos = rng.choice(cells, size=n, replace=False).astype(np.int32)
    dest = rid[dids[rng.integers(0, len(dids), size=n)]].astype(np.int32)

    dev = world.vehicles.active.device
    v = world.vehicles

    def put(t, vals):
        t = t.clone()
        t[:n] = torch.as_tensor(vals, dtype=t.dtype, device=dev)
        return t
    pos_t = torch.from_numpy(pos).to(dev)
    v = v.replace(active=put(v.active, True), pos=put(v.pos, pos_t),
                  dest=put(v.dest, torch.from_numpy(dest)),
                  heading=put(v.heading, -1), kind=put(v.kind, 0))
    vm = world.veh_map.reshape(-1).clone()
    vm[pos_t.long()] = torch.arange(n, dtype=torch.int32, device=dev)
    return world.replace(vehicles=v, veh_map=vm.reshape(H, W))


def _enter_engine(cfg: Config, world: World) -> engine.EngineState:
    """Pack the SoA world into the plane-engine state."""
    H, W = cfg.HEIGHT, cfg.WIDTH
    planes, slot_used = engine.vehicles_to_planes(cfg, world.vehicles, H, W)
    pa, pb, pc, pd, pe, pl = planes
    return engine.EngineState(
        pa=pa, pb=pb, pc=pc, pd=pd, pe=pe, pl=pl, slot_used=slot_used,
        stop_map=world.stop_map, rain_map=world.rain_map,
        density=world.density, ped_map=world.ped_map,
        lights=world.lights, blocks=world.blocks, rain=world.rain,
        dem_cursor=world.demand.cursor, metrics=world.metrics,
        overrides=world.overrides, peds=world.peds,
        tick=world.tick, elapsed=world.elapsed, key=world.key, rl=world.rl)


def _exit_engine(cfg: Config, world: World, es) -> World:
    """Unpack the plane-engine state into the SoA world."""
    V = cfg.capacities().max_vehicles
    planes = (es.pa, es.pb, es.pc, es.pd, es.pe, es.pl)
    vehicles = engine.planes_to_vehicles(cfg, planes, V)
    veh_map, stuck_map = engine.planes_to_maps(planes, V)
    return world.replace(
        vehicles=vehicles, veh_map=veh_map, stuck_map=stuck_map,
        stop_map=es.stop_map, rain_map=es.rain_map, density=es.density,
        ped_map=es.ped_map, peds=es.peds,
        lights=es.lights, blocks=es.blocks, rain=es.rain,
        demand=world.demand.replace(cursor=es.dem_cursor),
        metrics=es.metrics, overrides=es.overrides,
        tick=es.tick, elapsed=es.elapsed, key=es.key, rl=es.rl)


def _key_np(key: torch.Tensor) -> np.ndarray:
    return key.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def _key_tensor(key: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key, np.uint32).view(np.int32)
                            .copy()).to(device)


def _chain(cfg: Config, world: World, n: int):
    """(draws int64 [n, N_DRAWS] numpy, the key after n ticks): the key
    chain walked on the host (`engine.tick_chain`)."""
    _covered(cfg)
    draws, _, key = engine.tick_chain(cfg, _key_np(world.key), n)
    return draws, key


def run_chunk(cfg: Config, world: World, n: int) -> World:
    """Advance n ticks (the JAX `run_chunk`)."""
    if world.cost_field is None:
        raise ValueError("world.cost_field is not built")
    dev = world.grid.is_road.device
    draws_np, key = _chain(cfg, world, n)
    end = advance(cfg, world, n, torch.from_numpy(draws_np).to(dev))
    return end.replace(key=_key_tensor(key, dev))


def advance(cfg: Config, world: World, n: int, draws: torch.Tensor) -> World:
    """The device part of `run_chunk`: n ticks with this chunk's draws
    (int64 [n, N_DRAWS], `engine.tick_chain`); the key is left as it
    was."""
    dev = world.grid.is_road.device
    es = _enter_engine(cfg, world)
    R = max(1, cfg.PATHFINDING_COOLDOWN) if cfg.PATHFINDING_CACHE else 1
    if megakernel.mega_ok(cfg, world):
        # one K9 segment per routing segment (the JAX `run_chunk` branch)
        cs = megakernel.build_chunk_static(cfg, world)
        for t in range(0, n, R):
            length = min(R, n - t)
            es = megakernel.run_segment_mega(
                cfg, world, es, cs, engine.routing_planes(cfg, world, es),
                length, draws[t:t + length])
        return _exit_engine(cfg, world, es)
    S = cfg.capacities().max_spawns_per_tick
    sidx = torch.arange(S, device=dev)

    def seg(e, t0, length):
        sdir = engine.routing_planes(cfg, world, e)
        # one free-slot compaction per segment: a cursor advances by each
        # tick's consumed trips, so ticks share the list without
        # collisions; S extra -1 entries keep the slice in bounds
        slots0 = engine.free_slots(e.slot_used, (length + 1) * S)
        cur = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(length):
            sl = slots0[(cur + sidx).long()]
            e2 = engine.step_engine(
                cfg, world, e, draws[t0 + i], sdir=sdir, spawn_slots=sl)
            cur = cur + (e2.dem_cursor - e.dem_cursor)
            e = e2
        return e

    t = 0
    while t < n:
        length = min(R, n - t)
        es = seg(es, t, length)
        t += length
    return _exit_engine(cfg, world, es)
