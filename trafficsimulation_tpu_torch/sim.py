"""Top-level simulation: world init, the plane-engine scan runner and the
host-side `TrafficSim` (the JAX package's `sim.py`; its module docstring
gives the tick order).

`init_world` generates a world from a key (`gen/generate.py`, demand
from `agents/demand.py`) on a device; `init_world_hier` builds the
hierarchical-routing world of a `ROUTING_HIER` config (`gen/hier.py`,
`ops/hier.py`).  `inject_vehicles` is the JAX bench's synthetic load.

`run_chunk` advances a world n ticks: it packs the vehicle pool onto the
planes once, rebuilds the routing planes (K2, K3) at the chunk start and
then once per PATHFINDING_COOLDOWN ticks, compacts the free pool slots
once per segment, and runs `engine.step_engine` per tick (K4 inside the
light reductions, K1 for decide + move, or the plain core with K6 under
hierarchical routing).  Under the megakernel gate (`ops/megakernel.
mega_ok`: TSIM_MEGA_FORCE on the card, TSIM_MEGA_INTERPRET on either
device) each routing segment is one K9 call instead
(`megakernel.run_segment_mega`).  The whole chunk's random draws come
from JAX's key chain walked on the host up front (`tick_draws`), so no
tick waits for the host.  `advance` is the device part of the chunk, and
`step_device` that of `step_world`, functions of tensors only: the world
batches of `parallel/mesh.py` run them under `torch.func.vmap`.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings

import numpy as np
import torch

from . import prng
from .config import Config

from .agents import demand as demand_mod
from .agents.blocks import init_blocks_state
from .agents.pedestrians import init_pedestrians
from .agents.rain import init_rain_state
from .core.state import (BlockStatic, DestStatic, Grid, GroupStatic,
                         LightStatic, Metrics, Overrides, Vehicles, World,
                         sidewalk_count)
from .core.transfer import world_from_leaves, world_leaves
from .gen import hier as ghier
from .gen.generate import (city_cost_field, city_draws, city_from_draws,
                           draws_to)
from .lights import fsm
from .ops import engine, megakernel
from .ops.hier import RID_SPACE
from .rl import controllers as rl_mod

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
    if cfg.ROUTING_HIER:
        raise ValueError("cfg.ROUTING_HIER worlds are host-orchestrated: "
                         "use init_world_hier(cfg, key)")
    dev = torch.device(device)
    key = _key_array(key)
    city_d, day_d = _world_draws(cfg, key)
    city = city_from_draws(cfg, draws_to(city_d, dev))
    field = engine.field_to_keys(cfg, city_cost_field(cfg, city[0], city[4]),
                                 city[0].road_class)
    world = _assemble(cfg, city, field, draws_to(day_d, dev),
                      _key_tensor(key, dev))
    # the RL controller's train state from the world key (None for FSM)
    return world.replace(rl=rl_mod.init_rl_state(
        cfg, cfg.capacities().max_groups, key, dev))


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
        peds=init_pedestrians(H, W, cfg.PEDESTRIANS_ENABLED, dev),
        ped_map=torch.zeros((H, W), dtype=torch.int32, device=dev),
        overrides=Overrides(
            light_force=torch.full((caps.max_lights,), -1, dtype=torch.int8,
                                   device=dev),
            spawn_rain=torch.zeros((), dtype=torch.bool, device=dev)),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
        elapsed=torch.zeros((), dtype=torch.float32, device=dev),
        key=key)


def init_worlds(cfg: Config, keys, device="cuda", timings=None) -> World:
    """A batch of B worlds from keys uint32 [B, 2], every leaf with a
    leading B: world b equals `init_world(cfg, keys[b], device)`, bit
    for bit.  The host draws of all worlds are taken side by side (numpy
    over the key stack); each device stage runs once for the whole
    batch: the city's planes and tables and the demand and empty state
    under `torch.func.vmap`, the cost fields and the key stack with a
    leading world dim.  `timings`:
    a dict that receives the seconds of each stage (`draws`, `city`,
    `cost_field`, `key_stack`, `demand_state`) and their sum
    `generate_all_sec`."""
    if cfg.ROUTING_HIER:
        raise ValueError("cfg.ROUTING_HIER worlds are host-orchestrated: "
                         "use init_world_hier(cfg, key)")
    dev = torch.device(device)
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    t0 = t = time.perf_counter()
    city_d, day_d = (draws_to(d, dev) for d in _world_draws(cfg, keys))
    key_t = _key_tensor(keys, dev)
    t = _stage(timings, "draws", t)
    city_l = torch.func.vmap(lambda d: [_fields(x) for x in city_from_draws(
        cfg, d)])(city_d)
    city = _city(city_l)
    t = _stage(timings, "city", t)
    field = city_cost_field(cfg, city[0], city[4])
    t = _stage(timings, "cost_field", t)
    field = engine.field_to_keys(cfg, field, city[0].road_class)
    t = _stage(timings, "key_stack", t)

    def rest(city_l, field, day_d, key):
        return world_leaves(_assemble(cfg, _city(city_l), field, day_d, key))
    leaves = torch.func.vmap(rest)(city_l, field, day_d, key_t)
    world = world_from_leaves({k: v.contiguous() for k, v in leaves.items()})
    # each world's RL train state from its own key (None for FSM)
    world = world.replace(rl=rl_mod.init_rl_state(
        cfg, cfg.capacities().max_groups, keys, dev))
    t = _stage(timings, "demand_state", t)
    if timings is not None:
        timings["generate_all_sec"] = t - t0
    return world


def _fields(x) -> dict:
    """A flat struct's tensors by field name (None fields left out)."""
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)
            if getattr(x, f.name) is not None}


_CITY_TYPES = (Grid, LightStatic, GroupStatic, BlockStatic, DestStatic)


def _city(dicts):
    """`city_from_draws`' structs from their `_fields` dicts."""
    return [cls(**{f.name: d.get(f.name) for f in dataclasses.fields(cls)})
            for cls, d in zip(_CITY_TYPES, dicts)]


def _stage(timings, name, t0):
    """Record a set-up stage's seconds (device work included)."""
    if timings is not None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        timings[name] = time.perf_counter() - t0
    return time.perf_counter()


def init_world_hier(cfg: Config, key, device="cuda", timings=None):
    """The world of a `ROUTING_HIER` config (the JAX `init_world_hier`):
    generate and shrink a base world (a 4-row throwaway field), assign
    routing ids on the host, remap every plane-facing id to its rid,
    build the dense hub / direct key rows and the windowed static stack
    on the device, regenerate demand against the rids, and the
    nearest-exit table in rid space.  Returns (shrunk cfg, world).
    `timings`: a dict that receives the seconds of each stage."""
    assert cfg.ROUTING_HIER
    key = _key_array(key)
    t = time.perf_counter()
    cfg_gen = dataclasses.replace(cfg, ROUTING_HIER=False, MAX_FIELD_DESTS=4)
    world = init_world(cfg_gen, key, device)
    t = _stage(timings, "generate", t)
    cfg2, world = measure_and_shrink(cfg_gen, world)
    grid, bs, dests = world.grid, world.blocks_static, world.dests
    dev = grid.cell_type.device
    pos = dests.pos.cpu().numpy()
    assign = ghier.assign_hier_np(cfg, pos, dests.valid.cpu().numpy(),
                                  dests.kind.cpu().numpy())
    tabs = ghier.hier_tables_np(cfg, assign, pos, cfg.HEIGHT, cfg.WIDTH)
    tabs = {k: torch.from_numpy(v).to(dev) for k, v in tabs.items()}
    rid = torch.from_numpy(assign["rid"]).to(dev)
    D = rid.shape[0]
    lut = torch.cat([rid, torch.full((1,), -1, dtype=torch.int32,
                                     device=dev)])

    def remap(a):
        return torch.where(a >= 0, lut[a.clamp(0, D).long()], -1)

    grid = grid.replace(dest_id=remap(grid.dest_id))
    bs = bs.replace(dest=remap(bs.dest), service_dest=remap(bs.service_dest))
    dests = dests.replace(rid=rid)
    cfg3 = dataclasses.replace(cfg2, ROUTING_HIER=True,
                               HIER_TILE=cfg.HIER_TILE,
                               HIER_LMAX=cfg.HIER_LMAX,
                               MAX_FIELD_DESTS=int(tabs["dense_pos"].shape[0]))
    t = _stage(timings, "shrink_and_assign", t)
    field = ghier.build_dense_keys(cfg3, grid, tabs["dense_pos"],
                                   tabs["dense_valid"])
    t = _stage(timings, "dense_keys", t)
    local4 = ghier.build_local_stack(cfg3, grid, tabs["tile_dest_wpos"],
                                     tabs["tile_dest_valid"],
                                     tabs["tile_coords"])
    t = _stage(timings, "local_stack", t)
    _, kday = prng.split(key, 2)
    dem = demand_mod.generate_days(
        cfg3, trip_layout_cached(cfg3), kday, 0, cfg.DEMAND_PREGEN_DAYS, -1,
        bs.valid, bs.btype, bs.dest, bs.entrance, dests.valid, dests.kind,
        dests.hw_pos, dests.hw_valid, RID_SPACE, dest_rid=rid)
    world = world.replace(
        grid=grid, blocks_static=bs, dests=dests, cost_field=field,
        local_sdir4=local4,
        nearest_exit=_nearest_exit_table(cfg3, dests, RID_SPACE, rid=rid),
        demand=dem, metrics=init_metrics(dev))
    _stage(timings, "demand", t)
    return cfg3, world


def _pow2(n: int, lo: int = 8) -> int:
    """A measured size rounded up to a padded capacity: the next power of
    two up to 256, else the next multiple of 64."""
    n = max(int(n), lo)
    if n <= 256:
        return 1 << (n - 1).bit_length()
    return ((n + 63) // 64) * 64


def _count(t: torch.Tensor) -> int:
    return int(t.sum())


def assert_world_fits(cfg: Config, world: World) -> None:
    """Raise when a padded table of a world (or a batch of worlds) is
    completely full, the signature of truncation under shrunk
    capacities; warn when the valid destinations reach the field's row
    count (the JAX `assert_world_fits`)."""
    sat = []
    for name, arr in (("max_lights", world.lights_static.valid),
                      ("max_groups", world.groups_static.valid),
                      ("max_blocks", world.blocks_static.valid),
                      ("max_dests", world.dests.valid),
                      ("max_exits", world.dests.hw_valid)):
        if bool(arr.reshape(-1, arr.shape[-1]).all(dim=-1).any()):
            sat.append(name)
    D_field = world.cost_field.shape[-4]
    dv = world.dests.valid
    n_valid = dv.reshape(-1, dv.shape[-1]).sum(dim=-1)
    if world.local_sdir4 is None and bool((n_valid >= D_field).any()):
        warnings.warn(
            f"MAX_FIELD_DESTS partial coverage: {D_field} field rows, "
            f"world has >= {int(n_valid.max())} valid dests: destinations "
            "beyond the cap route via exit fallback and internal demand "
            "to them is resampled (blocks_unroutable_no_field counts "
            "them)", RuntimeWarning, stacklevel=2)
    if sat:
        raise RuntimeError(
            f"capacity table(s) saturated for this world: {sat}: the "
            "config's CAP_OVERRIDES are too small for this seed; "
            "regenerate with default caps or re-measure per world")


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
            light_force=world.overrides.light_force[:n_lights]),
        rl=None if world.rl is None else rl_mod.init_rl_state(
            cfg2, n_groups, _key_np(world.key), world.key.device))
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
    """(draws int64 [n, N_DRAWS] numpy, the ticks' RL plan or None, the
    key after n ticks): the key chain walked on the host
    (`engine.tick_chain`) and, under an RL controller, its plan
    (`rl/controllers.plan_ticks`: one read of its counters).  For a
    batch (`world.key` [B, 2]) every world's, with a leading B."""
    draws, rl_keys, key = engine.tick_chain(cfg, _key_np(world.key), n)
    if rl_keys is None:
        return draws, None, key
    if world.rl is None:
        raise ValueError(f"{cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM}: the world "
                         "has no RL train state (build it with this config)")
    return draws, rl_mod.plan_ticks(cfg, world.rl, world.groups_static.valid,
                                    rl_keys), key


def step_world(cfg: Config, world: World) -> World:
    """One tick: the key walked on the host (`engine.tick_chain`), then
    `step_device`."""
    dev = world.grid.is_road.device
    draws, plan, key = _chain(cfg, world, 1)
    end = step_device(cfg, world, torch.from_numpy(draws[0]).to(dev),
                      None if plan is None else plan.tick(0))
    return end.replace(key=_key_tensor(key, dev))


def step_device(cfg: Config, world: World, draws: torch.Tensor,
                rl_tick=None) -> World:
    """The device part of `step_world`: routing planes from the current
    state, S free slots, `step_engine` with this tick's draws (int64
    [N_DRAWS]; `rl_tick` the RL controller's inputs) and the SoA
    conversion in and out; the key is left as it was.  A function of
    tensors only, with no host sync, so that it runs under vmap
    (`parallel/mesh.batched_step`)."""
    es = _enter_engine(cfg, world)
    es = engine.step_engine(cfg, world, es, draws, rl_tick=rl_tick)
    return _exit_engine(cfg, world, es)


def reducer_matrices(cfg: Config, world: World):
    """The dense light-reduction matrices (M, A) that pay at this size
    (`fsm.dense_reducer_modes`), built once per chunk from the geometry
    (None where the sparse form stays)."""
    m_ok, a_ok = fsm.dense_reducer_modes(cfg)
    return fsm.build_dense_reducers(cfg, world.grid, world.lights_static,
                                    build_m=m_ok, build_a=a_ok)


def run_chunk(cfg: Config, world: World, n: int,
              dense_reducers: bool = False) -> World:
    """Advance n ticks (the JAX `run_chunk`).  `dense_reducers`: run the
    per-tick light reductions as dense matrix products
    (`fsm.build_dense_reducers`), as the JAX `run_batch_shared` does at
    256^2; the megakernel branch has no use for them."""
    if world.cost_field is None:
        raise ValueError("world.cost_field is not built "
                         "(snapshot.build_field)")
    dev = world.grid.is_road.device
    draws_np, plan, key = _chain(cfg, world, n)
    dense = reducer_matrices(cfg, world) if dense_reducers else None
    end = advance(cfg, world, n, torch.from_numpy(draws_np).to(dev), dense,
                  plan)
    return end.replace(key=_key_tensor(key, dev))


def advance(cfg: Config, world: World, n: int, draws: torch.Tensor,
            dense=None, rl_plan=None) -> World:
    """The device part of `run_chunk`: n ticks with this chunk's draws
    (int64 [n, N_DRAWS], `engine.tick_draws`); the key is left as it
    was.  `dense`: the (M, A) reducer matrices or None.  `rl_plan`: the
    RL controller's inputs of the n ticks (`rl/controllers.plan_ticks`).
    A function of tensors only, with no host sync, so that it runs under
    vmap."""
    dev = world.grid.is_road.device
    es = _enter_engine(cfg, world)
    R = max(1, cfg.PATHFINDING_COOLDOWN) if cfg.PATHFINDING_CACHE else 1
    if megakernel.mega_ok(cfg, world):
        # one K9 launch per routing segment (the JAX `run_chunk` branch)
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
                cfg, world, e, draws[t0 + i], sdir=sdir, spawn_slots=sl,
                dense=dense,
                rl_tick=None if rl_plan is None else rl_plan.tick(t0 + i))
            cur = cur + (e2.dem_cursor - e.dem_cursor)
            e = e2
        return e

    t = 0
    while t < n:
        length = min(R, n - t)
        es = seg(es, t, length)
        t += length
    return _exit_engine(cfg, world, es)


class TrafficSim:
    """Host-side wrapper: `reset`, `step(n)`, `stats()` with the JAX
    `TrafficSim`'s keys, `render()` and the query and spawn API.
    `TrafficSim(cfg, seed=s)` generates its world (`reset`) on `device`;
    `from_world` starts from an existing one."""

    def __init__(self, cfg: Config, world: World = None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.world = world
        if world is None:
            self.reset(cfg, seed, device=device)

    @classmethod
    def from_world(cls, cfg: Config, world: World) -> "TrafficSim":
        return cls(cfg, world)

    def reset(self, cfg: Config = None, seed: int = 0,
              device=None) -> World:
        """Regenerate the world from `seed` and re-measure its padded
        capacities (`measure_and_shrink`), as the JAX `TrafficSim.reset`
        does by default.  `device`: where the world lives (the current
        world's device, else the card)."""
        if cfg is not None:
            self.cfg = cfg
        if device is None:
            device = (self.world.grid.is_road.device
                      if self.world is not None else "cuda")
        self.world = init_world(self.cfg, prng.PRNGKey(seed), device)
        self.cfg, self.world = measure_and_shrink(self.cfg, self.world)
        return self.world

    def step(self, n: int = 1) -> World:
        self._maybe_extend_demand(n)
        self.world = (step_world(self.cfg, self.world) if n == 1
                      else run_chunk(self.cfg, self.world, n))
        return self.world

    def _maybe_extend_demand(self, n: int):
        """Regenerate the trip table when the spawn cursor nears the end
        of its valid prefix or the next n ticks outrun its days (the JAX
        `_maybe_extend_demand`): from the current sim day, with trips
        already past invalid, and a key split off the world's.  The JAX
        sim runs this outside `jit`, so the times are unfused f32."""
        cfg = self.cfg
        w = self.world
        dem = w.demand
        dt = cfg.TIME_PER_STEP_IN_SECONDS
        days_cover = cfg.DEMAND_PREGEN_DAYS * 86400 / dt
        if n >= days_cover:
            raise ValueError(f"step({n}) exceeds the {cfg.DEMAND_PREGEN_DAYS}"
                             "-day pre-generated demand window; raise "
                             "DEMAND_PREGEN_DAYS")
        valid = dem.valid.cpu().numpy()
        n_valid = int(valid.sum())
        S = cfg.capacities().max_spawns_per_tick
        tick_end = int(w.tick) + n
        last_cover = (int(dem.depart_tick.cpu().numpy()[valid].max())
                      if n_valid else -1)
        if int(dem.cursor) < n_valid - 2 * S and last_cover >= tick_end:
            return
        off = (cfg.SIMULATION_STARTING_TIME_OF_DAY_HOURS * 3600
               + cfg.SIMULATION_STARTING_TIME_OF_DAY_MINUTES * 60)
        today = int((off + float(w.elapsed)) // 86400)
        key, kd = prng.split(_key_np(w.key), 2)
        DF = RID_SPACE if w.dests.rid is not None else w.cost_field.shape[0]
        bs, d = w.blocks_static, w.dests
        new = demand_mod.generate_days(
            cfg, trip_layout_cached(cfg), kd, today, cfg.DEMAND_PREGEN_DAYS,
            w.tick, bs.valid, bs.btype, bs.dest, bs.entrance, d.valid,
            d.kind, d.hw_pos, d.hw_valid, DF, dest_rid=d.rid, fused=False)
        self.world = w.replace(demand=new,
                               key=_key_tensor(key, w.key.device))

    # -- reference-parity query API (the JAX `TrafficSim`'s) ---------------
    def get_traffic_lights(self) -> np.ndarray:
        """Flat positions of the valid traffic lights."""
        ls = self.world.lights_static
        return ls.pos[ls.valid].cpu().numpy()

    def num_active_vehicles(self) -> int:
        return int(self.world.vehicles.active.sum())

    def spawn_vehicle(self, origin_flat: int, dest_id: int,
                      kind: int = 0) -> bool:
        """Manual spawn (the bridge's `/create_vehicle` and
        `/create_service_vehicle`): the first free pool slot at
        `origin_flat`, bound for `dest_id`; a service vehicle (kind 2
        food, 3 waste) targets the neediest routable block instead.
        False when the cell is occupied or no slot is free.  Host edits
        of one slot and one `veh_map` cell, on the world's device."""
        w = self.world
        if int(w.veh_map.reshape(-1)[origin_flat]) >= 0:
            return False
        free = torch.nonzero(~w.vehicles.active).reshape(-1)
        if free.numel() == 0:
            return False
        slot = int(free[0])
        sb = -1
        if kind >= 2:
            bs, bst = w.blocks_static, w.blocks
            DF = (RID_SPACE if w.dests.rid is not None
                  else w.cost_field.shape[0])
            sd, ed = bs.service_dest.cpu().numpy(), bs.dest.cpu().numpy()
            tgt = np.where((sd >= 0) & (sd < DF), sd, ed)
            valid = bs.valid.cpu().numpy() & (tgt >= 0) & (tgt < DF)
            if kind == 2:
                urg = bs.food_cap.cpu().numpy() - bst.food.cpu().numpy()
            else:
                urg = bst.waste.cpu().numpy()
            sb = int(np.argmax(np.where(valid, urg, -1)))
            dest_id = int(tgt[sb])
        load = (self.cfg.SERVICE_VEHICLE_MAX_LOAD_FOOD if kind == 2
                else 0.0)
        v = w.vehicles
        edits = dict(active=True, pos=origin_flat, heading=-1, dest=dest_id,
                     base_speed=0, kind=kind, parked=False,
                     depart_time=w.elapsed, steps_traveled=0,
                     service_phase=0, load=load, service_block=sb)
        changed = {}
        for name, val in edits.items():
            t = getattr(v, name).clone()
            t[slot] = val
            changed[name] = t
        veh_map = w.veh_map.clone()
        veh_map.reshape(-1)[origin_flat] = slot
        self.world = w.replace(vehicles=v.replace(**changed),
                               veh_map=veh_map)
        return True

    def render(self) -> torch.Tensor:
        """The RGB framebuffer u8 [H, W, 3] on the world's device
        (`ops/render.render_frame`; no pending-phase overlay, as in
        JAX)."""
        from .ops.render import render_frame
        w = self.world
        return render_frame(w.grid, w.stop_map, w.rain_map, w.veh_map,
                            w.vehicles,
                            pending_mask=torch.zeros_like(w.stop_map),
                            level=self.cfg.AGENT_PORTRAYAL_LEVEL,
                            dummy_overlay=self.cfg.USE_DUMMY_AGENTS)

    def stats(self) -> dict:
        """Dashboard statistics, the keys of the JAX `TrafficSim.stats`."""
        w = self.world
        m = {k: v.item() for k, v in vars(w.metrics).items()}
        v = {k: t.cpu().numpy() for k, t in vars(w.vehicles).items()}
        active, kind = v["active"], v["kind"]
        dt = self.cfg.TIME_PER_STEP_IN_SECONDS
        off = (self.cfg.SIMULATION_STARTING_TIME_OF_DAY_HOURS * 3600
               + self.cfg.SIMULATION_STARTING_TIME_OF_DAY_MINUTES * 60)
        total = off + float(w.elapsed)

        def avg(s, c):
            c = int(c)
            return float(s) / c if c else 0.0

        stuck = active & v["is_stuck"]
        bsv = w.blocks_static.valid.cpu().numpy()
        bsd = w.blocks_static.dest.cpu().numpy()
        lim = (1 << 14) if w.local_sdir4 is not None else w.cost_field.shape[0]
        return {
            "tick": int(w.tick),
            "sim_day": int(total // 86400),
            "sim_time_of_day": "%02d:%02d:%02d" % (
                (total % 86400) // 3600, (total % 3600) // 60, total % 60),
            "seconds_per_tick": dt,
            "live_internal": int((active & (kind == 0)).sum()),
            "live_through": int((active & (kind == 1)).sum()),
            "live_service_food": int((active & (kind == 2)).sum()),
            "live_service_waste": int((active & (kind == 3)).sum()),
            "created_internal": int(m["created_internal"]),
            "created_through": int(m["created_through"]),
            "created_service": int(m["created_service"]),
            "completed_internal": int(m["completed_internal"]),
            "completed_through": int(m["completed_through"]),
            "errored_internal": int(m["errored_internal"]),
            "errored_through": int(m["errored_through"]),
            "avg_duration_internal": avg(m["sum_duration_internal"],
                                         m["completed_internal"]),
            "avg_duration_through": avg(m["sum_duration_through"],
                                        m["completed_through"]),
            "avg_time_per_cell_internal": avg(m["sum_duration_internal"],
                                              m["sum_steps_internal"]),
            "avg_time_per_cell_through": avg(m["sum_duration_through"],
                                             m["sum_steps_through"]),
            **self._live_trip_stats(v, m),
            "avg_daily_difference": avg(m["daily_diff_sum"],
                                        m["days_completed"]),
            "collisions_total": int(m["collisions_total"]),
            "malfunctions_total": int(m["malfunctions_total"]),
            "daily_created": int(m["daily_created"]),
            "daily_finished": int(m["daily_finished"]),
            "last_daily_difference": int(m["last_daily_difference"]),
            "parked": int((active & v["parked"]).sum()),
            "stuck": int(stuck.sum()),
            "overtaking": int((active & ~v["detour"]
                               & (v["contraflow_ticks"] > 0)).sum()),
            "in_stuck_detour": int((active & v["detour"]
                                    & (v["contraflow_ticks"] > 0)).sum()),
            "avg_stuck_duration": avg(v["stuck_ticks"][stuck].sum() * dt,
                                      stuck.sum()),
            "max_stuck_duration": int(v["stuck_ticks"][stuck].max() * dt
                                      if stuck.any() else 0),
            "raining": int(w.rain.active.sum()),
            **self._daily_trip_stats(total),
            "blocks_unroutable_no_field": int(
                (bsv & ((bsd < 0) | (bsd >= lim))).sum()),
        }

    def _live_trip_stats(self, v: dict, m: dict) -> dict:
        """Per-kind live and combined-total trip averages."""
        active, kind = v["active"], v["kind"]
        dur_live = float(self.world.elapsed) - v["depart_time"]
        steps = v["steps_traveled"]
        out = {}
        for k, name in ((0, "internal"), (1, "through")):
            mk = active & (kind == k)
            n_live = int(mk.sum())
            d_live = float(dur_live[mk].sum())
            s_live = int(steps[mk].sum())
            d_comp = float(m[f"sum_duration_{name}"])
            s_comp = int(m[f"sum_steps_{name}"])
            n_comp = int(m[f"completed_{name}"])
            out[f"avg_duration_{name}_live"] = (
                d_live / n_live if n_live else 0.0)
            out[f"avg_time_per_cell_{name}_live"] = (
                d_live / s_live if s_live else 0.0)
            out[f"avg_duration_{name}_total"] = (
                (d_comp + d_live) / (n_comp + n_live)
                if n_comp + n_live else 0.0)
            out[f"avg_time_per_cell_{name}_total"] = (
                (d_comp + d_live) / (s_comp + s_live)
                if s_comp + s_live else 0.0)
        return out

    def _daily_trip_stats(self, total_secs: float) -> dict:
        """Per-kind daily totals, remaining trips, percentage created and
        service ETAs from the trip table."""
        w = self.world
        dem = w.demand
        dt = self.cfg.TIME_PER_STEP_IN_SECONDS
        off = (self.cfg.SIMULATION_STARTING_TIME_OF_DAY_HOURS * 3600
               + self.cfg.SIMULATION_STARTING_TIME_OF_DAY_MINUTES * 60)
        valid = dem.valid.cpu().numpy()
        depart = dem.depart_tick.cpu().numpy()
        kinds = dem.kind.cpu().numpy()
        cur = int(dem.cursor)
        today = int(total_secs // 86400)
        day_of = ((off + depart * dt) // 86400).astype(np.int64)
        in_today = valid & (day_of == today)
        idx = np.arange(len(valid))
        out = {}
        names = {0: "internal", 1: "through", 2: "service_food",
                 3: "service_waste"}
        elapsed = float(w.elapsed)
        for k, name in names.items():
            mk = in_today & (kinds == k)
            total = int(mk.sum())
            created = int((mk & (idx < cur)).sum())
            out[f"daily_total_{name}"] = total
            out[f"daily_created_{name}"] = created
            out[f"remaining_{name}"] = total - created
            out[f"percentage_created_{name}"] = (
                100.0 * created / total if total else 0.0)
            if k >= 2:
                fut = depart[mk & (idx >= cur)] * dt - elapsed
                fut = fut[fut > 0]
                out[f"eta_{name}"] = float(fut.min()) if len(fut) else None
        return out
