"""Top-level simulation: the plane-engine scan runner and the host-side
`TrafficSim` (the JAX package's `sim.py`; its module docstring gives the
tick order).

`run_chunk` advances a world n ticks: it packs the vehicle pool onto the
planes once, rebuilds the routing planes (K2, K3) at the chunk start and
then once per PATHFINDING_COOLDOWN ticks, compacts the free pool slots
once per segment, and runs `engine.step_engine` per tick (K4 inside the
light reductions, K1 for decide + move).  The whole chunk's random draws
come from JAX's key chain walked on the host up front (`tick_draws`), so
no tick waits for the host.  `advance` is the device part of the chunk,
a function of tensors only: `parallel/mesh.run_batch_shared` runs it
under `torch.func.vmap` for a batch of worlds.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Config

from .core.state import Metrics, Vehicles, World
from .lights import fsm
from .ops import engine


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


def step_world(cfg: Config, world: World) -> World:
    """One tick: routing planes from the current state, S free slots,
    `step_engine`, and the SoA conversion in and out."""
    es = _enter_engine(cfg, world)
    draws, key = engine.tick_draws(cfg, _key_np(world.key), 1)
    es = engine.step_engine(cfg, world, es,
                            torch.from_numpy(draws[0]).to(es.pa.device))
    return _exit_engine(cfg, world, es.replace(
        key=_key_tensor(key, es.pa.device)))


def reducer_matrices(cfg: Config, world: World):
    """The dense light-reduction matrices (M, A) that pay at this size
    (`fsm.dense_reducer_modes`), built once per chunk from the geometry
    (None where the sparse form stays)."""
    m_ok, a_ok = fsm.dense_reducer_modes(cfg)
    return fsm.build_dense_reducers(cfg, world.grid, world.lights_static,
                                    build_m=m_ok, build_a=a_ok)


def run_chunk(cfg: Config, world: World, n: int,
              dense_reducers: bool = False) -> World:
    """Advance n ticks (the JAX `run_chunk` without the megakernel
    option).  `dense_reducers`: run the per-tick light reductions as
    dense matrix products (`fsm.build_dense_reducers`), as the JAX
    `run_batch_shared` does at 256^2."""
    if world.cost_field is None:
        raise ValueError("world.cost_field is not built "
                         "(snapshot.build_field)")
    dev = world.grid.is_road.device
    draws_np, key = engine.tick_draws(cfg, _key_np(world.key), n)
    dense = reducer_matrices(cfg, world) if dense_reducers else None
    end = advance(cfg, world, n, torch.from_numpy(draws_np).to(dev), dense)
    return end.replace(key=_key_tensor(key, dev))


def advance(cfg: Config, world: World, n: int, draws: torch.Tensor,
            dense=None) -> World:
    """The device part of `run_chunk`: n ticks with this chunk's draws
    (int64 [n, N_DRAWS], `engine.tick_draws`); the key is left as it
    was.  `dense`: the (M, A) reducer matrices or None.  A function of
    tensors only, with no host sync, so that it runs under vmap."""
    dev = world.grid.is_road.device
    es = _enter_engine(cfg, world)
    R = max(1, cfg.PATHFINDING_COOLDOWN) if cfg.PATHFINDING_CACHE else 1
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
            e2 = engine.step_engine(cfg, world, e, draws[t0 + i], sdir=sdir,
                                    spawn_slots=sl, dense=dense)
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
    """Host-side wrapper: `step(n)` and `stats()` with the JAX
    `TrafficSim`'s keys.  World generation is not ported yet, so a sim
    starts from an existing world (`from_world`, e.g. a snapshot)."""

    def __init__(self, cfg: Config, world: World):
        self.cfg = cfg
        self.world = world

    @classmethod
    def from_world(cls, cfg: Config, world: World) -> "TrafficSim":
        return cls(cfg, world)

    def step(self, n: int = 1) -> World:
        self._check_demand(n)
        self.world = (step_world(self.cfg, self.world) if n == 1
                      else run_chunk(self.cfg, self.world, n))
        return self.world

    def _check_demand(self, n: int):
        """The JAX sim regenerates the trip table when the spawn cursor
        nears the end of its valid prefix or n ticks outrun its days
        (`_maybe_extend_demand`).  Regeneration needs `demand.
        generate_days`, not ported yet, so this raises instead of letting
        spawning stop silently."""
        cfg = self.cfg
        dem = self.world.demand
        days_cover = cfg.DEMAND_PREGEN_DAYS * 86400 / cfg.TIME_PER_STEP_IN_SECONDS
        if n >= days_cover:
            raise ValueError(f"step({n}) exceeds the {cfg.DEMAND_PREGEN_DAYS}"
                             "-day pre-generated demand window")
        valid = dem.valid.cpu().numpy()
        n_valid = int(valid.sum())
        S = cfg.capacities().max_spawns_per_tick
        tick_end = int(self.world.tick) + n
        last_cover = (int(dem.depart_tick.cpu().numpy()[valid].max())
                      if n_valid else -1)
        if int(dem.cursor) < n_valid - 2 * S and last_cover >= tick_end:
            return
        raise NotImplementedError(
            f"the trip table needs regenerating before tick {tick_end} "
            f"(cursor {int(dem.cursor)} of {n_valid} valid trips, last "
            f"departure tick {last_cover}); demand.generate_days is not "
            "ported yet (ROADMAP Queue 1 item 10)")

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
