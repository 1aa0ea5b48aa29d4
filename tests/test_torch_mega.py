"""The port's megakernel path (`ops/megakernel.py`, K9's plain version on
the CPU) against the JAX package and against the port's own per-tick
path.

Against JAX, at 32^2 on `crossroad_world`: `build_chunk_static` (every
run matrix, table and static plane) and `prepare_segment` (seeds, rain,
the spawn schedule) for R = 5, with eager JAX ops only: no JAX compile of
`run_chunk` or of the interpret-mode `run_segment_mega` (the JAX
megakernel is held to the per-tick path by `tests/test_megakernel.py`,
slow tier).  Port against port, torch only: `run_chunk` through the
megakernel branch (TSIM_MEGA_INTERPRET) against the per-tick branch over
two full segments and a partial one, for each FSM light algorithm, on
`tests/test_megakernel.py`'s 64^2 high-demand world.  Integers must be
equal; the f32 duration sums may differ in the last place only through
the summation order (rtol 1e-5, as `tests/test_megakernel.py` allows)."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu.config import Config as JConfig
from trafficsimulation_tpu.core.synth import crossroad_world
from trafficsimulation_tpu import sim as jsim
from trafficsimulation_tpu.ops import megakernel as jmk

from trafficsimulation_tpu_torch import prng, sim as tsim
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core.transfer import (world_from_numpy,
                                                       world_to_numpy)
from trafficsimulation_tpu_torch.lights.fsm import FSM_ALGOS
from trafficsimulation_tpu_torch.ops import engine, megakernel

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_snapshot import world_to_leaves  # noqa: E402

torch.set_num_threads(2)

CROSS = JConfig(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64,
                RAIN_SPAWN_CHANCE=0.5, RAIN_RADIUS_MIN=3, RAIN_RADIUS_MAX=9,
                VEHICLE_MAX_SPEED=2)
# tests/test_megakernel.py's world
MEGA_CFG = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
                MAX_FIELD_DESTS=32, MAX_VEHICLES=256,
                INTERNAL_POPULATION_TRAFFIC_PER_DAY=60000,
                PASSING_POPULATION_TRAFFIC_PER_DAY=20000,
                RAIN_SPAWN_CHANCE=0.2)
FLOAT_CLOSE = ("metrics.sum_duration_internal",
               "metrics.sum_duration_through")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _crossroad(algo: str, late: bool):
    """The crossroad under `algo` (JAX world, port world); `late` moves
    the clock past every trip's departure so the first ticks spawn."""
    cfg = dataclasses.replace(CROSS, TRAFFIC_LIGHT_AGENT_ALGORITHM=algo)
    world = crossroad_world(cfg)
    if late:
        last = int(np.asarray(world.demand.depart_tick).max())
        world = world.replace(tick=jnp.int32(last))
    return cfg, world, world_from_numpy(world_to_leaves(world), "cpu")


@pytest.mark.parametrize("algo", ["QUEUE_ACTUATED",
                                  "NEIGHBOR_PRESSURE_CONTROL"])
def test_chunk_static_matches_jax(algo):
    cfg, jworld, pworld = _crossroad(algo, False)
    ref = jmk.build_chunk_static(cfg, jworld)
    got = megakernel.build_chunk_static(cfg, pworld)
    # the port's light stages gather (lights/fsm.py): JAX's row-form
    # one-hots have no counterpart; every other table is equal
    row_form = {"ogl", "l_hasgrp"} | (
        {"neigh"} if algo == "NEIGHBOR_PRESSURE_CONTROL" else set())
    assert set(ref) - set(got) == row_form
    for k in set(ref) - row_form:
        a, b = np.asarray(ref[k]), got[k]
        assert a.shape == b.shape, (k, a.shape, tuple(b.shape))
        assert np.array_equal(a, _np(b).astype(a.dtype)), k
    # the kernel's light -> group table is JAX's light / group one-hot
    ogl = np.asarray(ref["ogl"]).astype(np.int32)               # [G, L]
    lg = _np(got["l_group"])
    assert np.array_equal(ogl.any(axis=0), lg >= 0)
    assert np.array_equal(ogl.argmax(axis=0)[lg >= 0], lg[lg >= 0])
    # the kernel's rectangles cover the same cells as the run matrices
    H, W = cfg.HEIGHT, cfg.WIDTH
    for name, mats in (("qrun", ("q_rmv", "q_cv", "q_rh", "q_cmh")),
                       ("srun", ("s_rmv", "s_cv", "s_rh", "s_cmh"))):
        tab = _np(got[name])
        rmv, cv, rh, cmh = (_np(got[m]).astype(np.int32) for m in mats)
        if name == "qrun":
            cv, rh = cv.T, rh.T                 # [R, W], [H, R]
        for r, (orient, coord, a0, a1) in enumerate(tab[:, :4]):
            cells = np.zeros((H, W), np.int32)
            if orient == 1:
                cells[a0:a1, coord] = 1
            elif orient == 2:
                cells[coord, a0:a1] = 1
            want = np.outer(rmv[:, r], cv[r]) + np.outer(rh[:, r], cmh[r])
            assert np.array_equal(cells, want), (name, r)


def test_prepare_segment_matches_jax():
    R = 5
    cfg, jworld, pworld = _crossroad("QUEUE_ACTUATED", True)
    jes = jsim._enter_engine(cfg, jworld)
    ref = jmk.prepare_segment(cfg, jworld, jes, R)
    pes = tsim._enter_engine(cfg, pworld)
    draws, key = engine.tick_draws(cfg, tsim._key_np(pworld.key), R)
    got = megakernel.prepare_segment(cfg, pworld, pes, R,
                                     torch.from_numpy(draws))
    assert np.array_equal(key.view(np.int32),
                          np.asarray(ref["final_key"]).view(np.int32))
    for k in ("seeds", "elapsed", "rain_planes", "final_rain_map",
              "spawn_pa", "spawn_pe", "created", "drop_static",
              "final_cursor"):
        a, b = np.asarray(ref[k]), _np(got[k])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        assert np.array_equal(a, b.astype(a.dtype)), k
    for f in dataclasses.fields(ref["final_rain"]):
        assert np.array_equal(np.asarray(getattr(ref["final_rain"], f.name)),
                              _np(getattr(got["final_rain"], f.name))), f.name
    # the schedule placed, deduplicated and ran out of pool slots
    created = np.asarray(ref["created"])
    assert created.sum() > 0
    assert np.asarray(ref["drop_static"]).sum() > 0
    assert np.asarray(ref["rain_planes"]).any()


def _mega_world(algo: str):
    cfg = Config(**MEGA_CFG, TRAFFIC_LIGHT_AGENT_ALGORITHM=algo)
    world = tsim.init_world(cfg, prng.PRNGKey(3), "cpu")
    cfg, world = tsim.measure_and_shrink(cfg, world)
    return cfg, tsim.inject_vehicles(cfg, world, 120)


def _run(monkeypatch, cfg, world, n, mega: bool):
    monkeypatch.delenv("TSIM_NO_MEGAKERNEL", raising=False)
    monkeypatch.delenv("TSIM_MEGA_INTERPRET", raising=False)
    monkeypatch.delenv("TSIM_MEGA_FORCE", raising=False)
    monkeypatch.setenv("TSIM_MEGA_INTERPRET" if mega else
                       "TSIM_NO_MEGAKERNEL", "1")
    assert megakernel.mega_ok(cfg, world) == mega
    return world_to_numpy(tsim.run_chunk(cfg, world, n))


def assert_mega_matches(ref: dict, got: dict):
    bad = []
    for k, a in ref.items():
        b = got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k in FLOAT_CLOSE:
            ok = np.allclose(a, b, rtol=1e-5, atol=0.0)
        elif a.dtype.kind == "f":
            ok = np.array_equal(a.view(np.int32), b.view(np.int32))
        else:
            ok = np.array_equal(a, b)
        if not ok:
            bad.append((k, int((a != b).sum())))
    assert not bad, f"leaves differ (name, entries): {bad}"


@pytest.mark.parametrize("R", [5, 3])
def test_segment_inputs_are_what_the_kernel_takes(R):
    """The segment's inputs as `run_segment_mega` builds them pass K9's
    own check (dtype, shape, contiguity), which only the card's wrapper
    runs on the path."""
    from trafficsimulation_tpu_torch.ops import hopper_engine as HE
    cfg, world = _mega_world("NEIGHBOR_GREEN_WAVE")
    world = tsim.run_chunk(cfg, world, 2)
    es = tsim._enter_engine(cfg, world)
    cs = megakernel.build_chunk_static(cfg, world)
    draws, _ = engine.tick_draws(cfg, tsim._key_np(world.key), R)
    args, _ = megakernel.segment_inputs(
        cfg, world, es, cs, engine.routing_planes(cfg, world, es), R,
        torch.from_numpy(draws))
    dims = HE.check_mega_inputs(args)
    assert dims["R"] == R and dims["D4"] == args["sdir4"].shape[0]
    out = megakernel.segment_plain(cfg, args)
    assert tuple(out) == HE.MEGA_OUTPUTS
    assert out["stats"].shape == (R, megakernel.N_STATS)


@pytest.mark.parametrize("algo", FSM_ALGOS)
def test_megakernel_path_matches_per_tick(monkeypatch, algo):
    cfg, world = _mega_world(algo)
    n = 12                     # two full segments and one of 2 ticks (R = 5)
    ref = _run(monkeypatch, cfg, world, n, mega=False)
    got = _run(monkeypatch, cfg, world, n, mega=True)
    assert_mega_matches(ref, got)
    # the run spawned, moved and completed trips
    assert ref["metrics.created_internal"] + ref["metrics.created_through"] \
        > 0
    assert ref["metrics.completed_internal"] \
        + ref["metrics.completed_through"] > 0
    start = world_to_numpy(world)
    assert not np.array_equal(start["vehicles.pos"], ref["vehicles.pos"])


def _owners_brute(cs, G, H, W, nb):
    """Who owns each light-stage item when block j takes the groups j,
    j + nb, ... with their runs and lights (light l of no group with
    pseudo-group l mod (G + 1); no block takes a run that covers no
    cell: -1), and
    the stop cells that runs of two owners share, from the chunk tables
    alone."""
    qrun, srun = _np(cs["qrun"]), _np(cs["srun"])
    lg = _np(cs["l_group"])
    lgrp = np.where((lg >= 0) & (lg < G), lg, np.arange(len(lg)) % (G + 1))
    q_own = np.where(qrun[:, 0] != 0, qrun[:, 4] % nb, -1)
    l_own = lgrp % nb
    s_ok = srun[:, 0] != 0
    s_own = np.where(s_ok, lgrp[np.clip(srun[:, 4], 0, len(lg) - 1)] % nb,
                     -1)
    seen = {}
    for r in np.nonzero(s_ok)[0]:
        o, coord, a0, a1 = srun[r, :4]
        cells = ([y * W + coord for y in range(a0, min(a1, H))] if o == 1
                 else [coord * W + x for x in range(a0, min(a1, W))])
        for c in cells:
            seen.setdefault(c, set()).add(int(s_own[r]))
    shared = sorted(c for c, v in seen.items() if len(v) > 1)
    return q_own, l_own, s_own, np.array(shared, np.int64)


def _with_shared_stop_run(cs, G):
    """The chunk tables with one more stop run: a copy of a grouped
    light's run, painted by a light of another group (None where the
    world has one group), and the two groups."""
    srun, lg = cs["srun"].clone(), cs["l_group"]
    r0 = next(r for r in range(srun.shape[0])
              if srun[r, 0] != 0 and lg[srun[r, 4]] >= 0)
    g0 = int(lg[srun[r0, 4]])
    l1 = [i for i in range(lg.shape[0]) if lg[i] >= 0 and lg[i] != g0]
    if not l1:
        return None, None
    extra = srun[r0].clone()
    extra[4] = l1[0]
    srun = torch.cat([srun, extra[None]])
    lown = megakernel.light_owner_table(cs["qrun"], srun, lg, G)
    return {**cs, "srun": srun, "lown": lown}, (g0, int(lg[l1[0]]))


@pytest.mark.parametrize("which", ["crossroad", "generated"])
def test_light_owner_table_gives_each_item_one_owner(which):
    """K9's owner table (`light_owner_table`, built with the chunk
    tables): every queue run, light and stop run is listed once, under
    its group (a stop run under its light's), the ungrouped lights spread
    by index, the runs that cover no cell under no block; the
    stop cells that runs of two owners share are the ones `light_owners`
    lists, on the world and on the world with a stop run that two groups
    share."""
    if which == "crossroad":
        cfg, _, world = _crossroad("QUEUE_ACTUATED", False)
    else:
        cfg, world = _mega_world("QUEUE_ACTUATED")
    H, W = cfg.HEIGHT, cfg.WIDTH
    G = world.lights.current_phase.shape[-1]
    cs = megakernel.build_chunk_static(cfg, world)
    cs2, groups = _with_shared_stop_run(cs, G)
    for tables in (cs, cs2):
        if tables is None:
            continue
        NQ, NS = tables["qrun"].shape[0], tables["srun"].shape[0]
        L = tables["l_group"].shape[0]
        assert tables["lown"].dtype == torch.int32
        assert tables["lown"].shape == (3 * (G + 3) + NQ + L + NS,)
        for nb in (1, 2, 3, 7, 64):
            got = megakernel.light_owners(tables["lown"], G, NQ, L, NS,
                                          tables["srun"], H, W, nb)
            q_own, l_own, s_own, shared = _owners_brute(tables, G, H, W, nb)
            for name in ("queue_run", "light", "stop_run"):
                assert (got[name + "_listed"] == 1).all(), name
            assert np.array_equal(got["group"], np.arange(G) % nb)
            assert np.array_equal(got["queue_run"], q_own)
            assert np.array_equal(got["light"], l_own)
            assert np.array_equal(got["stop_run"], s_own)
            assert np.array_equal(got["shared_stop_cells"], shared)
            if tables is cs2 and groups[0] % nb != groups[1] % nb:
                # the copied run's cells are shared by two owners
                o, coord, a0, a1 = _np(tables["srun"][-1, :4])
                c = coord * W + a0 if o == 2 else a0 * W + coord
                assert c in set(got["shared_stop_cells"].tolist())
    assert which == "crossroad" or cs2 is not None


def test_gate_follows_the_jax_rules(monkeypatch):
    """The gate's fallbacks: off without an opt-in, off under
    TSIM_NO_MEGAKERNEL, off for pedestrians, stuck-despawn, hierarchical
    routing and the RL controllers; a CPU world needs the interpret
    opt-in (TSIM_MEGA_FORCE alone asks for the card)."""
    cfg, world = _mega_world("QUEUE_ACTUATED")
    for k in ("TSIM_NO_MEGAKERNEL", "TSIM_MEGA_INTERPRET", "TSIM_MEGA_FORCE"):
        monkeypatch.delenv(k, raising=False)
    assert not megakernel.mega_ok(cfg, world)
    monkeypatch.setenv("TSIM_MEGA_FORCE", "1")
    assert not megakernel.mega_ok(cfg, world)          # the world is on CPU
    monkeypatch.setenv("TSIM_MEGA_INTERPRET", "1")
    assert megakernel.mega_ok(cfg, world)
    for change in (dict(PEDESTRIANS_ENABLED=True),
                   dict(VEHICLE_STUCK_DESPAWN_ENABLED=True),
                   dict(ROUTING_HIER=True),
                   dict(TRAFFIC_LIGHT_AGENT_ALGORITHM="GAT_DQN"),
                   dict(USE_PALLAS_ENGINE=False)):
        assert not megakernel.mega_ok(cfg.replace(**change), world), change
    monkeypatch.setenv("TSIM_NO_MEGAKERNEL", "1")
    assert not megakernel.mega_ok(cfg, world)


def _fold_reference(cfg, m, stats, seg):
    """JAX's tick-by-tick metrics fold (`run_segment_mega`), literally."""
    m = {k: int(v) if v.dtype != torch.float32 else np.float32(v)
         for k, v in vars(m).items()}
    st, c, d = stats.numpy(), seg["created"].numpy(), \
        seg["drop_static"].numpy()
    off = (cfg.SIMULATION_STARTING_TIME_OF_DAY_HOURS * 3600
           + cfg.SIMULATION_STARTING_TIME_OF_DAY_MINUTES * 60)
    S = megakernel
    for t in range(st.shape[0]):
        s = st[t]
        n_svc = int(s[S.ST_DONE_SVC])
        m["completed_internal"] += int(s[S.ST_DONE_I])
        m["completed_through"] += int(s[S.ST_DONE_T]) + n_svc
        m["completed_service"] += n_svc
        m["sum_duration_internal"] = np.float32(
            m["sum_duration_internal"] + s[S.ST_DUR_I])
        m["sum_duration_through"] = np.float32(np.float32(
            m["sum_duration_through"] + s[S.ST_DUR_T]) + s[S.ST_DUR_SVC])
        m["sum_steps_internal"] += int(s[S.ST_STEPS_I])
        m["sum_steps_through"] += int(np.float32(s[S.ST_STEPS_T]
                                                 + s[S.ST_STEPS_SVC]))
        m["malfunctions_total"] += int(s[S.ST_NEW_MAL])
        m["collisions_total"] += int(s[S.ST_NEW_COL])
        m["created_internal"] += int(c[t, 0])
        m["created_through"] += int(c[t, 1])
        m["created_service"] += int(c[t, 2] + c[t, 3])
        m["errored_internal"] += int(d[t, 0] + s[S.ST_DROP_I]
                                     + s[S.ST_KILL_I])
        m["errored_through"] += int(d[t, 1] + s[S.ST_DROP_T]
                                    + s[S.ST_KILL_T])
        new_day = int((off + seg["elapsed"][t].item()) // 86400)
        tick_created = int(c[t, 0] + c[t, 1])
        tick_finished = int(s[S.ST_DONE_I] + s[S.ST_DONE_T]) + n_svc
        if new_day > m["day"]:
            diff = m["daily_finished"] - m["daily_created"]
            m["last_daily_difference"] = diff
            m["daily_diff_sum"] += diff
            m["days_completed"] += 1
            m["daily_created"] = tick_created
            m["daily_finished"] = tick_finished
        else:
            m["daily_created"] += tick_created
            m["daily_finished"] += tick_finished
        m["day"] = new_day
    return m


@pytest.mark.parametrize("days", [0, 1, 3])
def test_fold_metrics_matches_the_tick_by_tick_fold(days):
    """The segment's metrics fold (counters at once, the day rollover in
    closed form) against JAX's tick-by-tick fold, on random stats rows
    over segments that cross 0, 1 or 3 midnights."""
    rng = np.random.default_rng(days)
    cfg = Config()
    R = 6
    off = (cfg.SIMULATION_STARTING_TIME_OF_DAY_HOURS * 3600
           + cfg.SIMULATION_STARTING_TIME_OF_DAY_MINUTES * 60)
    # tick t at 86400 * 5 - 1 + t * step seconds into the run (days > 0:
    # the last tick on day 4 + days), or at 1000 s into day 5
    step = 86400 * days // (R - 1) if days else 6
    first = 86400 * 5 - 1 if days else 86400 * 5 + 1000
    start = first - off - step
    m = tsim.init_metrics("cpu")
    m = m.replace(**{k: torch.tensor(int(rng.integers(0, 500)),
                                     dtype=torch.int32)
                     for k in vars(m)
                     if not k.startswith("sum_duration") and k != "day"},
                  day=torch.tensor(4 if days else 5, dtype=torch.int32),
                  sum_duration_internal=torch.tensor(1234.5),
                  sum_duration_through=torch.tensor(99.25))
    stats = torch.from_numpy(rng.integers(0, 9, (R, megakernel.N_STATS))
                             .astype(np.float32))
    stats[:, [megakernel.ST_DUR_I, megakernel.ST_DUR_T,
              megakernel.ST_DUR_SVC]] *= 6.5
    seg = dict(created=torch.from_numpy(rng.integers(0, 5, (R, 4))
                                        .astype(np.int32)),
               drop_static=torch.from_numpy(rng.integers(0, 3, (R, 2))
                                            .astype(np.int32)),
               elapsed=torch.tensor([float(start + step * (t + 1))
                                     for t in range(R)]))
    got = megakernel.fold_metrics(cfg, m, stats, seg)
    want = _fold_reference(cfg, m, stats, seg)
    for k, v in want.items():
        g = getattr(got, k)
        assert g.dtype == getattr(m, k).dtype, k
        assert g.item() == v, (k, g.item(), v)
    assert int(got.days_completed - m.days_completed) == days


def test_megakernel_batch_matches_single_worlds(monkeypatch):
    """`run_batch_shared` through the megakernel branch (K9's vmap rule
    runs the worlds one after another) against each world's per-tick
    `run_chunk` with its key, with vmap's per-example fallback as an
    error."""
    import warnings
    from trafficsimulation_tpu_torch.parallel import mesh
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    cfg, world = _mega_world("QUEUE_ACTUATED")
    keys = np.stack([tsim._key_np(world.key),
                     np.array([7, 9], np.uint32)])
    monkeypatch.setenv("TSIM_MEGA_INTERPRET", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        batch = mesh.run_batch_shared(cfg, mesh.tile_dynamic(world, keys), 7)
    for b in range(2):
        single = world.replace(key=torch.from_numpy(
            keys[b].view(np.int32).copy()))
        ref = _run(monkeypatch, cfg, single, 7, mega=False)
        assert_mega_matches(ref, world_to_numpy(mesh.world_at(batch, b)))


def test_segment_rain_matches_jax_through_exits_and_respawns():
    """`step_rain_ticks` over segments of 5 ticks (as `prepare_segment`
    runs it) against JAX's jitted one-tick `step_rain` on the same key
    chain, on a small map where clouds leave, the cooldown starts and new
    clouds take the freed slots: every tick's rain map and the clouds at
    each segment's end bit for bit."""
    import jax
    from trafficsimulation_tpu.agents.rain import step_rain as jstep
    from trafficsimulation_tpu.core.state import RainState as JRain
    from trafficsimulation_tpu_torch.agents.rain import step_rain_ticks
    from trafficsimulation_tpu_torch.core.state import RainState
    over = dict(WIDTH=24, HEIGHT=20, RAIN_SPAWN_CHANCE=0.6,
                RAIN_RADIUS_MIN=2, RAIN_RADIUS_MAX=5, RAIN_COOLDOWN=48)
    jcfg, cfg = JConfig(**over), Config(**over)
    H, W, n, R = 20, 24, 60, 5
    f = np.float32
    # both clouds leave on the first tick, so the cooldown starts
    start = dict(active=np.array([True, True, False]),
                 cx=f([25.9, 3.25, 0.0]), cy=f([10.0, 22.9, 0.0]),
                 vx=f([0.8, -0.6, 0.0]), vy=f([0.6, 0.8, 0.0]),
                 radius=f([2.0, 3.0, 0.0]))
    jrain = JRain(**{k: jnp.asarray(v) for k, v in start.items()},
                  cooldown=jnp.int32(0))
    prain = RainState(**{k: torch.from_numpy(v) for k, v in start.items()},
                      cooldown=torch.tensor(0, dtype=torch.int32))
    key = prng.PRNGKey(11)
    draws, _ = engine.tick_draws(cfg, key, n)
    rows = torch.from_numpy(draws[:, engine.D_RAIN:engine.D_RAIN + 5])
    step = jax.jit(lambda r, k: jstep(jcfg, H, W, r, k))
    jkey = jnp.asarray(key)
    exits = spawns = cooldowns = 0
    for s in range(0, n, R):
        prain, maps = step_rain_ticks(cfg, H, W, prain, rows[s:s + R])
        for t in range(R):
            ks = jax.random.split(jkey, 6)
            jkey = jax.random.split(ks[0], 2)[0]
            before = np.asarray(jrain.active)
            jrain, jmap = step(jrain, ks[5])
            after = np.asarray(jrain.active)
            exits += int((before & ~after).sum())
            spawns += int((~before & after).sum())
            cooldowns += int(jrain.cooldown > 0)
            assert np.array_equal(np.asarray(jmap), maps[t].numpy()), s + t
        for k in ("active", "cx", "cy", "vx", "vy", "radius", "cooldown"):
            a, b = np.asarray(getattr(jrain, k)), getattr(prain, k).numpy()
            assert a.dtype == b.dtype and np.array_equal(
                a.view(np.int32) if a.dtype == f else a,
                b.view(np.int32) if b.dtype == f else b), (s, k)
    assert exits >= 3 and spawns >= 2 and cooldowns > 0, \
        (exits, spawns, cooldowns)


def test_rain_spawn_matches_jax_from_every_edge():
    """A cloud spawned into an empty sky, from each edge with and without
    the corner flip: the port's `step_rain` against JAX's jitted one on
    the same key chain, position, velocity and radius bit for bit."""
    import jax
    from trafficsimulation_tpu.agents.rain import (init_rain_state as jinit,
                                                   step_rain as jstep)
    from trafficsimulation_tpu_torch.agents.rain import (init_rain_state,
                                                         step_rain)
    over = dict(WIDTH=40, HEIGHT=28, RAIN_SPAWN_CHANCE=0.7)
    jcfg, cfg = JConfig(**over), Config(**over)
    n = 64
    key = prng.PRNGKey(5)
    draws, _ = engine.tick_draws(cfg, key, n)
    rows = torch.from_numpy(draws[:, engine.D_RAIN:engine.D_RAIN + 5])
    step = jax.jit(lambda r, k: jstep(jcfg, 28, 40, r, k))
    jkey, seen = jnp.asarray(key), set()
    for t in range(n):
        ks = jax.random.split(jkey, 6)
        jkey = jax.random.split(ks[0], 2)[0]
        jrain, jmap = step(jinit(jcfg), ks[5])
        prain, pmap = step_rain(cfg, 28, 40, init_rain_state(cfg, "cpu"),
                                rows[t])
        assert np.array_equal(np.asarray(jmap), pmap.numpy()), t
        for k in ("active", "cx", "cy", "vx", "vy", "radius"):
            a, b = np.asarray(getattr(jrain, k)), getattr(prain, k).numpy()
            assert np.array_equal(a.view(np.int32) if a.dtype.kind == "f"
                                  else a, b.view(np.int32)
                                  if b.dtype.kind == "f" else b), (t, k)
        if bool(jrain.active[0]):
            seen.add((int(rows[t, 1]), int(rows[t, 3])))
    assert seen == {(e, f) for e in range(4) for f in range(2)}, seen
