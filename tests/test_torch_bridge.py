"""The port's host bridge and host-side `TrafficSim` API against the JAX
package's, on the crossroad world (CPU tensors).

`BridgeState` (light lists, overrides flushed into the world),
`TrafficSim.spawn_vehicle` (an ordinary vehicle, food and waste service
vehicles, an occupied cell, a full pool), `get_traffic_lights` and
`num_active_vehicles` must leave the same world leaves and answers as
JAX's; the HTTP handlers (through tornado's client on a local port,
where tornado is installed) must give the same status and JSON.  The
`/create_vehicle` destination check compares against the dense row
count, as the JAX bridge does, also under hierarchical routing where the
routing ids the UI is handed can exceed it: the port keeps that fault of
the reference, and the test pins it.  No JAX tick is compiled: the
bridge's stepping is checked on the port alone (`/step` applies the
forced lights, as tests/test_bridge.py checks for JAX).
"""

import asyncio
import functools
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu import sim as jsim
from trafficsimulation_tpu.bridge import server as jserver
from trafficsimulation_tpu.config import Config
from trafficsimulation_tpu.core.synth import crossroad_world

from trafficsimulation_tpu_torch import sim as tsim
from trafficsimulation_tpu_torch.bridge import server as tserver
from trafficsimulation_tpu_torch.config import Config as TConfig
from trafficsimulation_tpu_torch.core.transfer import (world_from_numpy,
                                                       world_to_numpy)
from trafficsimulation_tpu_torch.recording import ResultsRecorder
from trafficsimulation_tpu_torch.profiling import TickTimer, timed_steps

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_snapshot import world_to_leaves  # noqa: E402

torch.set_num_threads(2)

KW = dict(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64,
          VEHICLE_MAX_SPEED=2)


@functools.cache
def _base_leaves() -> dict:
    return world_to_leaves(crossroad_world(Config(**KW)))


def _leaves(hier: bool = False, full: bool = False) -> dict:
    """The crossroad world's leaves with a few vehicles and tank levels;
    `hier` adds routing ids past the dense rows (as under ROUTING_HIER),
    `full` fills the pool."""
    leaves = {k: v.copy() for k, v in _base_leaves().items()}
    rng = np.random.default_rng(4)
    V = leaves["vehicles.active"].shape[0]
    n = V if full else 5
    road = np.nonzero(leaves["grid.is_road"].reshape(-1))[0]
    if not full:       # the highway entrances stay free for spawns
        road = np.setdiff1d(road, leaves["dests.hw_pos"])
    cells = rng.choice(road, n, replace=False).astype(np.int32)
    leaves["vehicles.active"][:n] = True
    leaves["vehicles.pos"][:n] = cells
    vm = np.full(leaves["veh_map"].size, -1, np.int32)
    vm[cells] = np.arange(n, dtype=np.int32)
    leaves["veh_map"] = vm.reshape(leaves["veh_map"].shape)
    nb = leaves["blocks.food"].shape[0]
    leaves["blocks.food"] = rng.uniform(0, 50, nb).astype(np.float32)
    leaves["blocks.waste"] = rng.uniform(0, 50, nb).astype(np.float32)
    leaves["elapsed"] = np.float32(42.0)
    if hier:
        nd = leaves["dests.valid"].shape[0]
        leaves["dests.rid"] = (np.arange(nd) * 3).astype(np.int32)
    return leaves


def _jax_world(leaves):
    world = crossroad_world(Config(**KW))
    if "dests.rid" in leaves:
        world = world.replace(dests=world.dests.replace(
            rid=jnp.zeros_like(world.dests.pos)))
    flat, tree = jax.tree_util.tree_flatten_with_path(world)
    return jax.tree_util.tree_unflatten(tree, [
        jnp.asarray(leaves[".".join(k.name for k in p)]) for p, _ in flat])


def _pair(leaves):
    """(JAX TrafficSim, port TrafficSim) over the same world, neither
    generated nor stepped."""
    jsm = object.__new__(jsim.TrafficSim)
    jsm.cfg = Config(**KW)
    jsm.world = _jax_world(leaves)
    tsm = tsim.TrafficSim.from_world(TConfig(**KW),
                                     world_from_numpy(leaves, "cpu"))
    return jsm, tsm


def _same_world(jw, tw):
    ref, got = world_to_leaves(jw), world_to_numpy(tw)
    bad = [k for k, a in ref.items() if k != "cost_field" and not (
        a.shape == got[k].shape and a.dtype == got[k].dtype
        and np.array_equal(a, got[k]))]
    assert not bad, bad


def test_bridge_state_lights_and_flush():
    jsm, tsm = _pair(_leaves())
    jb, tb = jserver.BridgeState(jsm), tserver.BridgeState(tsm)
    for g in (0, 1, 5):
        assert np.array_equal(tb.group_lights(g), jb.group_lights(g))
        for axis in (0, 1):
            assert np.array_equal(tb.axis_lights(g, axis),
                                  jb.axis_lights(g, axis))
    ids0 = tb.axis_lights(0, 0)
    assert len(ids0) > 0
    for b in (jb, tb):
        b.force_lights(ids0, stop=True)
        b.force_lights(b.axis_lights(0, 1), stop=False)
        b.spawn_rain = True
        b.flush_into_world()
        assert (b.light_force == -1).all() and not b.spawn_rain
    _same_world(jsm.world, tsm.world)
    lf = tsm.world.overrides.light_force
    assert lf.dtype == torch.int8 and (lf[ids0] == 1).all()
    assert bool(tsm.world.overrides.spawn_rain)


def test_bridge_flush_then_step_applies_forced_lights():
    """The forced axis lights stop on the port's next tick and the
    overrides are one-shot (tests/test_bridge.py's check, on the port)."""
    _, tsm = _pair(_leaves())
    tb = tserver.BridgeState(tsm)
    ids0 = tb.axis_lights(0, 0)
    tb.force_lights(ids0, stop=True)
    tb.flush_into_world()
    tsm.step(1)
    assert tsm.world.lights.light_stop[ids0].all()
    assert (tsm.world.overrides.light_force == -1).all()
    tb.force_lights(tb.group_lights(0), stop=False)
    tb.flush_into_world()
    tsm.step(2)
    assert not tsm.world.lights.light_stop[tb.group_lights(0)].any()


@pytest.mark.parametrize("hier", [False, True], ids=["dense", "hier"])
def test_spawn_vehicle_and_queries_match_jax(hier):
    jsm, tsm = _pair(_leaves(hier=hier))
    assert np.array_equal(tsm.get_traffic_lights(), jsm.get_traffic_lights())
    assert tsm.num_active_vehicles() == jsm.num_active_vehicles() == 5
    road = np.nonzero(_base_leaves()["grid.is_road"].reshape(-1))[0]
    occupied = int(tsm.world.vehicles.pos[0])
    free = [int(c) for c in road if int(tsm.world.veh_map.reshape(-1)[c])
            < 0]
    hw = _base_leaves()["dests.hw_pos"]
    for args in ((occupied, 1, 0), (free[0], 1, 0), (free[1], 3, 1),
                 (int(hw[0]), -1, 2), (int(hw[1]), -1, 3),
                 (free[0], 2, 0)):
        ok_j = jsm.spawn_vehicle(*args)
        ok_t = tsm.spawn_vehicle(*args)
        assert ok_t == ok_j, args
        _same_world(jsm.world, tsm.world)
    assert tsm.num_active_vehicles() == jsm.num_active_vehicles() == 9
    v = tsm.world.vehicles
    assert v.kind[v.active].tolist().count(2) == 1


def test_spawn_vehicle_full_pool_matches_jax():
    jsm, tsm = _pair(_leaves(full=True))
    road = np.nonzero(_base_leaves()["grid.is_road"].reshape(-1))[0]
    cell = next(int(c) for c in road
                if int(tsm.world.veh_map.reshape(-1)[c]) < 0)
    assert jsm.spawn_vehicle(cell, 1) is False
    assert tsm.spawn_vehicle(cell, 1) is False
    _same_world(jsm.world, tsm.world)


def _fetch_all(app, requests):
    """[(status, body)] of each (method, path) sent to `app` served on a
    local port."""
    import tornado.httpclient
    import tornado.httpserver
    import tornado.testing

    async def run():
        sock, port = tornado.testing.bind_unused_port()
        server = tornado.httpserver.HTTPServer(app)
        server.add_sockets([sock])
        client = tornado.httpclient.AsyncHTTPClient()
        out = []
        try:
            for method, path in requests:
                r = await client.fetch(
                    f"http://127.0.0.1:{port}{path}", method=method,
                    body=b"" if method == "POST" else None,
                    raise_error=False)
                out.append((r.code, r.body))
        finally:
            server.stop()
            client.close()
        return out
    return asyncio.run(run())


REQUESTS = (
    ("GET", "/state"), ("GET", "/metrics"), ("GET", "/params"),
    ("GET", "/highways"), ("GET", "/destinations"),
    ("GET", "/cell?x=15&y=15"), ("GET", "/cell?x=14&y=16"),
    ("GET", "/cell?x=99&y=1"), ("GET", "/cell"),
    ("POST", "/set_all_traffic_lights_stop"),
    ("POST", "/set_traffic_light_go?id=1"),
    ("POST", "/set_intersection_stop?group=0"),
    ("POST", "/set_intersection_opposites_go?group=0&axis=N-S"),
    ("POST", "/set_intersection_opposites_stop?group=3&axis=W-E"),
    ("POST", "/set_intersection_neighbors_stop?group=0"),
    ("POST", "/create_vehicle?start=0&dest=1"),
    ("POST", "/create_service_vehicle?type=waste&entrance=0"),
    ("POST", "/create_service_vehicle?type=food&entrance=9"),
    ("POST", "/spawn_rain"), ("POST", "/pause"), ("POST", "/resume"),
    ("GET", "/frame.png"), ("GET", "/"),
)


@pytest.mark.parametrize("hier", [False, True], ids=["dense", "hier"])
def test_handlers_match_jax(hier):
    """Every read-only and override endpoint, and /create_vehicle on a
    non-road start, an occupied start, a free start with a dense-row
    destination and with a routing id past the dense rows (404 on both:
    the pinned check), give JAX's status and JSON, and leave the same
    world and pending overrides."""
    pytest.importorskip("tornado")
    leaves = _leaves(hier=hier)
    jsm, tsm = _pair(leaves)
    jb, tb = jserver.BridgeState(jsm), tserver.BridgeState(tsm)
    road = np.nonzero(leaves["grid.is_road"].reshape(-1))[0]
    free = [int(c) for c in road if leaves["veh_map"].reshape(-1)[c] < 0]
    occupied = int(leaves["vehicles.pos"][0])
    DF = leaves["cost_field"].shape[0]
    reqs = list(REQUESTS) + [
        ("POST", f"/create_vehicle?start={occupied}&dest=1"),
        ("POST", f"/create_vehicle?start={free[0]}&dest=0"),
        ("POST", f"/create_vehicle?start={free[1]}&dest={DF}"),
        ("GET", "/state")]
    if hier:
        # a valid destination's routing id past the dense row count is
        # turned away, as by the JAX bridge (the pinned check)
        rid = leaves["dests.rid"][leaves["dests.valid"]]
        big = [int(r) for r in rid if r >= DF]
        assert big
        reqs.append(("POST", f"/create_vehicle?start={free[2]}"
                             f"&dest={big[0]}"))
    got_j = _fetch_all(jserver.make_app(jb), reqs)
    got_t = _fetch_all(tserver.make_app(tb), reqs)
    for (method, path), (cj, bj), (ct, bt) in zip(reqs, got_j, got_t):
        assert ct == cj, (path, ct, cj, bt)
        if ct == 500:
            # both fail alike: the crossroad's highway cells lie off the
            # grid's edge, where the reference's labels find no run
            continue
        if path in ("/frame.png", "/"):
            assert bt == bj, path
        else:
            assert json.loads(bt) == json.loads(bj), path
    if hier:
        assert got_t[-1][0] == 404
        assert b"bad destination id" in got_t[-1][1]
    assert got_t[reqs.index(("POST", f"/create_vehicle?start={free[0]}"
                                     "&dest=0"))][0] == 200
    assert np.array_equal(tb.light_force, jb.light_force)
    assert tb.spawn_rain == jb.spawn_rain
    _same_world(jsm.world, tsm.world)


def test_highway_labels_and_flow_match_jax():
    """The inspectors' labels (copied from the JAX package's utils) on a
    grid with highway runs on all four edges, and the flow arrows."""
    from trafficsimulation_tpu import codes as JC
    from trafficsimulation_tpu import utils as jutils
    from trafficsimulation_tpu_torch import utils as tutils
    rng = np.random.default_rng(2)
    H, W = 20, 24
    cell = np.full((H, W), JC.SIDEWALK, np.uint8)
    for edge in (cell[0], cell[-1], cell[:, 0], cell[:, -1]):
        idx = np.sort(rng.choice(np.arange(2, len(edge) - 2), 8, False))
        edge[idx] = rng.choice([JC.HIGHWAY_ENTRANCE, JC.HIGHWAY_EXIT], 8)
    dirs = rng.integers(0, 16, (H, W)).astype(np.uint8)
    hw = np.argwhere(np.isin(cell, [JC.HIGHWAY_ENTRANCE, JC.HIGHWAY_EXIT]))
    assert len(hw) >= 20
    jgrid = types.SimpleNamespace(cell_type=cell)
    tgrid = types.SimpleNamespace(cell_type=torch.from_numpy(cell))
    for y, x in hw:
        flat = int(y) * W + int(x)
        assert tutils.highway_label(tgrid, flat) == \
            jutils.highway_label(jgrid, flat)
        assert tutils.flow_at(torch.from_numpy(dirs), int(x), int(y)) == \
            jutils.flow_at(dirs, int(x), int(y))
    with pytest.raises(ValueError):
        tutils.highway_label(tgrid, W + 1)


def test_port_step_endpoint_advances_the_world():
    pytest.importorskip("tornado")
    _, tsm = _pair(_leaves())
    tb = tserver.BridgeState(tsm)
    (code, body), (code2, body2) = _fetch_all(tserver.make_app(tb), [
        ("POST", "/set_all_traffic_lights_stop"), ("POST", "/step?n=3")])
    assert code == code2 == 200
    assert json.loads(body2) == {"ok": True, "tick": 3}
    assert tsm.world.lights.light_stop[tsm.world.lights_static.valid].all()


def test_ui_page_calls_only_the_port_bridge_routes():
    """The served page is JAX's, and every endpoint it calls is
    registered by the port's bridge."""
    import re
    here = os.path.dirname(tserver.__file__)
    page = open(os.path.join(here, "ui.html")).read()
    assert page == open(os.path.join(os.path.dirname(jserver.__file__),
                                     "ui.html")).read()
    patterns = re.findall(r"\(r\"(/[^\"]*)\"", open(tserver.__file__).read())
    assert patterns == re.findall(r"\(r\"(/[^\"]*)\"",
                                  open(jserver.__file__).read())
    called = set(re.findall(r"(?:post|fetch)\('(/[a-zA-Z_.]+)", page))
    assert called and all(any(re.fullmatch(p, c) for p in patterns)
                          for c in called)


def test_recorder_and_timer(tmp_path):
    """The port's CSV recorder and tick timer (copies of JAX's) on the
    port's stats of a stepped CPU world."""
    _, tsm = _pair(_leaves())
    rec = ResultsRecorder(tsm.cfg, root=str(tmp_path))
    st = timed_steps(tsm, 4, chunk=2)
    assert st["ticks_per_sec"] > 0 and st["cell_updates_per_sec"] > 0
    stats = tsm.stats()
    stats.update(TickTimer().stats())
    rec.maybe_record(stats)
    rows = open(os.path.join(rec.run_dir, "totals.csv")).read().splitlines()
    assert rows[0].startswith("tick,") and rows[1].startswith("4,")
    empty = ResultsRecorder(tsm.cfg, root=str(tmp_path / "e"))
    empty.cleanup_if_empty()
    assert not os.path.exists(empty.run_dir)
