"""Host bridge of the PyTorch port: the JAX package's Tornado HTTP
server (`bridge/server.py`), endpoint for endpoint, over the port's
`TrafficSim` and its world on the card (or on the CPU).

The reference drives the simulation through a Mesa `ModularServer` with
per-feature Tornado routes (`mesa_server.py:53-68`); each button POSTs an
endpoint that mutates agent state directly.  Here every endpoint mutates
a small host-side override table that the stepping loop writes into the
world's `Overrides` before the next chunk of ticks.

Endpoint parity:
  traffic lights (`traffic_light_control.py:407-438`):
    /set_traffic_light_go|stop          (single light by id)
    /set_all_traffic_lights_go|stop
    /set_intersection_go|stop           (whole group)
    /set_intersection_opposites_go|stop (group axis pair)
    /set_intersection_neighbors_go|stop (group + neighbor groups)
  vehicles (`vehicle_control.py:259-272`):
    /create_vehicle?start=<flat>&dest=<dest_id>     (409 if occupied)
    /create_service_vehicle?type=food|waste&entrance=<idx>
  rain (`rain_control.py:76-80`):
    /spawn_rain
  observation:
    /state   (JSON summary), /frame.png (the framebuffer),
    /metrics (stats dashboard data, `traffic_statistics.py:31-391`)
    /step?n= (advance n ticks)

Tornado is optional, as in the JAX package: without it `BridgeState`
works and `make_app` raises.
"""

from __future__ import annotations

import io
import json
import threading

import numpy as np
import torch

from ..utils import to_numpy as _np

try:
    import tornado.ioloop
    import tornado.web
    HAVE_TORNADO = True
except ImportError:          # pragma: no cover
    HAVE_TORNADO = False


class BridgeState:
    """Shared host-side state between HTTP handlers and the sim loop."""

    def __init__(self, sim):
        self.sim = sim
        self.lock = threading.Lock()
        # pending one-shot overrides accumulated between chunks of ticks
        L = int(sim.world.overrides.light_force.shape[0])
        self.light_force = np.full((L,), -1, np.int8)
        self.spawn_rain = False
        self.spawn_requests = []   # (origin_flat, dest_id, kind)
        self.paused = False        # UI pause (the Mesa start/stop button)

    # ---- override helpers -------------------------------------------------
    def force_lights(self, mask_ids, stop: bool):
        with self.lock:
            self.light_force[mask_ids] = 1 if stop else 0

    def group_lights(self, group_id: int):
        ls = self.sim.world.lights_static
        group = _np(ls.group)
        valid = _np(ls.valid)
        return np.nonzero(valid & (group == group_id))[0]

    def axis_lights(self, group_id: int, axis: int):
        """The group's opposite-axis light list: its own lights whose
        controlled lanes flow along `axis` (0 = N-S, 1 = W-E) into the
        intersection — reference `opposite_pairs`
        (`intersection_light_group.py:243-279`)."""
        ls = self.sim.world.lights_static
        sel = (_np(ls.valid) & (_np(ls.group) == group_id)
               & (_np(ls.axis) == axis))
        return np.nonzero(sel)[0]

    def state(self) -> dict:
        """The `/state` summary of the world."""
        w = self.sim.world
        return {
            "tick": int(w.tick),
            "elapsed": float(w.elapsed),
            "active_vehicles": int(w.vehicles.active.sum()),
            "lights": int(w.lights_static.valid.sum()),
            "groups": int(w.groups_static.valid.sum()),
            "raining": int(w.rain.active.sum()),
        }

    def flush_into_world(self):
        """Apply accumulated overrides to the world, as tensors on its
        device (called by the sim loop between chunks of ticks)."""
        with self.lock:
            lf = self.light_force.copy()
            sr = self.spawn_rain
            self.light_force[:] = -1
            self.spawn_rain = False
        w = self.sim.world
        dev = w.overrides.light_force.device
        self.sim.world = w.replace(overrides=w.overrides.replace(
            light_force=torch.from_numpy(lf).to(dev),
            spawn_rain=torch.tensor(sr, device=dev)))


def _json(handler, obj, status=200):
    handler.set_status(status)
    handler.set_header("Content-Type", "application/json")
    handler.write(json.dumps(obj))


def make_app(bridge: BridgeState):
    if not HAVE_TORNADO:
        raise RuntimeError("tornado not available")
    sim = bridge.sim

    class LightHandler(tornado.web.RequestHandler):
        def post(self, action):
            stop = action.endswith("stop")
            kind = action.rsplit("_", 1)[0]
            if kind == "set_all_traffic_lights":
                valid = _np(sim.world.lights_static.valid)
                bridge.force_lights(np.nonzero(valid)[0], stop)
            elif kind == "set_traffic_light":
                lid = int(self.get_argument("id"))
                bridge.force_lights(np.array([lid]), stop)
            elif kind == "set_intersection":
                gid = int(self.get_argument("group"))
                bridge.force_lights(bridge.group_lights(gid), stop)
            elif kind == "set_intersection_opposites":
                # reference semantics (`traffic_light_control.py:300-340`):
                # act on the group's axis light pair, not the whole group
                gid = int(self.get_argument("group"))
                ax = self.get_argument("axis", "N-S")
                axis = 0 if str(ax).upper() in ("N-S", "NS", "0") else 1
                ids = bridge.axis_lights(gid, axis)
                if len(ids) == 0:
                    return _json(self, {"error": "no axis lights"}, 404)
                bridge.force_lights(ids, stop)
            elif kind in ("set_intersection_neighbors",
                          "set_intersection_neighbors_intermediate"):
                gid = int(self.get_argument("group"))
                ids = list(bridge.group_lights(gid))
                nbrs = _np(sim.world.groups_static.neighbor)[gid]
                for g in nbrs:
                    if g >= 0:
                        ids.extend(bridge.group_lights(int(g)))
                if kind.endswith("intermediate"):
                    inters = _np(
                        sim.world.groups_static.intermediates)[gid]
                    for g in inters:
                        if g >= 0:
                            ids.extend(bridge.group_lights(int(g)))
                bridge.force_lights(np.asarray(ids, int), stop)
            else:
                return _json(self, {"error": "unknown action"}, 404)
            _json(self, {"ok": True})

    class VehicleHandler(tornado.web.RequestHandler):
        def post(self):
            start = int(self.get_argument("start"))
            dest = int(self.get_argument("dest"))
            w = sim.world
            road = _np(w.grid.is_road).reshape(-1)
            if not (0 <= start < road.shape[0]) or not road[start]:
                # the reference only offers valid spawn cells in its
                # selection lists (`vehicle_control.py:229-240`)
                return _json(self, {"error": "start is not a road cell"},
                             404)
            if not (0 <= dest < w.cost_field.shape[0]) or \
                    not bool(_np(w.dests.valid)[dest]):
                return _json(self, {"error": "bad destination id"}, 404)
            vm = _np(w.veh_map).reshape(-1)
            if vm[start] >= 0:
                return _json(self, {"error": "cell occupied"}, 409)
            ok = sim.spawn_vehicle(start, dest)
            _json(self, {"ok": bool(ok)}, 200 if ok else 409)

    class ServiceVehicleHandler(tornado.web.RequestHandler):
        def post(self):
            svc = self.get_argument("type", "food").lower()
            ent = int(self.get_argument("entrance", "0"))
            hw = _np(sim.world.dests.hw_pos)
            if ent >= len(hw) or hw[ent] < 0:
                return _json(self, {"error": "bad entrance"}, 404)
            ok = sim.spawn_vehicle(int(hw[ent]), -1,
                                   kind=2 if svc == "food" else 3)
            _json(self, {"ok": bool(ok)}, 200 if ok else 409)

    class RainHandler(tornado.web.RequestHandler):
        def post(self):
            w = sim.world
            active = int(_np(w.rain.active).sum())
            cooldown = int(w.rain.cooldown)
            if active >= w.rain.active.shape[0] or cooldown > 0:
                return _json(self, {"error": "cooldown or max rains"}, 409)
            with bridge.lock:
                bridge.spawn_rain = True
            _json(self, {"ok": True})

    class StepHandler(tornado.web.RequestHandler):
        def post(self):
            n = int(self.get_argument("n", "1"))
            bridge.flush_into_world()
            sim.step(n)
            _json(self, {"ok": True, "tick": int(sim.world.tick)})

    class StateHandler(tornado.web.RequestHandler):
        def get(self):
            _json(self, bridge.state())

    class MetricsHandler(tornado.web.RequestHandler):
        def get(self):
            _json(self, sim.stats())

    class CellHandler(tornado.web.RequestHandler):
        """Per-cell inspector — the reference's AGENT_PORTRAYAL_LEVEL=2
        popup fields (`cell.py:300-344`): type, flow arrows, light state,
        queue assignment, block resources, plus the occupant vehicle."""

        def get(self):
            from .. import utils, codes as Cc
            w = sim.world
            grid = w.grid
            H, Wd = grid.cell_type.shape
            try:
                x = int(self.get_argument("x"))
                y = int(self.get_argument("y"))
            except (ValueError, tornado.web.MissingArgumentError):
                _json(self, {"error": "x and y required"}, 400)
                return
            if not (0 <= x < Wd and 0 <= y < H):
                _json(self, {"error": "out of bounds"}, 404)
                return
            t = int(_np(grid.cell_type)[y, x])
            out = {
                "x": x, "y": y,
                "cell_type": Cc.TYPE_NAMES.get(t, str(t)),
                "directions": sorted(utils.flow_at(
                    _np(grid.allowed_dirs), x, y)),
                "road_class": int(_np(grid.road_class)[y, x]),
                "stop": bool(_np(w.stop_map)[y, x]),
                "rain": bool(_np(w.rain_map)[y, x]),
            }
            lid = int(_np(grid.light_id)[y, x])
            gid = int(_np(grid.group_id)[y, x])
            if lid >= 0:
                out["light"] = {
                    "id": lid,
                    "stopped": bool(_np(
                        w.lights.light_stop)[lid]),
                    "group": int(_np(w.lights_static.group)[lid]),
                }
            if gid >= 0:
                out["group"] = {
                    "id": gid,
                    "phase": int(_np(
                        w.lights.current_phase)[gid]),
                    "pending": int(_np(
                        w.lights.pending_phase)[gid]),
                }
            qg = int(_np(grid.queue_group)[y, x])
            if qg >= 0:
                out["queue"] = {
                    "group": qg,
                    "bucket": int(_np(grid.queue_bucket)[y, x])}
            bid = int(_np(grid.block_id)[y, x])
            if bid >= 0:
                out["block"] = {
                    "id": bid,
                    "type": Cc.TYPE_NAMES.get(int(_np(
                        w.blocks_static.btype)[bid]), "?"),
                    "food": float(_np(w.blocks.food)[bid]),
                    "waste": float(_np(w.blocks.waste)[bid]),
                    "food_cap": float(_np(
                        w.blocks_static.food_cap)[bid]),
                    "waste_cap": float(_np(
                        w.blocks_static.waste_cap)[bid]),
                }
            vid = int(_np(w.veh_map)[y, x])
            if vid >= 0:
                v = w.vehicles
                out["vehicle"] = {
                    "slot": vid,
                    "kind": ["internal", "through", "food",
                             "waste"][int(_np(v.kind)[vid])],
                    "speed": int(_np(v.current_speed)[vid]),
                    "base_speed": int(_np(v.base_speed)[vid]),
                    "heading": int(_np(v.heading)[vid]),
                    "dest": int(_np(v.dest)[vid]),
                    "parked": bool(_np(v.parked)[vid]),
                    "stuck_ticks": int(_np(v.stuck_ticks)[vid]),
                    "in_collision": bool(_np(
                        v.in_collision)[vid]),
                    "in_malfunction": bool(_np(
                        v.in_malfunction)[vid]),
                    "overtaking": bool(_np(
                        v.contraflow_ticks)[vid] > 0),
                }
            _json(self, out)

    class HighwaysHandler(tornado.web.RequestHandler):
        """Highway I/O inventory with the reference's decorative labels
        (`cell.py:79-152`): flat cell -> "Horizontal_1_South_Entrance_2"
        style names."""

        def get(self):
            from .. import utils, codes as Cc
            grid = sim.world.grid
            cell = _np(grid.cell_type)
            Wd = cell.shape[1]
            out = {}
            for (y, x) in np.argwhere(np.isin(
                    cell, [Cc.HIGHWAY_ENTRANCE, Cc.HIGHWAY_EXIT])):
                flat = int(y) * Wd + int(x)
                out[flat] = utils.highway_label(grid, flat)
            _json(self, out)

    class ParamsHandler(tornado.web.RequestHandler):
        """Parameter panel parity (`model_parameters.py:67-189`): GET
        lists the generation parameters, POST /reset rebuilds the model
        with overrides (the reference's model-reset path,
        `dynamic_grid_server.py:9-24`)."""

        def get(self):
            import dataclasses
            _json(self, {k: v for k, v in
                         dataclasses.asdict(sim.cfg).items()
                         if isinstance(v, (int, float, bool, str))})

    class ResetHandler(tornado.web.RequestHandler):
        def post(self):
            import dataclasses
            fields = {f.name: f.type for f in dataclasses.fields(
                type(sim.cfg))}
            kw = {}
            for k in self.request.arguments:
                if k in fields:
                    cur = getattr(sim.cfg, k)
                    raw = self.get_argument(k)
                    if isinstance(cur, bool):
                        kw[k] = raw.lower() in ("1", "true", "on")
                    elif isinstance(cur, int):
                        kw[k] = int(raw)
                    elif isinstance(cur, float):
                        kw[k] = float(raw)
                    elif isinstance(cur, str):
                        kw[k] = raw
            seed = int(self.get_argument("seed", "0"))
            sim.reset(sim.cfg.replace(**kw), seed=seed)
            bridge.light_force = np.full_like(bridge.light_force, -1)
            _json(self, {"ok": True, "changed": sorted(kw)})

    class DestinationsHandler(tornado.web.RequestHandler):
        """Spawn-target inventory for the UI selects: routable
        destinations (block entrances + highway exits with reference
        labels) and highway-entrance indices (the reference's selection
        lists, `vehicle_control.py:64-154`)."""

        def get(self):
            from .. import utils, codes as Cc
            w = sim.world
            grid = w.grid
            cell = _np(grid.cell_type)
            Wd = cell.shape[1]
            DF = w.cost_field.shape[0]
            valid = _np(w.dests.valid)
            pos = _np(w.dests.pos)
            kind = _np(w.dests.kind)
            block = _np(w.dests.block)
            # ids handed to the UI are plane-facing routing ids
            # (identity dense, dests.rid under ROUTING_HIER — where
            # every valid dest is routable)
            rid = (_np(w.dests.rid) if w.dests.rid is not None
                   else np.arange(valid.shape[0]))
            hier = w.dests.rid is not None
            dests = []
            for i in np.nonzero(valid)[0]:
                if not hier and i >= DF:
                    continue
                p = int(pos[i])
                if kind[i] == 1:
                    label = utils.highway_label(grid, p)
                else:
                    label = f"Block {int(block[i])} entrance " \
                            f"({p % Wd}, {p // Wd})"
                dests.append({"id": int(rid[i]), "flat": p,
                              "label": label})
            entrances = []
            hw = _np(w.dests.hw_pos)
            hv = _np(w.dests.hw_valid)
            for j in range(len(hw)):
                if hv[j] and hw[j] >= 0:
                    entrances.append({
                        "index": int(j), "flat": int(hw[j]),
                        "label": utils.highway_label(grid, int(hw[j]))})
            _json(self, {"dests": dests, "entrances": entrances})

    class PauseHandler(tornado.web.RequestHandler):
        def post(self, action):
            bridge.paused = action == "pause"
            _json(self, {"ok": True, "paused": bridge.paused})

    class UIHandler(tornado.web.RequestHandler):
        def get(self):
            import os
            path = os.path.join(os.path.dirname(__file__), "ui.html")
            self.set_header("Content-Type", "text/html; charset=utf-8")
            with open(path, "rb") as f:
                self.write(f.read())

    class FrameHandler(tornado.web.RequestHandler):
        def get(self):
            fb = _np(sim.render())[::-1]   # north-up
            try:
                from PIL import Image
                buf = io.BytesIO()
                Image.fromarray(fb).save(buf, format="PNG")
                self.set_header("Content-Type", "image/png")
                self.write(buf.getvalue())
            except ImportError:
                self.set_header("Content-Type", "application/octet-stream")
                self.write(fb.tobytes())

    return tornado.web.Application([
        (r"/", UIHandler),
        (r"/(pause|resume)", PauseHandler),
        (r"/destinations", DestinationsHandler),
        (r"/(set_traffic_light_(?:go|stop))", LightHandler),
        (r"/(set_all_traffic_lights_(?:go|stop))", LightHandler),
        (r"/(set_intersection_(?:go|stop))", LightHandler),
        (r"/(set_intersection_opposites_(?:go|stop))", LightHandler),
        (r"/(set_intersection_neighbors_(?:go|stop))", LightHandler),
        (r"/(set_intersection_neighbors_intermediate_(?:go|stop))",
         LightHandler),
        (r"/create_vehicle", VehicleHandler),
        (r"/create_service_vehicle", ServiceVehicleHandler),
        (r"/spawn_rain", RainHandler),
        (r"/step", StepHandler),
        (r"/params", ParamsHandler),
        (r"/reset", ResetHandler),
        (r"/state", StateHandler),
        (r"/cell", CellHandler),
        (r"/metrics", MetricsHandler),
        (r"/highways", HighwaysHandler),
        (r"/frame.png", FrameHandler),
    ])


def get_free_port(start: int = 9250) -> int:
    """First free TCP port from `start` (reference `mesa_server.py:19-28`)."""
    import socket
    port = start
    while True:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("127.0.0.1", port))
                return port
            except OSError:
                port += 1


def launch(sim, port: int | None = None, ticks_per_frame: int = 20):
    """Run the bridge server with a background stepping loop
    (the reference's `server.launch()` + `render_schedule = 20`,
    `mesa_server.py:67`), CSV recording and tick timing."""
    from ..recording import ResultsRecorder
    from ..profiling import TickTimer
    bridge = BridgeState(sim)
    app = make_app(bridge)
    port = port or get_free_port()
    app.listen(port)
    print(f"trafficsimulation-tpu (PyTorch port) bridge on "
          f"http://127.0.0.1:{port}")
    recorder = ResultsRecorder(sim.cfg)
    timer = TickTimer(seconds_per_tick=sim.cfg.TIME_PER_STEP_IN_SECONDS)

    def loop():
        if bridge.paused:
            return
        bridge.flush_into_world()
        sim.step(ticks_per_frame)
        timer.record(ticks_per_frame)
        stats = sim.stats()
        stats.update(timer.stats())
        recorder.maybe_record(stats)

    cb = tornado.ioloop.PeriodicCallback(loop, 250)
    cb.start()
    try:
        tornado.ioloop.IOLoop.current().start()
    finally:
        recorder.cleanup_if_empty()


def main():
    """Console entry point (`trafficsim-serve-torch`): the reference
    launcher (`run.py:1-5`) over the port.  `--width/--height/--seed`
    cover the common knobs; any other Config field can be set with
    `--set NAME=VALUE` (parsed with the same rules as the /reset
    endpoint's JSON body: int/float/bool/str by the default's type).
    `--device cpu` runs the world on the CPU with the plain versions of
    the kernels; the default is the card."""
    import argparse
    import dataclasses

    from ..config import Config
    from ..sim import TrafficSim

    ap = argparse.ArgumentParser(prog="trafficsim-serve-torch")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--ticks-per-frame", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE", dest="overrides")
    args = ap.parse_args()

    fields = {f.name: f for f in dataclasses.fields(Config)}
    kw = {}
    if args.width is not None:
        kw["WIDTH"] = args.width
    if args.height is not None:
        kw["HEIGHT"] = args.height
    for item in args.overrides:
        name, _, raw = item.partition("=")
        if name not in fields:
            ap.error(f"unknown Config field {name!r}")
        cur = getattr(Config(), name)
        if isinstance(cur, bool):
            kw[name] = raw.lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, int):
            kw[name] = int(raw)
        elif isinstance(cur, float):
            kw[name] = float(raw)
        else:
            kw[name] = raw
    sim = TrafficSim(Config(**kw), seed=args.seed, device=args.device)
    launch(sim, port=args.port, ticks_per_frame=args.ticks_per_frame)


if __name__ == "__main__":
    main()
