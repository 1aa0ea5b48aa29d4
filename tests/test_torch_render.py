"""The port's framebuffer against the JAX package's, byte for byte.

`render_frame` and `TrafficSim.render` (u8 [H, W, 3]) at level 0 and 2,
with stop recolors, rain, pending-phase intersections, every vehicle
class and the dummy overlay, on a crossroad world whose vehicles and
masks are drawn from a numpy seed; the rain desaturation on the colours
whose luma mix lands next to a truncation boundary (where the order and
fusion of the luma's multiply-adds decide the byte); and K8's plain
version (`render_planes_plain`, through `render_pallas_plain`) against
JAX's `render_pallas` run in Pallas interpret mode.  The frames must be
equal: no tolerance.
"""

import collections
import functools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from trafficsimulation_tpu import codes as JC
from trafficsimulation_tpu import sim as jsim
from trafficsimulation_tpu.config import Config
from trafficsimulation_tpu.core.synth import crossroad_world
from trafficsimulation_tpu.ops import pallas_render as jpr
from trafficsimulation_tpu.ops import render as jrender

from trafficsimulation_tpu_torch import codes as TC
from trafficsimulation_tpu_torch import sim as tsim
from trafficsimulation_tpu_torch.config import Config as TConfig
from trafficsimulation_tpu_torch.core.transfer import world_from_numpy
from trafficsimulation_tpu_torch.ops import render as trender

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_snapshot import world_to_leaves  # noqa: E402

torch.set_num_threads(2)

CFG = Config(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64)
TCFG = TConfig(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64)


@functools.cache
def _crossroad():
    return crossroad_world(CFG)


def _painted_leaves(seed: int) -> dict:
    """The crossroad world's leaves with random stop, rain and pending
    masks and a pool whose vehicles cover every class; some `veh_map`
    cells point at inactive or misplaced slots (the dummy overlay)."""
    leaves = world_to_leaves(_crossroad())
    rng = np.random.default_rng(seed)
    H, W = CFG.HEIGHT, CFG.WIDTH
    V = leaves["vehicles.active"].shape[0]
    leaves["stop_map"] = rng.random((H, W)) < 0.4
    leaves["rain_map"] = rng.random((H, W)) < 0.5
    cells = rng.choice(H * W, size=V, replace=False).astype(np.int32)
    active = rng.random(V) < 0.8
    v = {"active": active, "pos": cells,
         "kind": rng.integers(0, 4, V).astype(np.uint8),
         "parked": rng.random(V) < 0.2,
         "in_malfunction": rng.random(V) < 0.15,
         "in_collision": rng.random(V) < 0.15}
    for k, a in v.items():
        leaves[f"vehicles.{k}"] = a.astype(leaves[f"vehicles.{k}"].dtype)
    vm = np.full(H * W, -1, np.int32)
    vm[cells[: V - 6]] = np.arange(V - 6, dtype=np.int32)
    # misplaced slots: a cell that names a vehicle standing elsewhere
    vm[cells[V - 6:]] = rng.integers(0, V, 6).astype(np.int32)
    leaves["veh_map"] = vm.reshape(H, W)
    return leaves


def _jax_world(leaves):
    """The JAX world with the painted leaves."""
    world = _crossroad()
    flat, tree = jax.tree_util.tree_flatten_with_path(world)
    vals = [jnp.asarray(leaves[".".join(k.name for k in p)])
            for p, _ in flat]
    return jax.tree_util.tree_unflatten(tree, vals)


def _jax_frame(world, pending, level, dummy):
    fn = jax.jit(lambda w, pm: jrender.render_frame(
        w.grid, w.stop_map, w.rain_map, w.veh_map, w.vehicles,
        pending_mask=pm, level=level, dummy_overlay=dummy))
    return np.asarray(fn(world, pending))


@pytest.mark.parametrize("seed", [0, 5])
def test_render_frame_matches_jax(seed):
    leaves = _painted_leaves(seed)
    jw = _jax_world(leaves)
    tw = world_from_numpy(leaves, "cpu")
    pending = np.random.default_rng(seed + 1).random(
        (CFG.HEIGHT, CFG.WIDTH)) < 0.5
    pending[CFG.HEIGHT // 2 - 1:CFG.HEIGHT // 2 + 1,
            CFG.WIDTH // 2 - 1:CFG.WIDTH // 2 + 1] = True
    for level, dummy, pm in ((0, False, None), (2, False, None),
                             (2, True, pending), (2, False, pending)):
        ref = _jax_frame(jw, None if pm is None else jnp.asarray(pm),
                         level, dummy)
        got = trender.render_frame(
            tw.grid, tw.stop_map, tw.rain_map, tw.veh_map, tw.vehicles,
            pending_mask=None if pm is None else torch.from_numpy(pm),
            level=level, dummy_overlay=dummy)
        assert got.dtype == torch.uint8 and got.shape == ref.shape
        assert np.array_equal(got.numpy(), ref), (level, dummy, pm is None)
    # the overlays showed: rain, a stopped light, every vehicle colour
    assert (ref != _jax_frame(jw, None, 0, False)).any()


@pytest.mark.parametrize("level,dummy", [(0, False), (2, False), (2, True)])
def test_trafficsim_render_matches_jax(level, dummy):
    leaves = _painted_leaves(3)
    jsm = object.__new__(jsim.TrafficSim)
    jsm.cfg = CFG.replace(AGENT_PORTRAYAL_LEVEL=level,
                          USE_DUMMY_AGENTS=dummy)
    jsm.world = _jax_world(leaves)
    tsm = tsim.TrafficSim.from_world(
        TCFG.replace(AGENT_PORTRAYAL_LEVEL=level, USE_DUMMY_AGENTS=dummy),
        world_from_numpy(leaves, "cpu"))
    got = tsm.render()
    assert got.device.type == "cpu"
    assert np.array_equal(got.numpy(), np.asarray(jsm.render()))


def _boundary_colours() -> np.ndarray:
    """Every colour whose rain mix truncates differently under another
    order or fusion of the luma's three multiply-adds (243 of 2^24)."""
    f32 = np.float32
    a = [f32(0.299), f32(0.587), f32(0.114)]
    gb = np.stack(np.meshgrid(np.arange(256), np.arange(256),
                              indexing="ij"), -1).reshape(-1, 2)
    g, b = gb[:, 0].astype(f32), gb[:, 1].astype(f32)
    out = []
    for r in range(256):
        rr = np.full_like(g, r)
        seq = (rr * a[0] + g * a[1]) + b * a[2]
        t = (rr * a[0]).astype(np.float64)
        t = (g.astype(np.float64) * a[1] + t).astype(f32)
        fma = (b.astype(np.float64) * a[2] + t).astype(f32)
        rev = (b * a[2] + g * a[1]) + rr * a[0]
        cols = np.stack([rr, g, b], -1)

        def mix(grey):
            return (f32(0.5) * cols + f32(0.5) * grey[:, None]).astype(
                np.uint8)
        m = [mix(x) for x in (seq, fma, rev)]
        diff = (m[0] != m[1]).any(1) | (m[1] != m[2]).any(1)
        out.append(cols[diff].astype(np.uint8))
    return np.concatenate(out)


def test_rain_desaturation_on_truncation_boundaries(monkeypatch):
    """A palette of the boundary colours (cell codes 0..255 index it),
    rain everywhere: JAX's frame and the port's agree on every pixel."""
    cols = _boundary_colours()
    assert len(cols) > 100
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(cols)] = cols
    monkeypatch.setattr(JC, "PALETTE", pal)
    monkeypatch.setattr(TC, "PALETTE", pal)
    H = W = 16
    cell = np.arange(256, dtype=np.uint8).reshape(H, W)
    false = np.zeros((H, W), bool)
    V = 4
    veh = dict(active=np.zeros(V, bool), kind=np.zeros(V, np.uint8),
               parked=np.zeros(V, bool), in_malfunction=np.zeros(V, bool),
               in_collision=np.zeros(V, bool), pos=np.zeros(V, np.int32))
    vm = np.full((H, W), -1, np.int32)

    def jfn(ct):
        grid = types.SimpleNamespace(cell_type=ct,
                                     intersection=jnp.asarray(false))
        vv = types.SimpleNamespace(**{k: jnp.asarray(a)
                                      for k, a in veh.items()})
        return jrender.render_frame(grid, jnp.asarray(false),
                                    jnp.ones((H, W), bool), jnp.asarray(vm),
                                    vv, level=2)
    ref = np.asarray(jax.jit(jfn)(jnp.asarray(cell)))
    grid = types.SimpleNamespace(cell_type=torch.from_numpy(cell),
                                 intersection=torch.from_numpy(false))
    vv = types.SimpleNamespace(**{k: torch.from_numpy(a)
                                  for k, a in veh.items()})
    got = trender.render_frame(grid, torch.from_numpy(false),
                               torch.ones((H, W), dtype=torch.bool),
                               torch.from_numpy(vm), vv, level=2)
    assert np.array_equal(got.numpy(), ref)
    # the case is not vacuous: an unfused f32 luma differs on some pixel
    f = torch.from_numpy(pal).float()
    seq = (f[:, 0] * 0.299 + f[:, 1] * 0.587) + f[:, 2] * 0.114
    naive = (0.5 * f + 0.5 * seq[:, None]).to(torch.uint8)
    assert (naive.numpy() != ref.reshape(256, 3)).any()


def test_render_pallas_plain_matches_jax_interpret():
    """K8's plain version against JAX's `render_pallas` run in Pallas
    interpret mode at 32^2: codes past the palette, stops, rain and all
    five vehicle classes, two vehicles on one cell (scatter-max)."""
    rng = np.random.default_rng(11)
    H = W = 32
    V = 96
    cell = rng.integers(0, 20, (H, W)).astype(np.uint8)
    stop = rng.random((H, W)) < 0.4
    rain = rng.random((H, W)) < 0.4
    pos = rng.integers(-3, H * W + 3, V).astype(np.int32)
    pos[1] = pos[0]
    veh = dict(active=rng.random(V) < 0.8, pos=pos,
               kind=rng.integers(0, 4, V).astype(np.uint8),
               parked=rng.random(V) < 0.2,
               in_malfunction=rng.random(V) < 0.15,
               in_collision=rng.random(V) < 0.15)
    vm = np.full((H, W), -1, np.int32)
    Veh = collections.namedtuple("Veh", list(veh))     # a JAX pytree
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpr.render_pallas(
            jnp.asarray(cell), jnp.asarray(stop), jnp.asarray(rain),
            jnp.asarray(vm), Veh(**{k: jnp.asarray(a)
                                    for k, a in veh.items()})))
    vv = types.SimpleNamespace(**{k: torch.from_numpy(a)
                                  for k, a in veh.items()})
    args = (torch.from_numpy(cell), torch.from_numpy(stop),
            torch.from_numpy(rain), torch.from_numpy(vm), vv)
    got = trender.render_pallas_plain(*args)
    assert got.shape == (3, H, W) and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), ref)
    # on the CPU the K8 wrapper is its plain version and launches nothing
    from trafficsimulation_tpu_torch.ops import hopper_engine as HE
    n0 = HE.launches["render"]
    assert np.array_equal(trender.render_pallas(*args).numpy(), ref)
    assert HE.launches["render"] == n0
    assert len(np.unique(ref.reshape(3, -1), axis=1).T) > 12


def test_k8_packed_word_arithmetic_matches_plain():
    """K8's per-pixel arithmetic (csrc/render.cu `pixel_rgb`), emulated
    in numpy on the wrapper's packed table (one r | g << 8 | b << 16 word
    a colour; rain mixed on the word as ((rgb >> 1) & 0x7F7F7F) +
    0x404040), against the plain version on every combination of cell
    code (past the palette too), stop, rain and vehicle class."""
    codes = np.arange(20, dtype=np.uint8)
    grid = np.array(np.meshgrid(codes, [0, 1], [0, 1],
                                np.arange(7, dtype=np.uint8),
                                indexing="ij")).reshape(4, -1)
    n = grid.shape[1]
    W = 40
    H = -(-n // W)
    pad = H * W - n
    cell, stop, rain, vs = (np.concatenate([g, np.zeros(pad, g.dtype)])
                            .astype(np.uint8).reshape(H, W) for g in grid)
    table = np.frombuffer(trender._packed_colours(), np.uint32)
    k = np.where(cell < 18, cell.astype(np.int64), -1)
    k = np.where((cell == TC.TRAFFIC_LIGHT) & (stop == 1), 18, k)
    k = np.where((cell == TC.CONTROLLED_ROAD) & (stop == 1), 19, k)
    rgb = np.where(k >= 0, table[np.maximum(k, 0)], 0).astype(np.uint32)
    rgb = np.where(rain == 1, ((rgb >> 1) & 0x7F7F7F) + 0x404040, rgb)
    rgb = np.where((vs >= 1) & (vs <= 5), table[np.clip(19 + vs, 0, 24)],
                   rgb)
    got = np.stack([(rgb >> (8 * ch)) & 0xFF for ch in range(3)]) \
        .astype(np.uint8)
    ref = trender.render_planes_plain(
        torch.from_numpy(cell), torch.from_numpy(stop == 1),
        torch.from_numpy(rain == 1), torch.from_numpy(vs)).numpy()
    assert np.array_equal(got, ref)


def test_k8_path_by_alignment():
    """K8's wrapper takes its vector path (16 pixels a thread, 16-byte
    loads and stores) where every plane starts on a 16-byte boundary and
    its scalar path otherwise (`render_path`); on CPU tensors it runs
    the plain version either way."""
    H, W = 37, 300
    buf = torch.zeros(H * W + 16, dtype=torch.uint8)
    base = (-buf.data_ptr()) % 16
    cell = buf[base:base + H * W].view(H, W)
    odd = buf[base + 1:base + 1 + H * W].view(H, W)
    stop = torch.zeros((H, W), dtype=torch.bool)
    assert stop.data_ptr() % 16 == 0
    assert trender.render_path(cell, stop, stop, cell) == "vector"
    assert trender.render_path(odd, stop, stop, cell) == "scalar"
    out = torch.empty((3, H, W), dtype=torch.uint8)
    assert trender.render_path(cell, stop, stop, cell, out) == \
        ("vector" if out.data_ptr() % 16 == 0 else "scalar")
    assert torch.equal(trender.render_planes(odd, stop, stop, odd),
                       trender.render_planes_plain(odd, stop, stop, odd))


def test_headline_end_frame_matches_jax_digest():
    """The port's frame of the headline snapshot's end state (JAX's
    world after 23 ticks, as stored) hashes to the digest of JAX's frame
    that chip_smoke.py holds the card's run to."""
    import hashlib
    import json
    from trafficsimulation_tpu_torch import snapshot
    from trafficsimulation_tpu_torch.core.state import Vehicles
    with np.load(snapshot.HEADLINE) as z:
        grid = types.SimpleNamespace(
            cell_type=torch.from_numpy(z["grid.cell_type"]),
            intersection=torch.from_numpy(z["grid.intersection"]))
        end = {k[4:]: torch.from_numpy(z[k]) for k in z.files
               if k.startswith("ref.")}
    v = Vehicles(**{f: end["vehicles." + f]
                    for f in Vehicles.__dataclass_fields__})
    frame = trender.render_frame(grid, end["stop_map"], end["rain_map"],
                                 end["veh_map"], v,
                                 pending_mask=torch.zeros_like(
                                     end["stop_map"]))
    with open(snapshot.HEADLINE_FRAME) as f:
        ref = json.load(f)
    assert list(frame.shape) == ref["shape"]
    assert hashlib.sha256(frame.numpy().tobytes()).hexdigest() == \
        ref["sha256"]
