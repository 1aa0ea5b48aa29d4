"""The port's pedestrians (BASELINE config #3) and its no-traffic config
(#1) against the JAX package.

* `engine.tick_draws` with pedestrians on walks JAX's key chain
  (`jax.random` only): the pedestrian step's split and its 14 seeds,
  for one key and for a [B, 2] stack; with pedestrians off the chain is
  the one without them.
* `step_pedestrians_plain` against the jitted JAX `step_pedestrians`,
  bit for bit on all eight planes, `ped_block` and `ped_count`: the
  crossroad's cell types and ragged random grids, numpy-seeded counts of
  0-2000 (and 0-20000, where the fused and the unfused keep split
  differ), random stop maps, one tick and five chained ticks.  XLA's
  CPU compiler fuses the keep split's multiply-add where the split
  moves walkers and not where it leaves the rest (see the module
  docstring of `agents/pedestrians.py`); the dense case shows both.
* The plain step given the cached sidewalk count (`Grid.n_side`)
  against the jitted JAX step; the count as the world's statics cache
  it, a port-only leaf.
* The wrapper's batched forms (shared and per-world `cell_type`, and
  under `torch.func.vmap`) against the single-world plain version.
* Whole runs held to the JAX digest `data/ped_digest.json`
  (`tools/make_torch_ped_digest.py`): the crossroad with pedestrians
  (20 ticks, with crossers blocking a road cell on some tick), the
  crossroad without traffic (40 ticks), config #1 at 100x100 (seeds 0-3
  at init; seed 0 after 200 ticks, slow) and config #3 at 256x256
  (init, 100 and 200 ticks, slow).  A B = 2 shared-geometry batch with
  pedestrians equals its two single-world runs.

The only JAX compile here is `step_pedestrians` on grids of at most
64x64; the JAX runs come from the digest.
"""

import functools
import hashlib
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu.agents import pedestrians as JP
from trafficsimulation_tpu.config import Config as JConfig

from trafficsimulation_tpu_torch import codes as C
from trafficsimulation_tpu_torch import prng, sim
from trafficsimulation_tpu_torch.agents import pedestrians as P
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core import transfer
from trafficsimulation_tpu_torch.core.state import sidewalk_count
from trafficsimulation_tpu_torch.core.synth import crossroad_world
from trafficsimulation_tpu_torch.core.transfer import world_to_numpy
from trafficsimulation_tpu_torch.ops import engine
from trafficsimulation_tpu_torch.ops import hopper_engine as HE
from trafficsimulation_tpu_torch.parallel import mesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGEST = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data",
                      "ped_digest.json")
PED_KW = dict(PEDESTRIANS_ENABLED=True, PEDESTRIANS_PER_DAY=2_000_000)
# every cell code the step tells apart, sidewalks the most common
CODES = np.array([C.SIDEWALK] * 3 + [C.BLOCK_ENTRANCE, C.TRAFFIC_LIGHT,
                                     C.CONTROLLED_ROAD, C.R1, C.R2, C.R3,
                                     C.INTERSECTION, C.NOTHING, C.WALL],
                 np.uint8)


@functools.cache
def _digest() -> dict:
    with open(DIGEST) as f:
        return json.load(f)


def _cfg(kw: dict) -> Config:
    return Config(**{k: (tuple(tuple(p) for p in v)
                         if k == "CAP_OVERRIDES" else v)
                     for k, v in kw.items()})


def _assert_digest(name: str, digest: dict, world):
    """Every leaf's dtype, shape and sha256 against the digest (f32
    leaves too: exact)."""
    got = world_to_numpy(world)
    assert set(got) == set(digest), (name, sorted(set(got) ^ set(digest)))
    bad = [k for k, d in digest.items()
           if str(got[k].dtype) != d["dtype"]
           or list(got[k].shape) != d["shape"]
           or hashlib.sha256(got[k].tobytes()).hexdigest() != d["sha256"]]
    assert not bad, f"{name}: leaves differ from JAX's digest: {bad}"


# ---- the key chain ---------------------------------------------------------

def _jax_chain(cfg, key, n):
    """JAX's per-tick draws the port carries (the seeds and the
    pedestrian seeds) and the final key, with `jax.random` only."""
    seeds, peds = [], []
    for _ in range(n):
        ks = jax.random.split(key, 6)
        key, k_mal = ks[0], ks[1]
        seeds.append(np.asarray(jax.random.bits(k_mal, (4,), jnp.uint32)))
        if cfg.PEDESTRIANS_ENABLED:
            key, k_ped = jax.random.split(key)
            kq = jax.random.split(k_ped, 3)
            peds.append(np.concatenate([
                np.asarray(jax.random.bits(kq[i], (n_,), jnp.uint32))
                for i, n_ in enumerate((4, 8, 2))]))
        else:
            peds.append(np.zeros(14, np.uint32))
        key, _ = jax.random.split(key)
    return np.stack(seeds), np.stack(peds), np.asarray(key)


@pytest.mark.parametrize("peds", [True, False])
@pytest.mark.parametrize("batch", [False, True])
def test_tick_draws_match_jax_key_chain(peds, batch):
    cfg = Config(PEDESTRIANS_ENABLED=peds)
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in (3, 11)])
    draws, last = engine.tick_draws(cfg, keys if batch else keys[0], 3)
    for b in range(2 if batch else 1):
        seeds, ped, key = _jax_chain(cfg, jnp.asarray(keys[b]), 3)
        row = draws[b] if batch else draws
        assert np.array_equal(row[:, engine.D_SEEDS:engine.D_SEEDS + 4],
                              seeds.astype(np.int64))
        assert np.array_equal(row[:, engine.D_PED:engine.D_PED + 14],
                              ped.astype(np.int64))
        assert np.array_equal(last[b] if batch else last, key)
    assert engine.D_PED + 14 == engine.N_DRAWS


# ---- one step against the jitted JAX step ----------------------------------

@functools.cache
def _jax_step(H: int, W: int):
    jcfg = JConfig(WIDTH=W, HEIGHT=H, **PED_KW)
    return jax.jit(lambda w, c, ct, st, k: JP.step_pedestrians(
        jcfg, H, W, JP.Pedestrians(walk=w, cross=c), ct, st, k))


def _seeds(key) -> np.ndarray:
    """The step's 14 seeds from its key, as JAX's step draws them."""
    kq = jax.random.split(key, 3)
    return np.concatenate([np.asarray(jax.random.bits(kq[i], (n,),
                                                      jnp.uint32))
                           for i, n in enumerate((4, 8, 2))]).astype(np.int64)


@functools.cache
def _crossroad_cells() -> np.ndarray:
    cfg = Config(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8)
    return crossroad_world(cfg, device="cpu").grid.cell_type.numpy()


def _case(name: str, seed: int):
    """(cell_type, stop_map, walk, cross) numpy, seeded."""
    rng = np.random.default_rng(seed)
    if name.startswith("crossroad"):
        cell = _crossroad_cells()
    else:
        H, W = (64, 64) if name == "dense" else (37, 53)
        cell = rng.choice(CODES, size=(H, W))
    H, W = cell.shape
    stop = rng.random((H, W)) < 0.5
    hi = 20_000 if name == "dense" else 2_000
    walk, cross = (rng.integers(0, hi, (4, H, W)).astype(np.int32)
                   for _ in range(2))
    if name == "sparse":
        walk = np.where(rng.random(walk.shape) < 0.05, walk, 0)
        cross = np.where(rng.random(cross.shape) < 0.02, cross, 0)
    return cell, stop, walk.astype(np.int32), cross.astype(np.int32)


def _both(cell, stop, walk, cross, key, n_side=None):
    """JAX's jitted step and the plain step (counting the sidewalks
    itself, or given the cached count `n_side`) on the same inputs."""
    H, W = cell.shape
    peds, blk, cnt = _jax_step(H, W)(jnp.asarray(walk), jnp.asarray(cross),
                                     jnp.asarray(cell), jnp.asarray(stop),
                                     key)
    ref = tuple(np.asarray(a) for a in (peds.walk, peds.cross, blk, cnt))
    got = P.step_pedestrians_plain(
        Config(WIDTH=W, HEIGHT=H, **PED_KW), torch.from_numpy(walk),
        torch.from_numpy(cross), torch.from_numpy(cell),
        torch.from_numpy(stop), torch.from_numpy(_seeds(key)), n_side)
    return ref, tuple(g.numpy() for g in got)


def _assert_same(ref, got):
    for name, a, b in zip(("walk", "cross", "ped_block", "ped_count"), ref,
                          got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), (name, int((a != b).sum()))


@pytest.mark.parametrize("name,seed", [("crossroad", 0), ("ragged", 1),
                                       ("sparse", 2), ("dense", 3),
                                       ("dense", 4)])
def test_step_pedestrians_plain_matches_jitted_jax(name, seed):
    cell, stop, walk, cross = _case(name, seed)
    ref, got = _both(cell, stop, walk, cross, jax.random.PRNGKey(seed))
    _assert_same(ref, got)
    assert ref[2].any() and ref[0].sum() > 0
    if name == "dense":
        # the two roundings of the keep split differ on some cell here
        u = P.uniform_planes(torch.from_numpy(_seeds(jax.random.PRNGKey(
            seed)))[:4], *cell.shape)
        n = torch.from_numpy(walk)
        p = torch.full(cell.shape, P.PED_KEEP_HEADING, dtype=torch.float32)
        assert any(bool((P._sround(n[d], p, u[d], fused=True)
                         != P._sround(n[d], p, u[d])).any())
                   for d in range(4))


@pytest.mark.parametrize("name,seed", [("crossroad", 6), ("ragged", 7),
                                       ("dense", 8)])
def test_step_pedestrians_plain_with_cached_count_matches_jitted_jax(name,
                                                                    seed):
    """The plain step given the world's cached sidewalk count
    (`sidewalk_count`, what `Grid.n_side` holds and the card's wrapper
    passes to the kernel) equals JAX's step, which counts the sidewalks
    itself every tick."""
    cell, stop, walk, cross = _case(name, seed)
    n_side = sidewalk_count(torch.from_numpy(cell))
    assert n_side.dtype == torch.int32 and n_side.shape == ()
    ref, got = _both(cell, stop, walk, cross, jax.random.PRNGKey(seed),
                     n_side)
    _assert_same(ref, got)


def test_step_pedestrians_plain_chained_ticks():
    """Five ticks on the crossroad, each from the JAX step's output."""
    cell, stop, walk, cross = _case("crossroad", 5)
    rng = np.random.default_rng(5)
    for t in range(5):
        stop = rng.random(cell.shape) < 0.5
        ref, got = _both(cell, stop, walk, cross, jax.random.PRNGKey(100 + t))
        _assert_same(ref, got)
        walk, cross = np.array(ref[0]), np.array(ref[1])


@pytest.mark.parametrize("per_world", [False, True])
def test_step_pedestrians_batched_forms_match_single(per_world):
    """`step_pedestrians_batched` and the wrapper under torch.func.vmap
    (CPU tensors: the plain version per world) against the single-world
    plain version, cell_type shared or one plane a world."""
    cfg = Config(WIDTH=53, HEIGHT=37, **PED_KW)
    cases = [_case("ragged", 10 + b) for b in range(3)]
    cells = torch.from_numpy(np.stack([c[0] for c in cases]))
    cell = cells if per_world else cells[0]
    stop, walk, cross = (torch.from_numpy(np.stack([c[i] for c in cases]))
                         for i in (1, 2, 3))
    seeds = torch.from_numpy(np.stack([_seeds(jax.random.PRNGKey(b))
                                       for b in range(3)]))
    n_side = sidewalk_count(cell)
    singles = [P.step_pedestrians_plain(
        cfg, walk[b], cross[b], cells[b] if per_world else cell, stop[b],
        seeds[b]) for b in range(3)]
    gd = 0 if per_world else None
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            mapped = torch.func.vmap(
                lambda w, c, g, s, k, n: HE.step_pedestrians(cfg, w, c, g, s,
                                                             k, n),
                in_dims=(0, 0, gd, 0, 0, gd))(
                    walk, cross, cell, stop, seeds, n_side)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    batched = HE.step_pedestrians_batched(cfg, walk, cross, cell, stop, seeds,
                                          n_side)
    for out in (mapped, batched):
        for b in range(3):
            for a, s in zip(out, singles[b]):
                assert torch.equal(a[b], s)


# ---- the kernel's tiled pass, emulated --------------------------------------

_TX, _TY = 32, 8                 # csrc/pedestrians.cu TX, TY
_NT, _NR = _TX * _TY, 2 * (_TX + _TY)
_DY, _DX = (1, 0, -1, 0), (0, 1, 0, -1)


def _sources(cell, stop, walk, cross, seeds):
    """What every cell sends along each heading (walkers, crossers) and
    keeps, as `source` in csrc/pedestrians.cu computes it, for all cells
    at once: [4, H, W] each."""
    H, W = cell.shape
    u = P.uniform_planes(seeds, H, W)
    f32 = torch.float32
    walkable = torch.isin(cell, torch.tensor(
        [C.SIDEWALK, C.BLOCK_ENTRANCE, C.TRAFFIC_LIGHT], dtype=cell.dtype))
    roady = torch.isin(cell, torch.tensor(
        [C.CONTROLLED_ROAD, C.R1, C.R2, C.R3, C.INTERSECTION],
        dtype=cell.dtype))
    entry = (cell == C.CONTROLLED_ROAD) & stop
    aw = [P._ahead(walkable, d) for d in range(4)]
    ar = [P._ahead(roady, d) for d in range(4)]
    ac = [P._ahead(entry, d) for d in range(4)]
    n_alt = sum(a.to(torch.int32) for a in aw)
    keep = torch.tensor(P.PED_KEEP_HEADING, dtype=f32)
    sw, sc, kw, kc, m = [], [], [], [], torch.zeros_like(walk[0])
    for d in range(4):
        n, c = walk[d], cross[d]
        moves = aw[d] | ac[d]
        k = torch.where(moves, P._sround(n, keep, u[d], fused=True), 0)
        rest = torch.where(moves, n - P._sround(n, keep, u[d]), n)
        sw.append(torch.where(aw[d], k + c, 0))
        sc.append(torch.where(aw[d], 0, k) + torch.where(ar[d], c, 0))
        kw.append(torch.where(n_alt > 0, 0, rest))
        kc.append(torch.where(aw[d] | ar[d], 0, c))
        m = m + torch.where(n_alt > 0, rest, 0)
    rem = n_alt
    for d in range(4):
        part = P._sround(m, 1.0 / torch.clamp(rem, min=1).to(f32), u[4 + d])
        take = torch.where(aw[d], torch.where(rem == 1, m, part), 0)
        sw[d] = sw[d] + take
        m, rem = m - take, rem - aw[d].to(torch.int32)
    return (torch.stack(sw), torch.stack(sc), torch.stack(kw),
            torch.stack(kc), u)


def _tiled_step(cfg, walk, cross, cell, stop, seeds, n_side):
    """csrc/pedestrians.cu's block structure on the CPU: per 32 x 8 tile,
    thread t < 256 a tile cell (sends along every heading), the next 80
    the ring (each along its one heading into the tile), into a sources'
    region that starts poisoned; then each tile cell gathers from its
    four upstream neighbours (a poisoned read fails), thins and
    spawns."""
    H, W = cell.shape
    SW, SC, KW, KC, u = _sources(cell, stop, walk, cross, seeds)
    poison = -(1 << 30)
    nw, nc = torch.full_like(walk, poison), torch.full_like(cross, poison)
    for y0 in range(0, H, _TY):
        for x0 in range(0, W, _TX):
            ow = torch.full((4, _TY + 2, _TX + 2), poison, dtype=torch.int32)
            oc = ow.clone()
            for t in range(_NT + _NR):
                if t < _NT:
                    sy, sx, dl = 1 + t // _TX, 1 + t % _TX, None
                else:
                    r = t - _NT
                    if r < _TX:
                        sy, sx, dl = 0, 1 + r, 0
                    elif r < 2 * _TX:
                        sy, sx, dl = _TY + 1, 1 + r - _TX, 2
                    elif r < 2 * _TX + _TY:
                        sy, sx, dl = 1 + r - 2 * _TX, 0, 1
                    else:
                        sy, sx, dl = 1 + r - 2 * _TX - _TY, _TX + 1, 3
                gy, gx = y0 - 1 + sy, x0 - 1 + sx
                if not (0 <= gy < H and 0 <= gx < W):
                    continue
                ds = range(4) if dl is None else (dl,)
                for d in ds:
                    ow[d, sy, sx] = SW[d, gy, gx]
                    oc[d, sy, sx] = SC[d, gy, gx]
            for t in range(_NT):
                sy, sx = 1 + t // _TX, 1 + t % _TX
                gy, gx = y0 - 1 + sy, x0 - 1 + sx
                if not (gy < H and gx < W):
                    continue
                for d in range(4):
                    a, b = KW[d, gy, gx], KC[d, gy, gx]
                    uy, ux = gy - _DY[d], gx - _DX[d]
                    if 0 <= uy < H and 0 <= ux < W:
                        got_w = ow[d, sy - _DY[d], sx - _DX[d]]
                        got_c = oc[d, sy - _DY[d], sx - _DX[d]]
                        assert got_w != poison and got_c != poison
                        a, b = a + got_w, b + got_c
                    nw[d, gy, gx], nc[d, gy, gx] = a, b
    p_die = torch.tensor(np.float32(1.0 / P.PED_MEAN_LIFE_TICKS))
    nw = torch.stack([nw[d] - P._sround(nw[d], p_die, u[8 + d])
                      for d in range(4)])
    side = cell == C.SIDEWALK
    p_cell = torch.tensor(P.spawn_rate(cfg)) / torch.clamp(
        n_side, min=1).to(torch.float32)
    born = side & (u[12] < p_cell)
    h = (u[13] * 4.0).to(torch.int32)
    nw = nw + torch.stack([(born & (h == d)).to(torch.int32)
                           for d in range(4)])
    csum = nc.sum(0, dtype=torch.int32)
    return nw, nc, csum > 0, nw.sum(0, dtype=torch.int32) + csum


@pytest.mark.parametrize("name,seed,shape", [
    ("ragged", 21, None), ("sparse", 22, None), ("crossroad", 23, None),
    ("ragged", 24, (8, 32)), ("ragged", 25, (9, 33))])
def test_tiled_pass_emulation_matches_plain(name, seed, shape):
    """The redesigned kernel's structure (a tile and its ring of source
    cells, each computing its splits once, then a gather from shared
    memory), emulated on the CPU, equals the plain step: every upstream
    read is one the ring or the tile wrote, on grids that are ragged,
    exactly one tile, and one cell past a tile each way."""
    cell, stop, walk, cross = _case(name, seed)
    if shape is not None:
        cell, stop = cell[:shape[0], :shape[1]], stop[:shape[0], :shape[1]]
        walk, cross = walk[:, :shape[0], :shape[1]], cross[:, :shape[0],
                                                           :shape[1]]
    H, W = cell.shape
    cfg = Config(WIDTH=W, HEIGHT=H, **PED_KW)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (walk, cross, cell, stop)) + (
        torch.from_numpy(_seeds(jax.random.PRNGKey(seed))),)
    ref = P.step_pedestrians_plain(cfg, *args)
    got = _tiled_step(cfg, *args, sidewalk_count(args[2]))
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


# ---- whole runs against the digest -----------------------------------------

def _cross_cfg(name: str) -> Config:
    return _cfg(_digest()[name]["cfg"])


def _cross_ped_run():
    """The crossroad with pedestrians, 20 ticks, and the road cells the
    crossers blocked on each tick (K1's ped_block argument)."""
    cfg = _cross_cfg("cross_ped")
    world = crossroad_world(cfg, device="cpu")
    blocked = []
    orig = HE.decide_move

    def spy(cfg_, sdir4, wnd, planes, stop, rain, ped, *a, **k):
        blocked.append(int((ped & world.grid.is_road).sum()))
        return orig(cfg_, sdir4, wnd, planes, stop, rain, ped, *a, **k)
    HE.decide_move = spy
    try:
        end = sim.run_chunk(cfg, world, _digest()["cross_ped"]["ticks"])
    finally:
        HE.decide_move = orig
    return world, end, blocked


def test_crossroad_with_pedestrians_matches_jax_digest():
    d = _digest()["cross_ped"]
    world, end, blocked = _cross_ped_run()
    _assert_digest("crossroad with pedestrians at init", d["init"], world)
    _assert_digest(f"crossroad with pedestrians after {d['ticks']} ticks",
                   d["end"], end)
    assert len(blocked) == d["ticks"] and max(blocked) > 0, blocked
    assert int(end.peds.walk.sum() + end.peds.cross.sum()) \
        == d["counts"]["active_pedestrians"]


def test_crossroad_without_traffic_matches_jax_digest():
    d = _digest()["cross_notraffic"]
    cfg = _cross_cfg("cross_notraffic")
    assert not cfg.ENABLE_TRAFFIC
    world = crossroad_world(cfg, device="cpu")
    _assert_digest("crossroad without traffic at init", d["init"], world)
    end = sim.run_chunk(cfg, world, d["ticks"])
    _assert_digest(f"crossroad without traffic after {d['ticks']} ticks",
                   d["end"], end)
    assert not bool(end.vehicles.active.any())


def test_shared_batch_with_pedestrians_equals_single_runs():
    """A B = 2 shared-geometry batch of the crossroad with pedestrians:
    world b equals the single-world run with key b."""
    cfg = _cross_cfg("cross_ped")
    world = crossroad_world(cfg, device="cpu")
    keys = np.stack([prng.PRNGKey(0), prng.PRNGKey(7)])
    batch = mesh.run_batch_shared(cfg, mesh.tile_dynamic(world, keys), 5)
    for b in range(2):
        w = world.replace(key=torch.from_numpy(keys[b].view(np.int32).copy()))
        single = world_to_numpy(sim.run_chunk(cfg, w, 5))
        got = world_to_numpy(mesh.world_at(batch, b))
        bad = [k for k in single if not np.array_equal(single[k], got[k])]
        assert not bad, (b, bad)
    assert tuple(batch.peds.walk.shape) == (2, 4, cfg.HEIGHT, cfg.WIDTH)


@functools.cache
def _config1_worlds():
    d = _digest()["config1"]
    cfg = _cfg(d["cfg"])
    return cfg, [sim.init_world(cfg, prng.PRNGKey(s), "cpu")
                 for s in range(len(d["init"]))]


def test_config1_init_matches_jax_digest():
    """BASELINE config #1 (100x100, no traffic): seeds 0-3 generated by
    the port equal JAX's `init_world`, every leaf."""
    d = _digest()["config1"]
    cfg, worlds = _config1_worlds()
    assert (cfg.WIDTH, cfg.HEIGHT, cfg.ENABLE_TRAFFIC) == (100, 100, False)
    for s, w in enumerate(worlds):
        _assert_digest(f"config #1 seed {s} at init", d["init"][s], w)
    assert int(worlds[0].lights_static.valid.sum()) == d["lights"]


@pytest.mark.slow
def test_config1_run_matches_jax_digest():
    d = _digest()["config1"]
    cfg, worlds = _config1_worlds()
    end = sim.run_chunk(cfg, worlds[0], d["ticks"])
    _assert_digest(f"config #1 after {d['ticks']} ticks", d["end"], end)


@pytest.mark.slow
def test_config3_matches_jax_digest():
    """BASELINE config #3 as `bench_config3` builds it (256x256, 4000
    vehicles, pedestrians at 200k a day): init, then two chunks of 100
    ticks."""
    d = _digest()["config3"]
    base = Config(WIDTH=256, HEIGHT=256, MAX_VEHICLES=4096,
                  MAX_FIELD_DESTS=640, PEDESTRIANS_ENABLED=True,
                  PEDESTRIANS_PER_DAY=200_000)
    world = sim.init_world(base, prng.PRNGKey(d["seed"]), "cpu")
    cfg, world = sim.measure_and_shrink(base, world)
    assert cfg == _cfg(d["cfg"])
    world = sim.inject_vehicles(cfg, world, d["n_vehicles"])
    _assert_digest("config #3 at init", d["init"], world)
    for t in (d["chunk"], 2 * d["chunk"]):
        world = sim.run_chunk(cfg, world, d["chunk"])
        _assert_digest(f"config #3 after {t} ticks", d[f"tick{t}"], world)
        assert int(world.peds.walk.sum() + world.peds.cross.sum()) \
            == d[f"counts{t}"]["active_pedestrians"]


def test_sidewalk_count_is_cached_with_the_statics():
    """`Grid.n_side` is counted where the world is built (`init_world`'s
    assembly: config #1's seeds; the crossroad) and equals the SIDEWALK
    cells of its cell plane; it is a port-only leaf: `world_to_numpy`
    leaves it out (the JAX digests' leaf sets hold) and
    `world_from_numpy` counts it again."""
    _, worlds = _config1_worlds()
    cross = crossroad_world(_cross_cfg("cross_ped"), device="cpu")
    for w in (*worlds, cross):
        n = w.grid.n_side
        assert n.dtype == torch.int32 and n.shape == ()
        assert int(n) == int((w.grid.cell_type == C.SIDEWALK).sum()) > 0
        leaves = world_to_numpy(w)
        assert "grid.n_side" not in leaves
        back = transfer.world_from_numpy(leaves, "cpu")
        assert torch.equal(back.grid.n_side, n)
    assert transfer.PORT_ONLY == {"grid.n_side"}


def test_pedestrian_planes_follow_the_config():
    """[4, H, W] planes while pedestrians are on, the [4, 1, 1] stub
    while they are off, as JAX's `init_pedestrians`."""
    on = P.init_pedestrians(5, 7, True, device="cpu")
    off = P.init_pedestrians(5, 7, False, device="cpu")
    jon, joff = JP.init_pedestrians(5, 7, True), JP.init_pedestrians(5, 7,
                                                                       False)
    assert tuple(on.walk.shape) == jon.walk.shape == (4, 5, 7)
    assert tuple(off.cross.shape) == joff.cross.shape == (4, 1, 1)
    assert int(P.total_pedestrians(on)) == 0
    assert P.spawn_rate(Config(PEDESTRIANS_PER_DAY=200_000)) == np.float32(
        200_000 / (86400 // JConfig().TIME_PER_STEP_IN_SECONDS))
