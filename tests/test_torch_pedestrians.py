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


def _both(cell, stop, walk, cross, key):
    H, W = cell.shape
    peds, blk, cnt = _jax_step(H, W)(jnp.asarray(walk), jnp.asarray(cross),
                                     jnp.asarray(cell), jnp.asarray(stop),
                                     key)
    ref = tuple(np.asarray(a) for a in (peds.walk, peds.cross, blk, cnt))
    got = P.step_pedestrians_plain(
        Config(WIDTH=W, HEIGHT=H, **PED_KW), torch.from_numpy(walk),
        torch.from_numpy(cross), torch.from_numpy(cell),
        torch.from_numpy(stop), torch.from_numpy(_seeds(key)))
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
    singles = [P.step_pedestrians_plain(
        cfg, walk[b], cross[b], cells[b] if per_world else cell, stop[b],
        seeds[b]) for b in range(3)]
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            mapped = torch.func.vmap(
                lambda w, c, g, s, k: HE.step_pedestrians(cfg, w, c, g, s, k),
                in_dims=(0, 0, 0 if per_world else None, 0, 0))(
                    walk, cross, cell, stop, seeds)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    batched = HE.step_pedestrians_batched(cfg, walk, cross, cell, stop, seeds)
    for out in (mapped, batched):
        for b in range(3):
            for a, s in zip(out, singles[b]):
                assert torch.equal(a[b], s)


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


def test_pedestrian_planes_follow_the_config():
    """[4, H, W] planes while pedestrians are on, the [4, 1, 1] stub
    while they are off, as JAX's `init_pedestrians`."""
    on = P.init_pedestrians(5, 7, True)
    off = P.init_pedestrians(5, 7, False)
    jon, joff = JP.init_pedestrians(5, 7, True), JP.init_pedestrians(5, 7,
                                                                       False)
    assert tuple(on.walk.shape) == jon.walk.shape == (4, 5, 7)
    assert tuple(off.cross.shape) == joff.cross.shape == (4, 1, 1)
    assert int(P.total_pedestrians(on)) == 0
    assert P.spawn_rate(Config(PEDESTRIANS_PER_DAY=200_000)) == np.float32(
        200_000 / (86400 // JConfig().TIME_PER_STEP_IN_SECONDS))
