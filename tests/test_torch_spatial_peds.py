"""One world with pedestrians split over ranks by rows (the port's
`parallel/spatial.py`) against the port's unsharded run and JAX.

The ranks are processes started by `launch.spawn` with backend "gloo" and
`device="cpu"`, one spawn of 4 ranks (`ranks.spatial`, meshes of 2 and
4); the city is built once here, written with `ranks.save_world` and
loaded by rank 0:

* a 64^2 city with config #4's geometry, PEDESTRIANS_ENABLED and
  2,000,000 pedestrians a day (`init_world` from key 1, no shrink, 160
  vehicles injected), 20 ticks over 2 and 4 ranks, against the unsharded
  `run_chunk` (every leaf by sha256, f32 included) and against
  `data/spatial_peds_digest.json` (`tools/make_torch_spatial_digest.py
  --cases peds`: JAX's `spatial_chunk_fn` on 8 CPU devices; every
  integer leaf by sha256, the start state too); the walkers and crossers
  that step across a slab edge are counted on the unsharded run (the
  plain step's flows, `step_pedestrians_plain(flux=True)`), so that the
  case cannot pass vacuously.

Then, in this process: the pedestrian step's reach, from its plain
version on a window cut on both sides against the whole grid (exact at
`engine.PED_REACH` rows, not at one row fewer; the count planes reach 1
row, the cell types and stop map 2), the window's hashed uniforms, and
each rank's residency and collectives.  No JAX compile.
"""

import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from trafficsimulation_tpu_torch import codes as C
from trafficsimulation_tpu_torch import prng, sim
from trafficsimulation_tpu_torch.agents import pedestrians as PD
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core.transfer import world_to_numpy
from trafficsimulation_tpu_torch.ops import engine
from trafficsimulation_tpu_torch.ops import hopper_engine as HE
from trafficsimulation_tpu_torch.parallel import launch, ranks, spatial

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(__file__), "..",
                    "trafficsimulation_tpu_torch", "data")
N_RANKS = 4
SPLITS = (2, 4)
# tools/make_torch_spatial_digest.py's `peds` case
KW = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
          MAX_FIELD_DESTS=32, MAX_VEHICLES=256,
          INTERNAL_POPULATION_TRAFFIC_PER_DAY=2000,
          PASSING_POPULATION_TRAFFIC_PER_DAY=500,
          PEDESTRIANS_ENABLED=True, PEDESTRIANS_PER_DAY=2_000_000)
CFG = Config(**KW)
KEY, VEHICLES, TICKS = 1, 160, 20


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


@functools.cache
def _city() -> tuple:
    """(the start world, the unsharded end state's leaves, per split size
    the pedestrians that stepped across a slab edge)."""
    w0 = sim.inject_vehicles(CFG, sim.init_world(CFG, prng.PRNGKey(KEY),
                                                 "cpu"), VEHICLES)
    flows = []
    step = HE.step_pedestrians

    def spy(cfg, walk, cross, cell_type, stop_map, seeds, n_side, row0=0):
        flows.append(PD.step_pedestrians_plain(
            cfg, walk, cross, cell_type, stop_map, seeds, n_side, row0,
            flux=True)[4])
        return step(cfg, walk, cross, cell_type, stop_map, seeds, n_side,
                    row0)
    HE.step_pedestrians = spy
    try:
        end = sim.run_chunk(CFG, w0, TICKS)
    finally:
        HE.step_pedestrians = step
    assert len(flows) == TICKS
    crossed = {}
    for n in SPLITS:
        h = CFG.HEIGHT // n
        # heading 0 (+y) leaves row b h - 1 for row b h, heading 2 (-y)
        # the other way
        crossed[n] = sum(int(f[0, b * h - 1].sum() + f[2, b * h].sum())
                         for f in flows for b in range(1, n))
    return w0, world_to_numpy(end), crossed


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ped_world") / "city.pt")
    ranks.save_world(_city()[0], path)
    return launch.spawn(ranks.run_jobs, N_RANKS, "gloo", device="cpu",
                        args=([dict(kind="spatial", cfg=CFG, ticks=TICKS,
                                    world="file", path=path,
                                    splits=SPLITS)],), threads=1)


@pytest.mark.parametrize("n", SPLITS)
def test_peds_split_equals_unsharded(spawned, n):
    """The 64^2 pedestrian city split over n ranks for 20 ticks equals
    the unsharded run on every leaf, the count planes among them, and
    pedestrians did step across the slab edges."""
    _, ref, crossed = _city()
    assert crossed[n] > 0, crossed
    assert ref["peds.walk"].shape == (4, 64, 64) and ref["peds.walk"].any()
    got = spawned[0][0][str(n)]["digests"]
    assert set(ref) == set(got), sorted(set(ref) ^ set(got))
    bad = [k for k, a in ref.items() if got[k]["sha256"] != _sha(a)
           or got[k]["shape"] != list(a.shape)]
    assert not bad, f"{n} ranks: leaves differ from the unsharded run: {bad}"


@pytest.mark.parametrize("n", SPLITS)
def test_peds_split_matches_jax(spawned, n):
    """...and JAX's `spatial_chunk_fn` of the same city on 8 devices on
    every integer leaf (its start state too)."""
    with open(os.path.join(DATA, "spatial_peds_digest.json")) as f:
        dig = json.load(f)
    assert (dig["devices"], dig["ticks"], dig["vehicles"], dig["key"]) == \
        (8, TICKS, VEHICLES, KEY) and dig["cfg"] == KW
    start = world_to_numpy(_city()[0])
    got = spawned[0][0][str(n)]["digests"]
    for name, mine, want in (("start", {k: {"sha256": _sha(a), "dtype": str(
            a.dtype)} for k, a in start.items()}, dig["init"]),
            ("end", got, dig["digest"])):
        assert set(mine) == set(want), (name, set(mine) ^ set(want))
        ints = [k for k, d in want.items() if "float" not in d["dtype"]]
        assert "peds.walk" in ints and "peds.cross" in ints
        bad = [k for k in ints if (mine[k]["sha256"], mine[k]["dtype"])
               != (want[k]["sha256"], want[k]["dtype"])]
        assert not bad, (name, bad)


def test_peds_residency_and_collectives(spawned):
    """Each rank holds its own rows of the count planes, and every rank
    made the same collectives as a world without pedestrians: the counts
    ride in the decide halo and the routing halo, so per tick the light
    reductions, the decide halo and the post-move's, per segment the
    routing halo, once the entry and the exit."""
    segs = -(-TICKS // CFG.PATHFINDING_COOLDOWN)
    for n in SPLITS:
        res = [o[0][str(n)] for o in spawned[:n]]
        for r, x in enumerate(res):
            assert tuple(x["own"]) == spatial.rows_of(CFG.HEIGHT, n, r)
            assert x["stats"]["all_reduce"] == 3 * TICKS + segs + 2
            assert x["launches"] == res[0]["launches"]
            assert x["local_sdir4_bytes"] is None


WALK_TYPES = (C.SIDEWALK, C.BLOCK_ENTRANCE, C.TRAFFIC_LIGHT)
ROAD_TYPES = (C.CONTROLLED_ROAD, C.R1, C.R2, C.R3, C.INTERSECTION)


def _ped_inputs(seed: int, H: int, W: int):
    """Random count planes (up to 6 a heading), cell types (two thirds
    walkable, a quarter roads, the rest neither), stop map and seeds."""
    rng = np.random.default_rng(seed)
    kinds = np.array(WALK_TYPES * 4 + ROAD_TYPES * 2 + (0,), np.uint8)
    cell = kinds[rng.integers(0, len(kinds), (H, W))]
    walk = rng.integers(0, 7, (4, H, W)).astype(np.int32)
    cross = (rng.integers(0, 7, (4, H, W))
             * (rng.random((4, H, W)) < 0.5)).astype(np.int32)
    stop = rng.random((H, W)) < 0.5
    seeds = rng.integers(0, 2**32, 14, dtype=np.int64)
    return (torch.from_numpy(walk), torch.from_numpy(cross),
            torch.from_numpy(cell), torch.from_numpy(stop),
            torch.from_numpy(seeds))


def _step_rows(inp, n_side, lo, hi, counts=None):
    """The plain step on rows [lo, hi) as if they were the world (the
    count planes zeroed outside `counts`, a [lo, hi) of their own)."""
    walk, cross, cell, stop, seeds = inp
    w, c = walk[:, lo:hi].clone(), cross[:, lo:hi].clone()
    if counts is not None:
        keep = torch.zeros(hi - lo, dtype=torch.bool)
        keep[counts[0] - lo:counts[1] - lo] = True
        w, c = w * keep[:, None], c * keep[:, None]
    return PD.step_pedestrians_plain(
        CFG, w, c, cell[lo:hi].contiguous(), stop[lo:hi].contiguous(),
        seeds, n_side, row0=lo)


def test_ped_step_reach_is_ped_reach():
    """The plain step on a window (8 rows widened by PED_REACH, cut on
    both sides) gives the whole grid's outputs on those 8 rows for every
    seed; with one row fewer some output differs.  By input: the count
    planes reach 1 row (exact with counts over 8 + 1 rows and the cell
    types and stop map over 8 + 2), the cell types and stop map 2
    (counts over 8 + 2 and flags over 8 + 1 differ)."""
    R = engine.PED_REACH
    assert R == 2
    H, W = 24, 40
    own = (8, 16)
    n_side = torch.tensor(37, dtype=torch.int32)
    short = {"window": 0, "flags": 0, "counts": 0}
    for seed in range(8):
        inp = _ped_inputs(seed, H, W)
        whole = PD.step_pedestrians_plain(CFG, *inp[:4], inp[4], n_side)
        want = [o[..., own[0]:own[1], :] for o in whole]

        def got(lo, hi, counts=None):
            out = _step_rows(inp, n_side, lo, hi, counts)
            return [o[..., own[0] - lo:own[1] - lo, :] for o in out]

        def same(outs):
            return all(torch.equal(a, b) for a, b in zip(outs, want))
        assert same(got(own[0] - R, own[1] + R)), seed
        assert same(got(own[0] - R, own[1] + R,
                        counts=(own[0] - 1, own[1] + 1))), seed
        short["window"] += not same(got(own[0] - R + 1, own[1] + R - 1))
        # flags over one row, counts over two
        short["flags"] += not same(got(own[0] - 1, own[1] + 1))
        short["counts"] += not same(got(own[0] - R, own[1] + R,
                                        counts=own))
    assert all(v > 0 for v in short.values()), short


def test_window_uniforms_are_the_worlds():
    """A window's hashed uniforms (`row0`) are the whole grid's rows."""
    seeds = torch.tensor([0, 7, 2**32 - 1, 123456789], dtype=torch.int64)
    whole = PD.uniform_planes(seeds, 24, 40)
    part = PD.uniform_planes(seeds, 10, 40, row0=9)
    assert all(torch.equal(a[9:19], b) for a, b in zip(whole, part))
