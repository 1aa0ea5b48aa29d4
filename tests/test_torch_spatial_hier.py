"""One world under hierarchical routing split over ranks by rows (the
port's `parallel/spatial.py`) against the port's unsharded run and JAX.

The ranks are processes started by `launch.spawn` with backend "gloo" and
`device="cpu"`, one spawn of 4 ranks for every case (`ranks.spatial`);
each city is built once here, written with `ranks.save_world` and loaded
by rank 0:

* the 64^2 city of `test_torch_hier.py` (HIER_TILE 16, HIER_LMAX 8,
  `init_world_hier` from key 0, 200 vehicles injected), 20 ticks over 2
  and 4 ranks, against the unsharded `run_chunk` (every leaf by sha256,
  f32 included) and against `data/spatial_hier_digest.json`
  (`tools/make_torch_spatial_digest.py --cases hier`: JAX's
  `spatial_chunk_fn` on 8 CPU devices; every integer leaf by sha256, the
  start state too); the vehicles whose row changes owner are counted on
  the unsharded run, so that the case cannot pass vacuously;
* the same city with HIER_TILE 32 over 4 ranks: rank 2's decide window
  starts at row 16, inside a tile, so that K1-hier's select must take
  its tile rows from the window's first world row (`hier_rows(row0)`);
  a select that added the window's first tile instead would pass every
  16-row-tile split, whose windows all start on a tile edge.

Then, in this process: `hier_rows` and `hier_select` on windows cut at
rows inside a tile against the whole grid's rows, and each rank's
residency and collectives.  No JAX compile.
"""

import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from trafficsimulation_tpu_torch import prng, sim
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core.transfer import world_to_numpy
from trafficsimulation_tpu_torch.ops import hier
from trafficsimulation_tpu_torch.parallel import launch, ranks, spatial

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(__file__), "..",
                    "trafficsimulation_tpu_torch", "data")
N_RANKS = 4
SPLITS = (2, 4)
# tools/make_torch_spatial_digest.py's `hier` case
KW = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
          MAX_VEHICLES=256, ROUTING_HIER=True, HIER_TILE=16, HIER_LMAX=8,
          INTERNAL_POPULATION_TRAFFIC_PER_DAY=2000,
          PASSING_POPULATION_TRAFFIC_PER_DAY=500)
KEY, VEHICLES, TICKS = 0, 200, 20
TILES = (16, 32)


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


@functools.cache
def _city(tile: int) -> tuple:
    """(shrunk cfg, the start world with its vehicles, the unsharded end
    state's leaves, per split size the vehicles whose row changed owner
    between two routing segments)."""
    cfg, w = sim.init_world_hier(Config(**dict(KW, HIER_TILE=tile)),
                                 prng.PRNGKey(KEY), "cpu")
    w0 = sim.inject_vehicles(cfg, w, VEHICLES)
    w, seen = w0, [w0.vehicles]
    R = cfg.PATHFINDING_COOLDOWN
    for _ in range(TICKS // R):
        w = sim.run_chunk(cfg, w, R)
        seen.append(w.vehicles)
    crossings = {}
    for n in SPLITS:
        rows = cfg.HEIGHT // n
        crossings[n] = sum(int((a.active & b.active & (
            a.pos // cfg.WIDTH // rows != b.pos // cfg.WIDTH // rows))
            .sum()) for a, b in zip(seen, seen[1:]))
    return cfg, w0, world_to_numpy(w), crossings


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank's results: the 16-row-tile city over 2 and 4 ranks,
    the 32-row-tile city over 4."""
    d = tmp_path_factory.mktemp("hier_worlds")
    jobs = []
    for tile, splits in ((16, SPLITS), (32, (N_RANKS,))):
        cfg, w0, _, _ = _city(tile)
        path = str(d / f"tile{tile}.pt")
        ranks.save_world(w0, path)
        jobs.append(dict(kind="spatial", cfg=cfg, ticks=TICKS, world="file",
                         path=path, splits=splits))
    return launch.spawn(ranks.run_jobs, N_RANKS, "gloo", device="cpu",
                        args=(jobs,), threads=1)


def _same(name: str, ref: dict, got: dict):
    assert set(ref) == set(got), f"{name}: {sorted(set(ref) ^ set(got))}"
    bad = [k for k, a in ref.items() if got[k]["sha256"] != _sha(a)
           or got[k]["shape"] != list(a.shape)]
    assert not bad, f"{name}: leaves differ from the unsharded run: {bad}"


@pytest.mark.parametrize("n", SPLITS)
def test_hier_split_equals_unsharded(spawned, n):
    """The 64^2 hierarchical city split over n ranks for 20 ticks equals
    the unsharded run on every leaf, `local_sdir4` and `dests.rid`
    among them, and vehicles did cross the slab boundaries."""
    _, _, ref, crossings = _city(16)
    assert crossings[n] > 0, crossings
    assert "local_sdir4" in ref and "dests.rid" in ref
    _same(f"hierarchical city over {n} ranks", ref,
          spawned[0][0][str(n)]["digests"])


@pytest.mark.parametrize("n", SPLITS)
def test_hier_split_matches_jax(spawned, n):
    """...and JAX's `spatial_chunk_fn` of the same city on 8 devices on
    every integer leaf (its start state too: the port builds JAX's
    world)."""
    with open(os.path.join(DATA, "spatial_hier_digest.json")) as f:
        dig = json.load(f)
    assert (dig["devices"], dig["ticks"], dig["vehicles"], dig["key"]) == \
        (8, TICKS, VEHICLES, KEY) and dig["cfg"] == KW
    _, w0, _, _ = _city(16)
    start = world_to_numpy(w0)
    got = spawned[0][0][str(n)]["digests"]
    for name, mine, want in (("start", {k: {"sha256": _sha(a), "dtype": str(
            a.dtype)} for k, a in start.items()}, dig["init"]),
            ("end", got, dig["digest"])):
        assert set(mine) == set(want), (name, set(mine) ^ set(want))
        ints = [k for k, d in want.items() if "float" not in d["dtype"]]
        assert len(ints) > 50
        bad = [k for k in ints if (mine[k]["sha256"], mine[k]["dtype"])
               != (want[k]["sha256"], want[k]["dtype"])]
        assert not bad, (name, bad)


def test_tile32_split_windows_inside_a_tile(spawned):
    """32-row tiles over 4 ranks: rank 2's decide window starts at row
    16, inside a tile, and every leaf of the split equals the unsharded
    run (a select that read the window's own row 0 as the world's would
    route its cells by the wrong tile)."""
    cfg, _, ref, crossings = _city(32)
    P, _ = spatial.halo_widths(cfg)
    res = [o[1][str(N_RANKS)] for o in spawned]
    assert tuple(res[2]["dec"]) == (32 - P, 64) == (16, 64)
    assert res[2]["dec"][0] % cfg.HIER_TILE != 0
    assert crossings[N_RANKS] > 0
    _same("32-row tiles over 4 ranks", ref, res[0]["digests"])


@pytest.mark.parametrize("tile", TILES)
def test_hier_rows_on_windows(tile):
    """`hier_rows` and `hier_select` on windows whose first row lies
    inside a tile (and on a tile edge) give the whole grid's rows there
    when told the window's first world row, and the wrong ones for some
    cell when not."""
    cfg = Config(**dict(KW, HIER_TILE=tile))
    hp = hier.hier_params(cfg)
    H, W = cfg.HEIGHT, cfg.WIDTH
    rng = np.random.default_rng(tile)
    dest = torch.from_numpy(rng.integers(0, hp.direct_base + 30, (H, W))
                            .astype(np.int32))
    local4 = torch.from_numpy(rng.integers(-2**31, 2**31, (
        9 * hp.lmax // 4, H, W), dtype=np.int64).astype(np.int32))
    dense4 = torch.from_numpy(rng.integers(-2**31, 2**31, (
        (hp.nr + 30 + 3) // 4, H, W), dtype=np.int64).astype(np.int32))
    p, r = hier.hier_rows(cfg, dest)
    sel = hier.hier_select(cfg, dense4, local4, dest)
    off_tile = 0
    for lo, hi in ((16, 64), (8, 40), (0, 24), (32, 48)):
        sl = slice(lo, hi)
        pw, rw = hier.hier_rows(cfg, dest[sl], row0=lo)
        assert torch.equal(pw, p[sl]) and torch.equal(rw, r[sl]), (lo, hi)
        assert torch.equal(hier.hier_select(
            cfg, dense4[:, sl], local4[:, sl], dest[sl], row0=lo), sel[sl])
        p0, _ = hier.hier_rows(cfg, dest[sl])
        if lo % tile:
            off_tile += 1
            assert not torch.equal(p0, p[sl]), (lo, hi)
    assert off_tile == (2 if tile == 32 else 1)


@pytest.mark.parametrize("job,splits", [(0, SPLITS), (1, (N_RANKS,))])
def test_hier_residency_and_collectives(spawned, job, splits):
    """Each rank holds the dense key stack and `local_sdir4` over its
    decide window alone, its rows are its share, and every rank made the
    same collectives: per tick the light reductions, the decide halo and
    the post-move's, per segment the routing halo, once the entry and
    the exit."""
    cfg, w0, _, _ = _city(TILES[job])
    P, _ = spatial.halo_widths(cfg)
    H, W = cfg.HEIGHT, cfg.WIDTH
    D, LD4 = w0.cost_field.shape[0], w0.local_sdir4.shape[0]
    segs = -(-TICKS // cfg.PATHFINDING_COOLDOWN)
    for n in splits:
        res = [o[job][str(n)] for o in spawned[:n]]
        assert all(o[job][str(n)] is None for o in spawned[n:])
        for r, x in enumerate(res):
            lo, hi = spatial.rows_of(H, n, r)
            assert tuple(x["own"]) == (lo, hi)
            d0, d1 = max(0, lo - P), min(H, hi + P)
            assert tuple(x["dec"]) == (d0, d1)
            assert x["cost_field_shape"] == (D, 4, d1 - d0, W)
            assert x["local_sdir4_shape"] == (LD4, d1 - d0, W)
            assert x["local_sdir4_bytes"] == LD4 * (d1 - d0) * W * 4
            assert x["stats"]["all_reduce"] == 3 * TICKS + segs + 2
            assert x["launches"] == res[0]["launches"]
