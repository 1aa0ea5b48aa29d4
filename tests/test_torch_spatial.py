"""One world split over ranks by rows (the port's `parallel/spatial.py`,
JAX's `parallel/spatial.py`) against the port's unsharded run and JAX.

The ranks are processes started by `launch.spawn` with backend "gloo" and
`device="cpu"`, one spawn of 4 ranks for every case (`ranks.spatial`,
meshes of 2 and 4):

* JAX's case, ported: the dry run's crossroad (`dryrun_cfg()`, A2C
  training with an update every tick), 4 ticks, against the port's
  unsharded `run_chunk` (every leaf by sha256, f32 included) and against
  `data/spatial_digest.json` (`tools/make_torch_spatial_digest.py`: JAX's
  `spatial_chunk_fn` on 8 CPU devices; integer leaves by sha256, the
  trained floats within `test_torch_rl_batch.py`'s tolerance);
* vehicles crossing slab edges: a 64^2 city generated by the port with
  config #4's Config (QUEUE_ACTUATED) and 160 vehicles injected, 50
  ticks, every leaf equal to the unsharded run; the crossings counted on
  the unsharded run so that the case cannot pass vacuously;
* the other two RL families on that city, 20 ticks each with narrow nets
  that train inside the run: REINFORCE (19 state columns and the stuck
  penalty, so both planes' flows are group sums) and GAT-DQN, every
  leaf equal to the unsharded run, the trained floats too.

Then, in this process: a one-rank group for the refusals and the
megakernel gate; plain unit tests of the rows, windows, halo widths,
band buffers and index maps (the collectives emulated by summing the
ranks' buffers); and the reach of each stage the halos cover, from
plain versions on a window cut on both sides against the whole grid:
decide + move within P, the routing planes exactly Q (one row fewer
changes the decide window's next-move bytes).  No JAX compile.
"""

import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from trafficsimulation_tpu_torch import prng, sim
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core import synth
from trafficsimulation_tpu_torch.core.transfer import world_to_numpy
from trafficsimulation_tpu_torch.dryrun import TRAINED, dryrun_cfg
from trafficsimulation_tpu_torch.lights import fsm
from trafficsimulation_tpu_torch.ops import engine, megakernel
from trafficsimulation_tpu_torch.ops import hopper_engine as HE
from trafficsimulation_tpu_torch.ops.density import density_map
from trafficsimulation_tpu_torch.parallel import launch, ranks, spatial
from trafficsimulation_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(__file__), "..",
                    "trafficsimulation_tpu_torch", "data")
RTOL, ATOL = 1e-4, 1e-5     # as tests/test_torch_rl_batch.py
N_RANKS = 4
SPLITS = (2, 4)
CROSS_TICKS = 4             # JAX's test_spatial_sharding_matches_unsharded
CITY = Config(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
              MAX_FIELD_DESTS=32, MAX_VEHICLES=256,
              INTERNAL_POPULATION_TRAFFIC_PER_DAY=2000,
              PASSING_POPULATION_TRAFFIC_PER_DAY=500)   # config #4's
CITY_KEY = prng.PRNGKey(1)
CITY_VEHICLES = 160
CITY_TICKS = 50
# the two RL families the crossroad does not run, narrow nets that train
# inside RL_TICKS (the digest's per-world settings,
# tools/make_torch_rl_batch_digest.py)
RL_CITIES = {
    "NEIGHBOR_RL": CITY.replace(
        TRAFFIC_LIGHT_AGENT_ALGORITHM="NEIGHBOR_RL", SRL_HIDDEN_LAYERS=2,
        SRL_HIDDEN_LAYER_SIZE=32, SRL_BATCH_SIZE=8, SRL_UPDATE_EVERY=4,
        SRL_INPUT_DIMENSIONS=19, SRL_PUNISH_STUCK=True),
    "GAT_DQN": CITY.replace(
        TRAFFIC_LIGHT_AGENT_ALGORITHM="GAT_DQN", GAT_BATCH_SIZE=16,
        GAT_MEMORY_CAPACITY=512, EPS_INITIAL=0.5,
        GAT_TARGET_UPDATE_EVERY=4)}
RL_TICKS = 20


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


@functools.cache
def _spawned() -> list:
    """Every rank's results of every case (`ranks.spatial`)."""
    jobs = [dict(kind="spatial", cfg=dryrun_cfg(), ticks=CROSS_TICKS,
                 splits=SPLITS),
            dict(kind="spatial", cfg=CITY, ticks=CITY_TICKS, world="city",
                 key=CITY_KEY, inject=CITY_VEHICLES, splits=SPLITS)] + [
            dict(kind="spatial", cfg=c, ticks=RL_TICKS, world="city",
                 key=CITY_KEY, inject=CITY_VEHICLES, splits=SPLITS)
            for c in RL_CITIES.values()]
    return launch.spawn(ranks.run_jobs, N_RANKS, "gloo", device="cpu",
                        args=(jobs,), threads=1)


@functools.cache
def _crossroad_ref() -> dict:
    cfg = dryrun_cfg()
    return world_to_numpy(sim.run_chunk(
        cfg, synth.crossroad_world(cfg, device="cpu"), CROSS_TICKS))


@functools.cache
def _city_ref():
    """The unsharded city run in chunks of one routing segment (the same
    segments as one 50-tick chunk), and per mesh size the vehicles whose
    row changed owner between two segments."""
    w = ranks.split_world(CITY, "city", "cpu", CITY_KEY, CITY_VEHICLES)
    seen = [w.vehicles]
    R = CITY.PATHFINDING_COOLDOWN
    for _ in range(CITY_TICKS // R):
        w = sim.run_chunk(CITY, w, R)
        seen.append(w.vehicles)
    crossings = {}
    for n in SPLITS:
        rows = CITY.HEIGHT // n
        crossings[n] = sum(int((a.active & b.active & (
            a.pos // CITY.WIDTH // rows != b.pos // CITY.WIDTH // rows))
            .sum()) for a, b in zip(seen, seen[1:]))
    return world_to_numpy(w), crossings


@functools.cache
def _rl_city_ref(algo: str) -> tuple:
    """The unsharded RL city run, and whether its nets trained."""
    cfg = RL_CITIES[algo]
    w = ranks.split_world(cfg, "city", "cpu", CITY_KEY, CITY_VEHICLES)
    start = world_to_numpy(w)
    end = world_to_numpy(sim.run_chunk(cfg, w, RL_TICKS))
    trained = [k for k in start if k.startswith("rl.params.")
               and not np.array_equal(start[k], end[k])]
    return end, trained


def _same(name: str, ref: dict, got: dict):
    assert set(ref) == set(got), f"{name}: {sorted(set(ref) ^ set(got))}"
    bad = [k for k, a in ref.items() if got[k]["sha256"] != _sha(a)
           or got[k]["shape"] != list(a.shape)]
    assert not bad, f"{name}: leaves differ from the unsharded run: {bad}"


@pytest.mark.parametrize("n", SPLITS)
def test_crossroad_split_equals_unsharded(n):
    """JAX's case: the dry run's crossroad (A2C training every tick)
    split over n ranks for 4 ticks equals the unsharded `run_chunk` on
    every leaf, the trained floats too."""
    _same(f"crossroad over {n} ranks", _crossroad_ref(),
          _spawned()[0][0][str(n)]["digests"])


@pytest.mark.parametrize("n", SPLITS)
def test_crossroad_split_matches_jax(n):
    """...and JAX's `spatial_chunk_fn` on 8 devices: integer and
    untrained leaves by sha256, the trained floats within the RL
    tolerance."""
    with open(os.path.join(DATA, "spatial_digest.json")) as f:
        dig = json.load(f)
    assert (dig["devices"], dig["ticks"]) == (8, CROSS_TICKS)
    z = np.load(os.path.join(DATA, "spatial_trained.npz"))
    got = _spawned()[0][0][str(n)]["digests"]
    assert set(got) == set(dig["digest"])
    bad = []
    for k, d in dig["digest"].items():
        if k.startswith(TRAINED):
            ref = z[k]
            scale = min(1.0, float(np.abs(ref).max(initial=0.0)))
            if not np.allclose(got[k]["array"], ref, rtol=RTOL,
                               atol=ATOL * scale):
                bad.append((k, "past the tolerance"))
        elif (got[k]["sha256"], got[k]["dtype"]) != (d["sha256"],
                                                      d["dtype"]):
            bad.append((k, "sha256"))
    assert not bad, bad


@pytest.mark.parametrize("n", SPLITS)
def test_city_split_with_crossings_equals_unsharded(n):
    """A 64^2 city (QUEUE_ACTUATED, 160 vehicles) split over n ranks for
    50 ticks equals the unsharded run on every leaf, and vehicles did
    cross the slab boundaries."""
    ref, crossings = _city_ref()
    assert crossings[n] > 0, crossings
    _same(f"city over {n} ranks", ref, _spawned()[0][1][str(n)]["digests"])


@pytest.mark.parametrize("algo", list(RL_CITIES))
@pytest.mark.parametrize("n", SPLITS)
def test_rl_city_split_equals_unsharded(algo, n):
    """REINFORCE and GAT-DQN on the 64^2 city split over n ranks for 20
    ticks equal the unsharded run on every leaf, the trained floats too:
    their state features and rewards read the group sums of the ranks'
    flows, and the nets did train."""
    ref, trained = _rl_city_ref(algo)
    assert trained, f"{algo}: no parameter moved in {RL_TICKS} ticks"
    job = 2 + list(RL_CITIES).index(algo)
    _same(f"{algo} city over {n} ranks", ref,
          _spawned()[0][job][str(n)]["digests"])


# per job: its Config, ticks and all-reduces a tick (the light
# reductions, the decide halo, the post-move's; plus one for each plane
# whose RL flows a controller step reads)
JOBS = [(dryrun_cfg(), CROSS_TICKS, 4), (CITY, CITY_TICKS, 3),
        (RL_CITIES["NEIGHBOR_RL"], RL_TICKS, 5),
        (RL_CITIES["GAT_DQN"], RL_TICKS, 4)]


@pytest.mark.parametrize("job", range(len(JOBS)))
def test_residency_and_collectives(job):
    """Each rank holds the key stack over its decide window alone, its
    rows are its share, and every rank made the same collectives: per
    tick the light reductions, the halo and the post-move's, per segment
    the routing halo, once the entry and the exit (plus the RL flows:
    the occupancy's under A2C and GAT-DQN, the stuck ticks' too under
    this REINFORCE)."""
    cfg, ticks, per_tick = JOBS[job]
    P, Q = spatial.halo_widths(cfg)
    H = cfg.HEIGHT
    segs = -(-ticks // cfg.PATHFINDING_COOLDOWN)
    for n in SPLITS:
        res = [o[job][str(n)] for o in _spawned()[:n]]
        assert all(o[job][str(n)] is None for o in _spawned()[n:])
        for r, x in enumerate(res):
            lo, hi = spatial.rows_of(H, n, r)
            assert tuple(x["own"]) == (lo, hi) == (r * H // n,
                                                   (r + 1) * H // n)
            d0, d1 = max(0, lo - P), min(H, hi + P)
            assert tuple(x["dec"]) == (d0, d1)
            D = x["cost_field_shape"][0]
            assert x["cost_field_shape"] == (D, 4, d1 - d0, cfg.WIDTH)
            assert x["cost_field_bytes"] == D * 4 * (d1 - d0) * \
                cfg.WIDTH * 4
            assert x["stats"]["all_reduce"] == \
                per_tick * ticks + segs + 2
            assert x["launches"] == res[0]["launches"]


def test_halo_widths():
    assert spatial.halo_widths(Config()) == (16, 11)
    assert spatial.halo_widths(dryrun_cfg()) == (7, 11)


def test_rows_and_windows():
    H = 32
    assert [spatial.rows_of(H, 4, r) for r in range(4)] == \
        [(0, 8), (8, 16), (16, 24), (24, 32)]
    assert spatial.rows_of(H, 1, 0) == (0, 32)
    assert spatial.window_of(H, 1, 0, 7) == (0, 32)
    # edge ranks have no halo beyond the world's edge
    assert spatial.window_of(H, 4, 0, 7) == (0, 15)
    assert spatial.window_of(H, 4, 3, 7) == (17, 32)
    assert spatial.window_of(H, 4, 1, 18) == (0, 32)
    slab = spatial.Slab(H=H, W=5, rank=2, size=4, P=7, Q=11)
    assert (slab.own, slab.dec, slab.route) == ((16, 24), (9, 31),
                                                (0, 32))
    x = torch.arange(32)[:, None].expand(32, 5)
    assert slab.crop(x, slab.route, slab.own)[:, 0].tolist() == \
        list(range(16, 24))


def test_world_shardings_follow_jax():
    cfg = dryrun_cfg()
    w = synth.crossroad_world(cfg, device="cpu")
    kinds = spatial.world_shardings(w, Mesh(None, 0, 4, torch.device("cpu"),
                                            "y"))
    rows = {k for k, v in kinds.items() if v == "rows"}
    assert "cost_field" in rows and "veh_map" in rows and \
        "grid.cell_type" in rows and "vehicles.pos" not in rows
    # the 32 x 32 crossroad's A2C kernels have the grid's shape, but the
    # train state replicates
    assert any(k.startswith("rl.") and tuple(t.shape[-2:]) == (32, 32)
               for k, t in spatial.world_leaves(w).items())
    assert not any(k.startswith("rl.") for k in rows)
    with pytest.raises(ValueError, match="grid height 32 not divisible "
                       "by the mesh's 3 devices"):
        spatial.world_shardings(w, Mesh(None, 0, 3, torch.device("cpu"),
                                        "y"))


def _emulate(slabs, call):
    """`call(slab)` on every rank with the all-reduce emulated: each
    rank's buffer captured, their sum handed back."""
    bufs = []
    for s in slabs:
        s._all_reduce = lambda b, bufs=bufs: bufs.append(b.clone()) or b
        call(s)
    total = sum(bufs)
    for s in slabs:
        s._all_reduce = lambda b: b.copy_(total)
    return [call(s) for s in slabs]


@pytest.mark.parametrize("n,width", [(2, 7), (4, 7), (4, 18), (8, 9)])
def test_band_assembly(n, width):
    """A window assembled from the band buffer equals the plane's rows,
    also where the halo is wider than a neighbour's slab (rows from
    several ranks)."""
    H, W = 32, 6
    g = torch.Generator().manual_seed(n * 100 + width)
    plane = torch.randint(-2**31, 2**31 - 1, (3, H, W), generator=g,
                          dtype=torch.int64).to(torch.int32)
    slabs = [spatial.Slab(H=H, W=W, rank=r, size=n, P=width, Q=0)
             for r in range(n)]
    got = _emulate(slabs, lambda s: s.exchange(
        plane[:, slice(*s.own)].contiguous(), width))
    for s, x in zip(slabs, got):
        lo, hi = spatial.window_of(H, n, s.rank, width)
        assert torch.equal(x, plane[:, lo:hi])
    per = spatial.band_rows(H, n, width)
    assert sum(len(r) for r in per) == slabs[0]._band(width)["n"]


def test_halo_and_sums_carry_bits():
    """f32 planes cross in the band buffer as their bit patterns (-0.0,
    NaN payloads, subnormals intact), bool planes as bools; `all_sum`
    adds owner-masked f32 values by their bits and counts as integers."""
    H, W, n, width = 16, 4, 4, 5
    special = torch.tensor([-0.0, 0.0, float("inf"), -1e-42, 1e-45, 2.5],
                           dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    fp = special[torch.randint(0, 6, (H, W), generator=g)]
    fp.view(torch.int32)[0, 0] = 0x7FC00123          # a NaN with a payload
    bp = torch.rand((H, W), generator=g) < 0.5
    slabs = [spatial.Slab(H=H, W=W, rank=r, size=n, P=width, Q=0)
             for r in range(n)]
    got = _emulate(slabs, lambda s: s.halo(
        [fp[slice(*s.own)], bp[slice(*s.own)]], width))
    for s, (f, b) in zip(slabs, got):
        lo, hi = spatial.window_of(H, n, s.rank, width)
        assert torch.equal(f.view(torch.int32), fp[lo:hi].view(torch.int32))
        assert torch.equal(b, bp[lo:hi])
    vals = fp.reshape(-1)[:n]
    got = _emulate(slabs, lambda s: s.all_sum([
        torch.where(torch.arange(n) == s.rank, vals, 0.0),
        torch.tensor([s.rank == 1, False]),
        torch.tensor([s.rank], dtype=torch.uint8)]))
    for f, b, c in got:
        assert torch.equal(f.view(torch.int32), vals.view(torch.int32))
        assert b.tolist() == [True, False] and c.tolist() == [6]
    cnt = _emulate(slabs, lambda s: s.sum_counts(
        torch.full((3,), float(s.rank + 1))))
    assert all(c.tolist() == [10.0] * 3 for c in cnt)


def test_index_maps():
    """The maps of the replicated tables onto a rank's rows: destination
    and spawn-origin cells onto the own rows; the queue runs' prefix
    indices, whose per-rank counts add up to the whole world's; the stop
    runs and extra stop cells, whose route-window stop map is the whole
    world's on those rows."""
    cfg = dryrun_cfg()
    w = synth.crossroad_world(cfg, device="cpu")
    H, W = cfg.HEIGHT, cfg.WIDTH
    g = torch.Generator().manual_seed(5)
    occ = torch.rand((H, W), generator=g) < 0.4
    ls, gs = w.lights_static, w.groups_static
    state = w.lights.replace(light_stop=torch.rand(
        ls.valid.shape, generator=g) < 0.5)
    stop = fsm.build_stop_map(w.grid, ls, state)
    Pg = fsm._prefix_planes(occ)
    want = Pg[gs.run_hi.long()] - Pg[gs.run_lo.long()]
    cells = torch.randint(0, H * W, (50,), generator=g)
    for n in SPLITS:
        got = torch.zeros_like(want)
        gathered = torch.zeros(50, dtype=torch.int32)
        for r in range(n):
            P, Q = spatial.halo_widths(cfg)
            slab = spatial.Slab(H=H, W=W, rank=r, size=n, P=P, Q=Q)
            slab.prepare(w)
            lo, hi = slab.own
            P = fsm._prefix_planes(occ[lo:hi])
            got += P[slab.maps["run_hi"]] - P[slab.maps["run_lo"]]
            r0, r1 = slab.route
            route = w.grid.replace(**{
                f: t[r0:r1] for f, t in vars(w.grid).items()
                if f != "n_side"})
            st = fsm.build_stop_map(route, ls, state, slab=slab)
            assert torch.equal(slab.crop(st, slab.route, slab.own),
                               stop[lo:hi])
            # owner-masked gathers: the sink reads 0
            for name, c in (("dpos", w.dests.pos), ("origin", cells)):
                loc = slab.cells(torch.clamp(c, 0, H * W - 1))
                flat = torch.cat([torch.arange(lo * W, hi * W,
                                               dtype=torch.int32) + 1,
                                  torch.zeros(1, dtype=torch.int32)])
                if name == "origin":
                    gathered += flat[loc]
                else:
                    mine = (c >= lo * W) & (c < hi * W)
                    assert torch.equal(flat[loc] != 0, mine)
        assert torch.equal(got, want), n
        assert torch.equal(gathered, cells.to(torch.int32) + 1)


def test_split_takes_the_sparse_light_reductions():
    """A split world runs the light reductions from the run tables, as
    the unsharded `run_chunk` does by default: `sim.advance` refuses the
    dense matrices together with a slab."""
    cfg = dryrun_cfg()
    w = synth.crossroad_world(cfg, device="cpu")
    slab = spatial.Slab(H=cfg.HEIGHT, W=cfg.WIDTH, rank=0, size=2,
                        P=7, Q=11)
    dense = fsm.build_dense_reducers(cfg, w.grid, w.lights_static)
    with pytest.raises(ValueError, match="sparse light reductions"):
        sim.advance(cfg, w, 1, torch.zeros((1, 1), dtype=torch.int64),
                    dense, slab=slab)


def test_local_runs_clip_column_runs():
    H, W = 8, 3
    NH = H * (W + 1)
    # a column run over rows 2..6 of column 1, a row run in row 5
    lo = torch.tensor([NH + 2 * W + 1, 5 * (W + 1) + 0])
    hi = torch.tensor([NH + 6 * W + 1, 5 * (W + 1) + 3])
    occ = torch.ones((H, W), dtype=torch.bool)
    for a, b, n_col, n_row in ((0, 4, 2, 0), (4, 8, 2, 3), (6, 8, 0, 0),
                                 (1, 6, 4, 3)):
        P = fsm._prefix_planes(occ[a:b])
        cnt = P[spatial.local_runs(hi, H, W, a, b)] - \
            P[spatial.local_runs(lo, H, W, a, b)]
        assert cnt.tolist() == [n_col, n_row], (a, b)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A process group of this process alone (gloo, CPU) and its mesh."""
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    store = tmp_path_factory.mktemp("group") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield spatial.spatial_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_refusals_name_item_15c(one_rank):
    """What the split still refuses: a leaf with the grid's rows that it
    knows no window for raises ValueError naming the leaf (the
    pedestrians' planes and hierarchical routing's windowed stack, once
    refused, are known); a world with pedestrians lays out, its count
    planes by rows and n_side replicated."""
    with pytest.raises(ValueError, match=r"\['extra.plane'\] carry the "
                       "grid's rows, and the split knows no window"):
        spatial._check_rows({"extra.plane": "rows", "peds.walk": "rows",
                             "local_sdir4": "rows", "grid.is_road": "rows"})
    spatial._check_rows({"peds.walk": "rows", "peds.cross": "rows",
                         "local_sdir4": "rows", "dests.rid": "replicated"})
    cfg = Config(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64,
                 PEDESTRIANS_ENABLED=True)
    w = synth.crossroad_world(cfg, device="cpu")
    sw = spatial.shard_world(w, one_rank, cfg)
    assert {"peds.walk", "peds.cross", "ped_map"} <= sw.slab.row_leaves
    assert "grid.n_side" not in sw.slab.row_leaves
    assert torch.equal(sw.world.grid.n_side, w.grid.n_side)


def test_one_rank_never_takes_the_megakernel(one_rank, monkeypatch):
    """Under the megakernel gate (TSIM_MEGA_INTERPRET opens it on the
    CPU) the split runs the per-tick path: K9's segment is never called,
    and a mesh of one rank equals the unsharded per-tick run."""
    cfg = Config(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64)
    w = synth.crossroad_world(cfg, device="cpu")
    monkeypatch.setenv("TSIM_NO_MEGAKERNEL", "1")
    ref = world_to_numpy(sim.run_chunk(cfg, w, 7))
    monkeypatch.delenv("TSIM_NO_MEGAKERNEL")
    monkeypatch.setenv("TSIM_MEGA_INTERPRET", "1")
    assert megakernel.mega_ok(cfg, w)

    def no_k9(*a, **k):
        raise AssertionError("the split took the megakernel branch")
    monkeypatch.setattr(megakernel, "run_segment_mega", no_k9)
    sw = spatial.shard_world(w, one_rank, cfg)
    sw = spatial.run_chunk_spatial(cfg, sw, 7, one_rank)
    got = world_to_numpy(spatial.gather_world(sw, one_rank))
    assert set(got) == set(ref)
    assert [k for k in ref if _sha(ref[k]) != _sha(got[k])] == []
    assert sw.slab.stats["all_reduce"] == 0


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_split_on_the_card_equals_unsharded():
    """2 ranks on cuda:0 (gloo) split the 64^2 city: every leaf equals the
    unsharded run on the card, and each rank launched K1 and K4 once a
    tick, K2 and K3 once a segment, K9 never."""
    out = launch.spawn(ranks.run_jobs, 2, "gloo", args=([dict(
        kind="spatial", cfg=CITY, ticks=CITY_TICKS, world="city",
        key=CITY_KEY, inject=CITY_VEHICLES, mega_env=True)],))
    w = ranks.split_world(CITY, "city", "cuda", CITY_KEY, CITY_VEHICLES)
    ref = world_to_numpy(sim.run_chunk(CITY, w, CITY_TICKS))
    _same("city over 2 ranks on the card", ref, out[0][0]["2"]["digests"])
    segs = CITY_TICKS // CITY.PATHFINDING_COOLDOWN
    for o in out:
        la = o[0]["2"]["launches"]
        assert la["decide_move"] + la["decide_move_blocks"] == CITY_TICKS
        assert la["prefix_planes"] == CITY_TICKS
        assert (la["build_sdir"], la["build_wavefront"]) == (segs, segs)
        assert la["mega"] + la["mega_worlds"] == 0


# ---- the reach of each stage the halos cover ------------------------------

def _window(H: int, own: tuple, h: int) -> tuple:
    return max(0, own[0] - h), min(H, own[1] + h)


def _k1_inputs(seed: int, cfg: Config, H: int, W: int, D: int = 4):
    """Dense traffic at the top speed for the plain K1: 60% of the cells
    hold a vehicle with a heading and a destination of the stack, some
    hold a contraflow allowance and excursion key, the next-move bytes
    carry contraflow flags and the wavefront bytes overtakes; stops,
    intersections and sideswipes (chance 1/2) here and there."""
    rng = np.random.default_rng(seed)
    S = cfg.VEHICLE_MAX_SPEED

    def i32(a):
        return a.astype(np.int64).astype(np.uint32).view(np.int32)
    pres = rng.random((H, W)) < 0.6
    pa = i32(pres | (rng.integers(0, 5, (H, W)) << HE.PA_HEAD_SH)
             | (S << HE.PA_BASE_SH) | (S << HE.PA_CUR_SH)
             | (rng.integers(0, D, (H, W)) << HE.PA_DEST_SH))
    pb = i32(rng.integers(0, 4, (H, W)) << HE.PB_CONTRA_SH)
    pd = i32((rng.integers(0, 4, (H, W)) << HE.PD_CFKEY_SH)
             | ((rng.random((H, W)) < 0.3) << HE.PD_CFMODE_SH))
    zero = np.zeros((H, W), np.int32)
    planes = [pa, pb, zero, pd, zero, rng.random((H, W), dtype=np.float32)]
    sdir = (rng.integers(0, 4, (D, H, W))
            | ((rng.random((D, H, W)) < 0.3) << 3)
            | (rng.integers(0, 16, (D, H, W)) << 4)).astype(np.uint8)
    wb = rng.integers(0, 16, (4, H, W))
    wnd = i32(wb[0] | (wb[1] << 8) | (wb[2] << 16) | (wb[3] << 24))
    masks = (rng.random((H, W)) < 0.05, np.zeros((H, W), bool),
             np.zeros((H, W), bool), rng.random((H, W)) < 0.1)
    dest_id = np.where(rng.random((H, W)) < 0.03,
                       rng.integers(0, D, (H, W)), -1).astype(np.int32)
    randoms = (rng.random((H, W), dtype=np.float32),
               rng.random((H, W), dtype=np.float32),
               rng.integers(1, S + 1, (H, W)).astype(np.int32),
               i32(rng.integers(0, 2**32, (H, W), dtype=np.uint64)))
    return sdir, wnd, planes, masks, dest_id, randoms


def _k1_rows(cfg: Config, inp, lo: int, hi: int) -> list:
    """The plain K1 on rows [lo, hi) as if they were the world."""
    sdir, wnd, planes, masks, dest_id, randoms = inp

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[..., lo:hi, :]))
    out = HE.decide_move_core(
        cfg, engine.pack_sdir4(t(sdir)), t(wnd), *(t(p) for p in planes),
        *(t(m) for m in masks), t(dest_id), *(t(r) for r in randoms))
    return [o.view(torch.int32) if o.dtype == torch.float32 else o
            for o in out]


@pytest.mark.parametrize("speed", [2, 5])
def test_decide_move_reach_within_P(speed):
    """K1's plain version on a rank's decide window (its 8 own rows
    widened by P, cut on both sides) gives the own rows of the whole
    grid's tick on every output plane, for dense traffic at the top
    speed.  The window's edges do damage: on the own rows alone (no
    halo) some rows differ, and no damage reaches P rows in.  P = 1 + 3
    x speed bounds the reach from above (the decide reads 1 away, a
    movement sub-round at most 3); these inputs reach less deep, so the
    value of P itself is pinned by `test_halo_widths`."""
    W = 12
    cfg = Config(WIDTH=W, HEIGHT=64, VEHICLE_MAX_SPEED=speed,
                 MAX_FIELD_DESTS=4, MAX_VEHICLES=64,
                 VEHICLE_SIDESWIPE_COLLISION_ACTIVE=True,
                 VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.5)
    P, _ = spatial.halo_widths(cfg)
    H = 2 * P + 12
    own = (P + 2, P + 10)
    deepest = 0
    for seed in range(12):
        inp = _k1_inputs(seed, cfg, H, W)
        whole = [o[own[0]:own[1]] for o in _k1_rows(cfg, inp, 0, H)]
        lo, hi = _window(H, own, P)
        assert (lo, hi) == (2, H - 2)
        got = _k1_rows(cfg, inp, lo, hi)
        for name, a, b in zip(("pa", "pb", "pc", "pd", "pe", "pl", "flags"),
                              whole, got):
            assert torch.equal(a, b[own[0] - lo:own[1] - lo]), (seed, name)
        bare = _k1_rows(cfg, inp, *own)
        bad = torch.zeros(own[1] - own[0], dtype=torch.bool)
        for a, b in zip(whole, bare):
            bad |= (a != b).any(1)
        rows = torch.nonzero(bad).flatten().tolist()
        # depth from the nearer edge of the bare window, 1 = its edge row
        deepest = max([deepest] + [1 + min(r, own[1] - own[0] - 1 - r)
                                   for r in rows])
    assert 0 < deepest < P, deepest


def _routing_rows(cfg: Config, K0, allowed, is_road, pa, stop, lo: int,
                  hi: int, dec: tuple) -> tuple:
    """`engine.routing_planes`' stages on rows [lo, hi) as if they were
    the world (density, penalties, entry costs, K2 and K3 plain), the
    next-move words and wavefronts of the decide window's rows `dec`."""
    sl = slice(lo, hi)
    present = (pa[sl] & 1) == 1
    density = density_map(present, is_road[sl], cfg.VEHICLE_AWARENESS_RANGE)
    soft2, hard = engine.soft_penalties(cfg, pa[sl], stop[sl], density)
    rows = slice(dec[0] - lo, dec[1] - lo)
    sdir = engine.build_sdir(cfg, K0[:, :, dec[0]:dec[1]].contiguous(),
                             allowed[sl], is_road[sl], soft2, hard,
                             rows=rows)
    wnd = engine.build_wavefront(cfg, allowed[sl], is_road[sl], hard)
    return sdir, wnd[rows]


@pytest.mark.parametrize("cfg", [Config(), dryrun_cfg()],
                         ids=["defaults", "dryrun"])
def test_routing_reach_is_Q(cfg):
    """The routing planes of a rank's decide window, built over the
    route window (decide window widened by Q, cut on both sides), equal
    the whole grid's on random dense traffic; with Q - 1 rows the
    density box sum (radius VEHICLE_AWARENESS_RANGE) behind the entry
    costs (one neighbour further) misses a row and some next-move byte
    of the decide window changes.  K3's wavefronts, which Q covers with
    room to spare, are exact from K_OVT + 1 rows on and differ with
    K_OVT: a blocker K_OVT + 1 rows beyond a window edge seeds a wave
    that reaches the edge row in K_OVT steps."""
    P, Q = spatial.halo_widths(cfg)
    K = cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS
    assert Q == cfg.VEHICLE_AWARENESS_RANGE + 1 > K + 1
    W, D = 16, 4
    H = 2 * (P + Q) + 20
    own = (P + Q + 6, P + Q + 14)
    dec = _window(H, own, P)
    short = 0
    for seed in range(6):
        rng = np.random.default_rng(seed)
        allowed = torch.from_numpy(rng.integers(0, 16, (H, W)).astype(
            np.uint8))
        is_road = torch.from_numpy(rng.random((H, W)) < 0.85)
        # dense queues, some parked (hard) vehicles; keys close together,
        # so that the entry costs decide the next moves
        pa = torch.from_numpy(
            ((rng.random((H, W)) < 0.8)
             | ((rng.random((H, W)) < 0.1) << HE.PA_PARKED_SH)).astype(
                np.int32))
        stop = torch.from_numpy(rng.random((H, W)) < 0.05)
        m = np.arange(4).reshape(1, 4, 1, 1)
        K0 = torch.from_numpy(((rng.integers(0, 200, (D, 4, H, W)) << 2)
                               | m).astype(np.int32))
        args = (cfg, K0, allowed, is_road, pa, stop)
        sd, wn = _routing_rows(*args, 0, H, dec)
        for q in (Q, Q + 3, Q - 1, K + 1):
            lo, hi = _window(H, dec, q)
            assert 0 < lo and hi < H
            s2, w2 = _routing_rows(*args, lo, hi, dec)
            if q >= Q:
                assert torch.equal(s2, sd) and torch.equal(w2, wn), (seed, q)
            elif q == Q - 1:
                short += int(not torch.equal(s2, sd))
            else:
                assert torch.equal(w2, wn), (seed, q)
    assert short > 0
    # K3 alone: open road, every direction legal, one blocker K_OVT + 1
    # rows beyond each edge of the decide window
    road = torch.ones((H, W), dtype=torch.bool)
    every = torch.full((H, W), 15, dtype=torch.uint8)
    hard = torch.zeros((H, W), dtype=torch.bool)
    hard[dec[0] - K - 1, 3] = hard[dec[1] + K, W - 4] = True
    whole = engine.build_wavefront(cfg, every, road, hard)[dec[0]:dec[1]]
    for q in (K + 1, K):
        lo, hi = _window(H, dec, q)
        got = engine.build_wavefront(cfg, every[lo:hi], road[lo:hi],
                                     hard[lo:hi])[dec[0] - lo:dec[1] - lo]
        edge = q == K
        assert (got != whole).any(1).tolist() == \
            [edge] + [False] * (dec[1] - dec[0] - 2) + [edge], q

