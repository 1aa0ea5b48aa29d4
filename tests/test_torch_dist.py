"""World batches sharded over a process group (the port's data-parallel
multi-GPU, `parallel/mesh.py`, `parallel/launch.py`, `parallel/ranks.py`,
`dryrun.py`) against the JAX package and the port's unsharded runs.

The ranks are processes started by `launch.spawn` with backend "gloo"
and `device="cpu"`:

* the dry run (`dryrun_multichip(4)`, 4 ranks x 2 worlds of
  `dryrun_cfg()`) after 1 and 2 ticks against `data/mesh_digest.json`
  (`tools/make_torch_mesh_digest.py`: JAX on an 8-device CPU mesh), the
  all-reduced `created_internal + created_through`, the A2C update on
  every rank;

and, in one spawn of 2 ranks that runs every job in turn:

* config #4's worlds 0-1 (`data/config4_batch_digest.json`'s config and
  keys) as 2 ranks x 1 world, 10 ticks of `run_chunk_batch`;
* the A2C crossroad shared batch of `data/rl_batch_digest.json` (B = 4,
  12 ticks) as 2 ranks x 2 worlds;
* `run_batch` of the dry run's crossroad for 3 ticks (2 ranks x 2) and
  `fleet_metrics` over the group;
* `init_world_batch(..., mesh)` at init, of small cities and under an
  RL config (NEIGHBOR_RL_BATCHED of `data/rl_batch_digest.json`: each
  world's train state from its own key).

Integer and bool leaves, and the floats nobody trains, are held by
sha256; the trained floats (`dryrun.TRAINED`: parameters, Adam moments,
A2C's value outputs) element by element within `test_torch_rl_batch.
py`'s tolerance, against JAX's and against the port's unsharded run of
the same batch in this process (their largest difference is printed).
Then the demand-window guard over the group (its own spawn and
collective timeout; the rank body is `torch_dist_ranks.guard`, beside
this file), the rules that need no rank, and the imports.

No JAX compile, no 256^2 world.
"""

import functools
import json
import os
import time

import numpy as np
import pytest
import torch

from trafficsimulation_tpu_torch import dryrun, prng, sim
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core import synth
from trafficsimulation_tpu_torch.dryrun import TRAINED, dryrun_cfg
from trafficsimulation_tpu_torch.parallel import launch, mesh, ranks

import torch_dist_ranks

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(__file__), "..",
                    "trafficsimulation_tpu_torch", "data")
RTOL, ATOL = 1e-4, 1e-5     # as tests/test_torch_rl_batch.py
N_RANKS = 2
N_DRYRUN = 4
SMALL = Config(WIDTH=32, HEIGHT=32, WALL_THICKNESS=4, SIDEWALK_RING_WIDTH=1,
               MAX_FIELD_DESTS=8, MAX_VEHICLES=32)


def _load(name: str) -> dict:
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


@functools.cache
def _digests() -> dict:
    return {n: _load(f"{n}.json") for n in
            ("mesh_digest", "config4_batch_digest", "rl_batch_digest")}


@functools.cache
def _trained(name: str) -> dict:
    with np.load(os.path.join(DATA, name)) as z:
        return {k: z[k] for k in z.files}


def _c4():
    d = _digests()["config4_batch_digest"]
    return Config(**d["cfg"]), prng.split(prng.PRNGKey(0), d["n_split"])[:2]


def _rl_cities() -> Config:
    return Config(**_digests()["rl_batch_digest"]["per_world"][
        "NEIGHBOR_RL_BATCHED"]["cfg"])


def _rl():
    d = _digests()["rl_batch_digest"]
    rec = d["shared"]["RL_A2C_BATCHED"]
    return (Config(**rec["cfg"]), prng.split(prng.PRNGKey(0), d["shared_b"]),
            d["ticks"], rec)


JOBS = ["config4", "rl_shared", "run_batch", "init", "init_one", "init_rl"]


@functools.cache
def _spawned() -> dict:
    """One spawn of 2 gloo ranks on the CPU running every job; rank 0's
    result of each (its digests are the whole batch's), and every rank's
    under `all`."""
    c4, k4 = _c4()
    rl, krl, nrl, _ = _rl()
    jobs = [
        dict(kind="cities", cfg=c4, keys=k4, ticks=10),
        dict(kind="rollouts", cfg=rl, keys=krl, ticks=nrl, whole=TRAINED),
        dict(kind="rollouts", cfg=dryrun_cfg(),
             keys=prng.split(prng.PRNGKey(0), 4), ticks=3, layout="full",
             whole=TRAINED),
        dict(kind="cities", cfg=SMALL, key=prng.PRNGKey(3), n_worlds=2,
             ticks=0, paths=(), init=True),
        # a mesh of the first rank alone (`make_mesh(1)`): the whole batch
        dict(kind="cities", ranks=1, cfg=SMALL, key=prng.PRNGKey(3),
             n_worlds=2, ticks=0, paths=(), init=True),
        dict(kind="cities", cfg=_rl_cities(), key=prng.PRNGKey(0),
             n_worlds=2, ticks=0, paths=(), init=True),
    ]
    t0 = time.perf_counter()
    out = launch.spawn(ranks.run_jobs, N_RANKS, "gloo", device="cpu",
                       args=(jobs,), threads=1)
    res = {name: out[0][i] for i, name in enumerate(JOBS)}
    res["all"] = {name: [o[i] for o in out] for i, name in enumerate(JOBS)}
    res["seconds"] = time.perf_counter() - t0
    print(f"spawn of {N_RANKS} ranks, {len(jobs)} jobs: "
          f"{res['seconds']:.1f} s")
    return res


def _close(got, ref, msg: str):
    """Within RTOL and ATOL times max |ref| (at most ATOL), as
    `test_torch_rl_batch._assert_close`."""
    ref = np.asarray(ref)
    scale = min(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL * scale,
                               err_msg=msg)


def _check(name: str, want: dict, got: dict, near=None, skip=()):
    """Every leaf of one world's digest `got` against `want`: sha256, but
    the leaves `near(leaf)` returns an array for, element by element
    within the tolerance against it.  Returns the largest difference of
    those."""
    want = {k: v for k, v in want.items() if k not in skip}
    got = {k: v for k, v in got.items() if k not in skip}
    assert set(want) == set(got), f"{name}: {sorted(set(want) ^ set(got))}"
    bad, worst = [], 0.0
    for k, d in want.items():
        ref = near(k) if near else None
        if ref is not None:
            a = got[k]["array"]
            worst = max(worst, float(np.abs(a.astype(np.float64) - ref)
                                     .max(initial=0.0)))
            try:
                _close(a, ref, k)
            except AssertionError as e:
                bad.append((k, str(e)[-200:]))
        elif mesh.diff_digests({k: d}, {k: got[k]}):
            bad.append((k, "sha256"))
    assert not bad, f"{name}: {bad}"
    return worst


def _unsharded(batch, whole=()) -> list:
    return mesh.world_digests(batch, whole)


def _by_array(digest: dict, prefixes: tuple):
    """near(leaf) for a port digest: the leaf's whole array."""
    return lambda k: (digest[k]["array"] if k.startswith(prefixes)
                      else None)


def test_dryrun_matches_jax_mesh_digest():
    """4 ranks x 2 worlds of the dry run, after 1 and 2 ticks, equal
    JAX's 8 worlds on its 8-device mesh and the port's unsharded batch
    of 8; the all-reduced total is JAX's; every rank trained."""
    dig = _digests()["mesh_digest"]
    every = dryrun.dryrun_multichip(N_DRYRUN, dig["dryrun_worlds"],
                                    backend="gloo", device="cpu", ticks=2)
    res = every[0]
    z = _trained("mesh_trained.npz")
    assert [r["total"] for r in every] == [dig["dryrun_total"]] * N_DRYRUN
    assert [r["digests"] for r in every[1:]] == [[None, None]] * 3
    assert all(dig["dryrun_moved"])       # JAX's worlds moved too
    cfg = dryrun_cfg()
    batch = mesh.tile_world(synth.crossroad_world(cfg, device="cpu"),
                            prng.split(prng.PRNGKey(0), 8))
    step = mesh.batched_step(cfg)
    worst = 0.0
    for t, got in enumerate(res["digests"], start=1):
        batch = step(batch)
        one = _unsharded(batch, TRAINED)
        assert len(got) == dig["dryrun_worlds"] == 8
        for b in range(8):
            phase = f"dryrun_tick{t}"
            _check(f"world {b} tick {t} vs JAX", dig[phase][b], got[b],
                   lambda k: z.get(f"{phase}|{b}|{k}"))
            worst = max(worst, _check(
                f"world {b} tick {t} vs unsharded", one[b], got[b],
                _by_array(one[b], TRAINED)))
    print(f"dry run: trained floats, sharded vs unsharded, max |diff| "
          f"{worst}")


def test_per_world_batch_sharded_matches_jax_and_unsharded():
    """Config #4's worlds 0-1 as 2 ranks x 1 world: 10 ticks of
    `run_chunk_batch` equal JAX's digest (every leaf, f32 too) and the
    port's unsharded batch of 2."""
    res = _spawned()["config4"]
    got = res["per_tick"]["digests"]
    c4, k4 = _c4()
    assert [r["worlds"] for r in _spawned()["all"]["config4"]] == \
        [[0, 1], [1, 2]]
    one = _unsharded(mesh.run_chunk_batch(c4, sim.init_worlds(c4, k4, "cpu"),
                                          10))
    ref = _digests()["config4_batch_digest"]["chunk10"]
    for b in range(2):
        _check(f"world {b} vs JAX", ref[b], got[b])
        _check(f"world {b} vs unsharded", one[b], got[b])


def test_shared_rl_batch_sharded_matches_jax_and_unsharded():
    """The A2C crossroad shared batch (B = 4, 12 ticks) as 2 ranks x 2:
    integer leaves JAX's digest and the unsharded run's, trained floats
    within the tolerance of both (the largest difference from the
    unsharded run printed)."""
    res = _spawned()["rl_shared"]
    got = res["per_tick"]["digests"]
    cfg, keys, n, rec = _rl()
    z = _trained("rl_batch_trained.npz")
    world = synth.crossroad_world(cfg, device="cpu")
    end = mesh.run_batch_shared(cfg, mesh.tile_dynamic(world, keys), n)
    one = _unsharded(end, TRAINED)
    worst = 0.0
    assert len(got) == len(keys) == 4
    for b in range(4):
        _check(f"world {b} vs JAX", rec[f"tick{n}"][b], got[b],
               lambda k: z.get(f"shared|RL_A2C_BATCHED|tick{n}|{b}|{k}")
               if k.startswith(TRAINED) else None, skip=("cost_field",))
        worst = max(worst, _check(f"world {b} vs unsharded", one[b], got[b],
                                  _by_array(one[b], TRAINED)))
    print(f"shared A2C batch: trained floats, sharded vs unsharded, max "
          f"|diff| {worst}")


def test_run_batch_and_fleet_metrics_sharded():
    """`run_batch` for 3 ticks of the dry run's crossroad on 2 ranks x 2
    worlds, against JAX's 4-device mesh, and `fleet_metrics` reduced over
    the group equal to JAX's."""
    res = _spawned()["run_batch"]
    dig = _digests()["mesh_digest"]
    z = _trained("mesh_trained.npz")
    n = dig["run_batch_ticks"]
    got = res["per_tick"]["digests"]
    assert len(got) == dig["run_batch_worlds"] == 4
    for b in range(4):
        _check(f"world {b} vs JAX", dig[f"run_batch{n}"][b], got[b],
               lambda k: z.get(f"run_batch{n}|{b}|{k}"))
    for r in _spawned()["all"]["run_batch"]:
        assert r["per_tick"]["fleet"] == dig["fleet_metrics"]


def test_init_world_batch_over_a_mesh():
    """`init_world_batch(cfg, key, n, mesh)` builds the rank's slice of
    the same keys: the two ranks' worlds together are the unsharded
    batch, leaf for leaf; on a mesh of the first rank alone
    (`make_mesh(1)`, the other rank outside it) the whole batch."""
    one = _unsharded(mesh.init_world_batch(SMALL, prng.PRNGKey(3), 2,
                                           device="cpu"))
    assert _spawned()["all"]["init_one"][1] is None
    assert [r["worlds"] for r in _spawned()["all"]["init"]] == \
        [[0, 1], [1, 2]]
    for job in ("init", "init_one"):
        got = _spawned()[job]["init"]
        for b in range(2):
            _check(f"{job}: world {b} at init", one[b], got[b])


def test_init_world_batch_over_a_mesh_under_rl():
    """Under an RL config (NEIGHBOR_RL_BATCHED) `init_world_batch(cfg,
    key, 2, mesh)` on 2 ranks gives the unsharded batch, leaf for leaf:
    each rank builds its world and that world's train state from the
    world's own key; the two worlds' parameters differ."""
    cfg = _rl_cities()
    one = _unsharded(mesh.init_world_batch(cfg, prng.PRNGKey(0), 2,
                                           device="cpu"))
    assert [r["worlds"] for r in _spawned()["all"]["init_rl"]] == \
        [[0, 1], [1, 2]]
    got = _spawned()["init_rl"]["init"]
    params = [k for k in one[0] if k.startswith("rl.params")]
    assert params
    assert any(one[0][k]["sha256"] != one[1][k]["sha256"] for k in params)
    for b in range(2):
        _check(f"RL world {b} at init", one[b], got[b])


def test_demand_window_guard_raises_on_every_rank():
    """Rank 1's worlds start 5 ticks later than rank 0's: a rollout that
    rank 0's table alone covers but the group's does not raises on both
    ranks (one all-reduce), and neither waits alone at a collective (a
    collective that waits 60 s fails the spawn)."""
    cfg = Config(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64)
    t0 = time.perf_counter()
    r0, r1 = launch.spawn(torch_dist_ranks.guard, 2, "gloo", device="cpu",
                          args=(cfg, 4, 5), threads=1, timeout_s=60)
    assert time.perf_counter() - t0 < 60
    assert r0["local"] == r1["local"] + 5 and r0["group"] == r1["local"]
    assert r0["local"] > r0["group"]        # rank 0 alone would run it
    for r in (r0, r1):
        assert r["raised"] and "outruns the pre-generated" in r["raised"]


# ---- rules that need no rank ------------------------------------------


def test_nccl_refuses_two_ranks_on_one_gpu():
    with pytest.raises(ValueError, match="pass backend='gloo'"):
        launch.check_backend("nccl", 2, None, 1)
    with pytest.raises(ValueError, match="GPUs only"):
        launch.check_backend("nccl", 1, "cpu", 0)
    with pytest.raises(ValueError, match="one of"):
        launch.check_backend("mpi", 1, "cpu", 0)
    launch.check_backend("nccl", 4, None, 4)
    launch.check_backend("gloo", 4, None, 1)
    launch.check_backend("gloo", 4, "cpu", 0)


def test_mesh_device_without_cuda_raises():
    """A rank takes the CPU only when asked: with no CUDA and no
    `device="cpu"`, `rank_device` (and so `make_mesh`) raises; with CUDA,
    rank r takes cuda:{r % GPUs}."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.rank_device(None, 0, cuda=False, n_gpus=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.rank_device("cuda", 1, cuda=False, n_gpus=0)
    assert mesh.rank_device("cpu", 3, cuda=False, n_gpus=0).type == "cpu"
    assert mesh.rank_device(None, 5, cuda=True, n_gpus=4) == \
        torch.device("cuda", 1)
    assert mesh.rank_device(None, 3, cuda=True, n_gpus=1) == \
        torch.device("cuda", 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.spawn(ranks.run_jobs, 1, "gloo", args=([],))


def test_worlds_must_split_evenly():
    m = mesh.Mesh(None, 1, 4, torch.device("cpu"))
    assert m.worlds(8) == slice(2, 4)
    with pytest.raises(ValueError, match="do not split evenly"):
        m.worlds(6)
    with pytest.raises(TypeError, match="Mesh"):
        mesh.init_world_batch(SMALL, prng.PRNGKey(0), 2, mesh=object(),
                              device="cpu")


def test_make_mesh_takes_the_cpu_only_when_asked(tmp_path):
    """`make_mesh` in a group of one rank (this process): on the CPU with
    `device="cpu"`; without CUDA and without it, it raises; `n_devices`
    beyond the group raises."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        m = mesh.make_mesh(device="cpu")
        assert (m.rank, m.size, m.device.type) == (0, 1, "cpu")
        with pytest.raises(ValueError, match="a mesh of 2 devices"):
            mesh.make_mesh(2, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mesh.make_mesh()
    finally:
        dist.destroy_process_group()


# ---- on the card: 2 ranks share cuda:0 over gloo ----------------------------


def _both_paths(run) -> dict:
    out = {}
    for mega in (False, True):
        with ranks.path_env(mega):
            out["mega" if mega else "per_tick"] = run()
    return out


@pytest.mark.cuda
def test_sharded_equals_unsharded_on_the_card():
    """2 ranks on cuda:0 (gloo): the crossroad's shared batch of 4 and 4
    cities of config #4, each 10 ticks on the per-tick and the megakernel
    path, equal the unsharded batches run in this process, every leaf;
    each rank launches each kernel once a call for its slice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cross = Config(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64)
    c4, _ = _c4()
    keys = prng.split(prng.PRNGKey(0), 4)
    k4 = prng.split(prng.PRNGKey(0), 1024)[:4]
    paths = (False, True)
    out = launch.spawn(ranks.run_jobs, 2, "gloo", args=([
        dict(kind="rollouts", cfg=cross, keys=keys, ticks=10, paths=paths),
        dict(kind="cities", cfg=c4, keys=k4, ticks=10, paths=paths)],))
    w = synth.crossroad_world(cross)
    one = {"rollouts": _both_paths(lambda: _unsharded(mesh.run_batch_shared(
        cross, mesh.tile_dynamic(w, keys), 10))),
        "cities": _both_paths(lambda: _unsharded(mesh.run_chunk_batch(
            c4, sim.init_worlds(c4, k4), 10)))}
    for j, name in enumerate(("rollouts", "cities")):
        for path in ("per_tick", "mega"):
            got = out[0][j][path]["digests"]
            for b in range(4):
                _check(f"{name} {path} world {b}", one[name][path][b],
                       got[b])
            for r in (0, 1):
                la = out[r][j][path]["launches"]
                if path == "mega":
                    assert la["mega"] + la["mega_worlds"] == 2   # 10 ticks
                    assert la["decide_move"] + la["decide_move_blocks"] == 0
                else:
                    assert la["decide_move"] + la["decide_move_blocks"] == 10
                    assert la["prefix_planes"] == 10


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card():
    """`dryrun_multichip(2)` with its 8 worlds on cuda:0 (gloo): every
    rank trains, the all-reduced total and the worlds' integer leaves
    are JAX's (the trained floats within the tolerance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dig = _digests()["mesh_digest"]
    z = _trained("mesh_trained.npz")
    out = dryrun.dryrun_multichip(2, dig["dryrun_worlds"], backend="gloo")
    assert [r["total"] for r in out] == [dig["dryrun_total"]] * 2
    for b, got in enumerate(out[0]["digests"][0]):
        _check(f"world {b}", {k: d for k, d in dig["dryrun_tick1"][b].items()
                              if "sum" not in d or k.startswith(TRAINED)},
               {k: d for k, d in got.items()
                if "sum" not in d or k.startswith(TRAINED)},
               lambda k, b=b: z.get(f"dryrun_tick1|{b}|{k}"))
