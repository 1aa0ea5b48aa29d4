"""The port's shared-geometry world batch against the JAX package: the
same crossroad world, tiled for B = 3 keys, goes through JAX's
`run_batch_shared` (one jit compile, cached at module level) and the
port's, and every leaf must agree; world b of the port's batch must equal
the port's single-world `run_chunk` with key b.  Also here: the batch's
helpers (`tile_dynamic`, the demand-window guard), the dense light
reducers against the sparse forms, the plain K5 against JAX's
`build_sdir_pallas_batched` in interpret mode, the update-order
scatter-add against XLA's, and the port's independence from the JAX
package (no import of it; its own `Config` equal to JAX's).

Tolerances as in test_torch_sim.py: integer and bool leaves exact, f32
leaves rtol 1e-6 (in fact exact).  The worlds run with
VEHICLE_MAX_SPEED=2 for one 5-tick routing segment to keep the one JAX
compile small (about 19 s on the CPU; a second segment shape, as at 6
ticks, takes it to about 100 s).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu.config import Config as JConfig
from trafficsimulation_tpu.core.synth import crossroad_world
from trafficsimulation_tpu.ops import engine as jengine
from trafficsimulation_tpu.ops import pallas_engine
from trafficsimulation_tpu.parallel import mesh as jmesh

from trafficsimulation_tpu_torch import sim as tsim
from trafficsimulation_tpu_torch import snapshot
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core.transfer import (world_from_numpy,
                                                       world_to_numpy)
from trafficsimulation_tpu_torch.lights import fsm
from trafficsimulation_tpu_torch.ops import engine
from trafficsimulation_tpu_torch.ops import hopper_engine as HE
from trafficsimulation_tpu_torch.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from make_torch_snapshot import world_to_leaves  # noqa: E402

torch.set_num_threads(2)

CROSS_KW = dict(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64,
                RAIN_SPAWN_CHANCE=0.5, RAIN_RADIUS_MIN=3, RAIN_RADIUS_MAX=9,
                VEHICLE_MAX_SPEED=2)
CROSS, JCROSS = Config(**CROSS_KW), JConfig(**CROSS_KW)
B = 3
N_TICKS = 5


def assert_leaves_match(ref: dict, got: dict):
    """Every leaf of `ref` equals `got`: integers and bools exactly, f32
    within rtol=1e-6."""
    bad = []
    for k, a in ref.items():
        assert k in got, f"port has no leaf {k}"
        b = got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (k, a.shape, a.dtype, b.shape, b.dtype)
        if np.issubdtype(a.dtype, np.floating):
            if not np.allclose(a, b, rtol=1e-6, atol=0.0):
                bad.append((k, int((a != b).sum())))
        elif not np.array_equal(a, b):
            bad.append((k, int((a != b).sum())))
    assert not bad, f"leaves differ (name, entries): {bad}"


def _keys():
    return np.asarray(jax.random.split(jax.random.PRNGKey(9), B))


@functools.cache
def _batch_runs():
    """(JAX end leaves, port end batch, port launch counts per wrapper
    call) of one crossroad batch; the port runs with vmap's per-example
    fallback turned into an error."""
    world = crossroad_world(JCROSS)
    jbatch = jmesh.tile_dynamic(world, jnp.asarray(_keys()))
    jend = jax.jit(functools.partial(jmesh.run_batch_shared, JCROSS,
                                     n_ticks=N_TICKS))(jbatch)
    port = world_from_numpy(world_to_leaves(world), "cpu")
    calls = {}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    names = ("decide_move_batched", "build_sdir_batched",
             "build_wavefront_batched", "prefix_planes_batched",
             "ordered_add_rows", "_sdir_single")
    saved = {n: getattr(HE, n) for n in names}
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        for n in names:
            setattr(HE, n, counted(n, saved[n]))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            end = mesh.run_batch_shared(
                CROSS, mesh.tile_dynamic(port, _keys()), N_TICKS)
    finally:
        for n in names:
            setattr(HE, n, saved[n])
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    jfleet = {k: int(v) for k, v in jmesh.fleet_metrics(jend).items()}
    return world_to_leaves(jend), end, calls, jfleet


def test_run_batch_shared_matches_jax():
    ref, end, _, jfleet = _batch_runs()
    got = world_to_numpy(end)
    assert_leaves_match(ref, got)
    assert {k: int(v) for k, v in mesh.fleet_metrics(end).items()} == jfleet
    assert got["veh_map"].shape == (B, 32, 32)
    assert got["cost_field"].shape == ref["cost_field"].shape
    # the worlds diverged, and the run spawned and moved vehicles
    assert not np.array_equal(got["veh_map"][0], got["veh_map"][1])
    assert (got["metrics.created_internal"]
            + got["metrics.created_through"]).min() > 0


def test_batch_launches_each_kernel_once_per_batch():
    """Each batched kernel (its plain version here) runs once per tick
    or segment for the whole batch, never once per world; K2 not at
    all."""
    _, _, calls, _ = _batch_runs()
    segs = -(-N_TICKS // CROSS.PATHFINDING_COOLDOWN)
    assert calls == {"decide_move_batched": N_TICKS,
                     "prefix_planes_batched": N_TICKS,
                     "ordered_add_rows": N_TICKS,
                     "build_sdir_batched": segs,
                     "build_wavefront_batched": segs}


@pytest.mark.parametrize("b", range(B))
def test_batch_world_equals_single_world_run(b):
    _, end, _, _ = _batch_runs()
    leaves = world_to_leaves(crossroad_world(JCROSS))
    leaves["key"] = _keys()[b]
    single = tsim.run_chunk(CROSS, world_from_numpy(leaves, "cpu"), N_TICKS)
    got = world_to_numpy(mesh.world_at(end, b))
    ref = world_to_numpy(single)
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


def test_tile_dynamic_leaf_shapes_match_jax():
    world = crossroad_world(JCROSS)
    ref = world_to_leaves(jmesh.tile_dynamic(world, jnp.asarray(_keys())))
    got = world_to_numpy(mesh.tile_dynamic(
        world_from_numpy(world_to_leaves(world), "cpu"), _keys()))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape and \
            got[k].dtype == ref[k].dtype, k
        assert np.array_equal(got[k], ref[k]), k
    axes = mesh.shared_geometry_axes(world_from_numpy(ref, "cpu"))
    assert axes["cost_field"] is None and axes["grid.is_road"] is None
    assert axes["demand.cursor"] == 0 and axes["demand.origin"] is None
    assert axes["veh_map"] == 0 and axes["key"] == 0


def test_demand_window_guard():
    """As tests/test_parallel.py::test_demand_window_guard: a batched
    rollout past the pre-generated trip table fails loudly."""
    world = crossroad_world(JCROSS)
    port = world_from_numpy(world_to_leaves(world), "cpu")
    rem = mesh.demand_ticks_remaining(port)
    assert rem == jmesh.demand_ticks_remaining(world) > 0
    mesh.assert_demand_window(CROSS, port, min(rem, 2))
    batch = mesh.tile_dynamic(port, _keys()[:2])
    assert mesh.demand_ticks_remaining(batch) == rem
    with pytest.raises(RuntimeError, match="outruns the pre-generated"):
        mesh.run_batch_shared(CROSS, batch, n_ticks=rem + 1)


def test_dense_reducers_match_sparse():
    """The dense light reductions (forced on at 32^2): the matrices are
    JAX's; the stop map equals the sparse form's; the queue counts equal
    JAX's dense counts on every bucket and the sparse run form's on the
    in-buckets and the occupied flag.  (The one-hot M follows the
    per-cell labels, one bucket per cell, so on this world its out-bucket
    counts differ from the run form in JAX as well; the headline does
    not use M, `dense_reducer_modes`.)"""
    from trafficsimulation_tpu.lights import fsm as jfsm
    world = crossroad_world(JCROSS)
    port = world_from_numpy(world_to_leaves(world), "cpu")
    g, ls, gs = port.grid, port.lights_static, port.groups_static
    G = CROSS.capacities().max_groups
    M, A = fsm.build_dense_reducers(CROSS, g, ls)
    jM, jA = jax.jit(functools.partial(jfsm.build_dense_reducers, JCROSS))(
        world.grid, world.lights_static)
    assert np.array_equal(M.numpy(), np.asarray(jM, np.float32))
    assert np.array_equal(A.float().numpy(), np.asarray(jA, np.float32))
    rng = np.random.default_rng(3)
    for _ in range(4):
        occ = torch.from_numpy(rng.random((32, 32)) < 0.4)
        sparse = fsm.group_reductions(g, occ, G, gs)
        dense = fsm.group_reductions(g, occ, G, gs, dense_m=M)
        jdense = jfsm.group_reductions(world.grid, jnp.asarray(occ.numpy()),
                                       G, dense_m=jM)
        for d, j in zip(dense, jdense):
            assert np.array_equal(d.numpy(), np.asarray(j))
        for i in (fsm.NS_IN, fsm.EW_IN, 4):
            assert torch.equal(sparse[i], dense[i])
        state = port.lights.replace(light_stop=torch.from_numpy(
            rng.random(ls.valid.shape[0]) < 0.5))
        assert torch.equal(fsm.build_stop_map(g, ls, state),
                           fsm.build_stop_map(g, ls, state, dense_a=A))
    assert fsm.dense_reducer_modes(CROSS) == (False, False)
    cfg = snapshot.config_from_json(
        str(np.load(snapshot.HEADLINE)["meta.cfg_json"]))
    assert fsm.dense_reducer_modes(cfg) == (False, True)


@pytest.mark.parametrize("D", [8, 12])
def test_sdir_batched_plain_matches_jax_interpret(D):
    rng = np.random.default_rng(D)
    H, W = 16, 128
    Q = rng.integers(0, 70000, (D, 4, H, W)).astype(np.uint16)
    pen = rng.integers(0, 3000, (B, 4, H, W)).astype(np.int32)
    pen = np.where(rng.random((B, 4, H, W)) < 0.1, 1 << 17, pen)
    legal = (rng.random((4, H, W)) < 0.6).astype(np.int32)
    K0 = jengine.costs_u16_to_keys(jnp.asarray(Q))
    ref = np.asarray(pallas_engine.build_sdir_pallas_batched(
        JCROSS, K0, jnp.asarray(pen), jnp.asarray(legal), interpret=True))
    tp2 = int(round(2 * CROSS.VEHICLE_TURN_PENALTY))
    K0 = torch.from_numpy(np.array(K0))
    got = HE.build_sdir_batched(K0, torch.from_numpy(pen),
                                torch.from_numpy(legal), tp2)
    assert np.array_equal(got.numpy(), ref)
    # under vmap the single-world wrapper with a shared stack is K5
    vm = torch.func.vmap(HE.build_sdir, in_dims=(None, 0, None, None))(
        K0, torch.from_numpy(pen), torch.from_numpy(legal), tp2)
    assert np.array_equal(vm.numpy(), ref)


def test_ordered_add_matches_xla_scatter_order():
    """f32 updates whose sum depends on the order: the plain version (and
    so the card's kernel, held to it in test_torch_cuda.py) folds them
    exactly as XLA's CPU scatter-add does."""
    base = np.array([1.0, 0.0, 5.0, 2.0], np.float32)
    idx = np.array([0, 0, 0, 2, 1, 0, 3, 3, 3, 3], np.int64)
    vals = np.array([1e8, 1.0, -1e8, 2.0, 7.0, 0.5, 3e7, -3e7, 1.0, 0.25],
                    np.float32)
    ref = np.asarray(jnp.asarray(base).at[idx].add(jnp.asarray(vals)))
    got = HE.ordered_add(torch.from_numpy(base)[None],
                         torch.from_numpy(idx)[None],
                         torch.from_numpy(vals)[None])[0].numpy()
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    assert ref[0] != np.float32(np.float32(1.0 + 1.0) + 0.5)


def test_port_imports_nothing_of_jax():
    """A process that imports every module of the port (among them the
    pedestrians and the synthetic worlds) has loaded neither jax nor any
    module of the JAX package."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import trafficsimulation_tpu_torch as pkg\n"
        "for i in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(i.name)\n"
        "new = ('agents.pedestrians', 'core.synth', 'utils')\n"
        "assert all(pkg.__name__ + '.' + m in sys.modules for m in new)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'trafficsimulation_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stderr[-3000:]


def _config_overrides(which, small_cfg) -> dict:
    if which == "default":
        return {}
    if which == "small":
        d = dataclasses.asdict(small_cfg)
        d0 = dataclasses.asdict(JConfig())
        return {k: getattr(small_cfg, k) for k in d if d[k] != d0[k]}
    kw = json.loads(str(np.load(snapshot.HEADLINE)["meta.cfg_json"]))
    kw["CAP_OVERRIDES"] = tuple(tuple(p) for p in kw.get("CAP_OVERRIDES",
                                                         ()))
    return kw


@pytest.mark.parametrize("which", ["default", "small", "snapshot"])
def test_config_copy_matches_jax(which, small_cfg):
    """The port's own Config has the JAX Config's fields, defaults and
    capacities (for the default, the tests' SMALL and the snapshot's
    configuration)."""
    assert [f.name for f in dataclasses.fields(JConfig)] == \
        [f.name for f in dataclasses.fields(Config)]
    kw = _config_overrides(which, small_cfg)
    j, p = JConfig(**kw), Config(**kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert dataclasses.asdict(j.capacities()) == \
        dataclasses.asdict(p.capacities())
    if which == "snapshot":
        assert dataclasses.asdict(snapshot.config_from_json(
            json.dumps(kw))) == dataclasses.asdict(j)
