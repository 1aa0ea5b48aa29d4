"""Worlds carried from the JAX package into the port: the leaf mapping
round trip, the shipped headline snapshot, and the port running with
JAX unavailable."""

import functools
import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from trafficsimulation_tpu.config import Config
from trafficsimulation_tpu.core.synth import crossroad_world

from trafficsimulation_tpu_torch import snapshot
from trafficsimulation_tpu_torch import sim as tsim
from trafficsimulation_tpu_torch.core.transfer import (world_from_numpy,
                                                       world_to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_torch_snapshot as writer  # noqa: E402

torch.set_num_threads(2)

CROSS_KW = dict(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64,
                RAIN_SPAWN_CHANCE=0.5, RAIN_RADIUS_MIN=3, RAIN_RADIUS_MAX=9,
                VEHICLE_MAX_SPEED=2)


def test_transfer_round_trip_is_identical(small_world):
    leaves = writer.world_to_leaves(small_world)
    back = world_to_numpy(world_from_numpy(leaves, "cpu"))
    assert back.keys() == leaves.keys()
    for k, a in leaves.items():
        b = back[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert back["key"].dtype == np.uint32


def test_init_states_match_jax(small_cfg, small_world):
    """The port's pool / metrics / rain / blocks initialisers give the
    JAX package's leaves."""
    from trafficsimulation_tpu import sim as jsim
    from trafficsimulation_tpu.agents import blocks as jblocks
    from trafficsimulation_tpu.agents import rain as jrain
    from trafficsimulation_tpu_torch.agents import blocks as tblocks
    from trafficsimulation_tpu_torch.agents import rain as train

    tw = world_from_numpy(writer.world_to_leaves(small_world), "cpu")
    pairs = [(jsim.init_vehicles(64), tsim.init_vehicles(64, "cpu")),
             (jsim.init_metrics(), tsim.init_metrics("cpu")),
             (jrain.init_rain_state(small_cfg),
              train.init_rain_state(small_cfg, "cpu")),
             (jblocks.init_blocks_state(small_world.blocks_static),
              tblocks.init_blocks_state(tw.blocks_static))]
    for ref, got in pairs:
        a = writer.world_to_leaves(ref)
        b = world_to_numpy(got)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_shipped_snapshot_matches_its_config(small_world):
    assert os.path.getsize(snapshot.HEADLINE) < 1 << 20
    cfg, world, ref = snapshot.load_snapshot(device="cpu")
    caps = cfg.capacities()
    assert (cfg.HEIGHT, cfg.WIDTH, cfg.MAX_FIELD_DESTS) == (256, 256, 608)
    assert world.cost_field is None
    assert ref["field_shape"] == (608, 4, 256, 256)
    assert len(ref["field_sha256"]) == 64 and ref["ticks"] == 23
    assert ref["field_row_sums"].shape == (608,)
    sizes = {"vehicles.active": caps.max_vehicles,
             "lights_static.valid": caps.max_lights,
             "groups_static.valid": caps.max_groups,
             "blocks_static.valid": caps.max_blocks,
             "dests.valid": caps.max_dests,
             "dests.hw_valid": caps.max_exits,
             "nearest_exit": caps.max_dests,
             "lights.light_stop": caps.max_lights,
             "overrides.light_force": caps.max_lights,
             "rain.active": cfg.RAIN_OCCURRENCES_MAX}
    got = world_to_numpy(world)
    for k, n in sizes.items():
        assert got[k].shape == (n,), (k, got[k].shape, n)
    for k in ("grid.cell_type", "veh_map", "stop_map", "density"):
        assert got[k].shape == (256, 256), k
    # every leaf has the JAX package's dtype (and so has the reference)
    jl = writer.world_to_leaves(small_world)
    assert got.keys() == jl.keys() - {"cost_field"}
    for k, a in got.items():
        assert a.dtype == jl[k].dtype, k
    for k, a in ref["end"].items():
        assert a.dtype == got[k].dtype and a.shape == got[k].shape, k
    assert int(got["vehicles.active"].sum()) == 10_000
    assert int(ref["end"]["tick"]) == 23


def _write_crossroad_snapshot(path):
    cfg = Config(**CROSS_KW)
    leaves = writer.world_to_leaves(crossroad_world(cfg))
    leaves.pop("cost_field")
    np.savez_compressed(path, **leaves,
                        **{"meta.cfg_json": np.array(json.dumps(CROSS_KW))})


def test_port_runs_without_jax(tmp_path):
    """Every module of the port imports, and a 3-tick CPU `run_chunk` on
    a crossroad snapshot runs, in a process where `import jax` fails;
    the result equals the same run in this process."""
    path = tmp_path / "cross.npz"
    out = tmp_path / "end.npz"
    _write_crossroad_snapshot(path)
    code = textwrap.dedent(f"""
        import sys, importlib, pkgutil
        for m in ("jax", "jaxlib", "flax", "optax"):
            sys.modules[m] = None
        import numpy as np
        import trafficsimulation_tpu_torch as pkg
        for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(info.name)
        from trafficsimulation_tpu_torch import snapshot, sim
        from trafficsimulation_tpu_torch.core.transfer import world_to_numpy
        cfg, w, _ = snapshot.load_snapshot({str(path)!r}, device="cpu")
        w = sim.run_chunk(cfg, snapshot.build_field(cfg, w), 3)
        np.savez({str(out)!r}, **world_to_numpy(w))
        assert not any(m.startswith("jax") for m in sys.modules
                       if sys.modules[m] is not None)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]

    cfg, w, _ = snapshot.load_snapshot(path, device="cpu")
    mine = world_to_numpy(tsim.run_chunk(cfg, snapshot.build_field(cfg, w),
                                         3))
    with np.load(out) as z:
        assert set(z.files) == set(mine)
        for k in z.files:
            assert np.array_equal(z[k], mine[k]), k
    assert int(mine["tick"]) == 3


@pytest.mark.slow
def test_shipped_snapshot_reproduces_from_jax():
    """Re-run the writer's JAX steps at 256^2 (about 7 minutes on CPU)
    and check the shipped file against them."""
    import jax
    from trafficsimulation_tpu.sim import run_chunk
    cfg, world = writer.build_headline()
    leaves = writer.world_to_leaves(world)
    field = leaves.pop("cost_field")
    with np.load(snapshot.HEADLINE) as z:
        shipped = {k: z[k] for k in z.files}
    assert json.loads(str(shipped["meta.cfg_json"])) == \
        writer.cfg_overrides(cfg)
    assert str(shipped["meta.field_sha256"]) == \
        hashlib.sha256(field.tobytes()).hexdigest()
    for k, a in leaves.items():
        assert np.array_equal(shipped[k], a), k
    end = jax.jit(functools.partial(run_chunk, cfg, n=23))(world)
    for k, a in writer.world_to_leaves(end).items():
        if "ref." + k in shipped:
            assert np.array_equal(shipped["ref." + k], a), k
