"""Hierarchical routing in the PyTorch port against the JAX package, on
the CPU: the routing-id arithmetic and the two selects on random inputs,
the host-side id assignment, `init_world_hier` on a 64x64 city whose
16-cell tiles make 3x3 windows that do not cover the grid (so both the
windowed bytes and the hub rows route), every leaf including
`local_sdir4` and `dests.rid`, and one 5-tick routing segment of
`run_chunk` on it.

Integer and bool leaves must be equal.  f32 leaves are compared with
rtol=1e-6, atol=0, and should be exact for the reasons given in
test_torch_sim.py.  The run uses VEHICLE_MAX_SPEED=2 to keep XLA's CPU
compile of the JAX `run_chunk` short (test_torch_sim.py); on the card
`chip_smoke.py` holds config #5 cut to 512^2 with the default 5
sub-rounds to a JAX digest."""

import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from trafficsimulation_tpu.config import Config
from trafficsimulation_tpu import sim as jsim
from trafficsimulation_tpu.gen import hier as jghier
from trafficsimulation_tpu.ops import hier as jhier

from trafficsimulation_tpu_torch import prng
from trafficsimulation_tpu_torch import sim as tsim
from trafficsimulation_tpu_torch.config import Config as TConfig
from trafficsimulation_tpu_torch.core.transfer import world_to_numpy
from trafficsimulation_tpu_torch.gen import hier as tghier
from trafficsimulation_tpu_torch.ops import hier as thier
from trafficsimulation_tpu_torch.ops import hopper_engine as HE

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from make_torch_snapshot import world_to_leaves  # noqa: E402
from test_torch_sim import assert_leaves_match  # noqa: E402

torch.set_num_threads(2)

KW = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
          MAX_VEHICLES=256, ROUTING_HIER=True, HIER_TILE=16, HIER_LMAX=8,
          INTERNAL_POPULATION_TRAFFIC_PER_DAY=2000,
          PASSING_POPULATION_TRAFFIC_PER_DAY=500)
CFG, TCFG = Config(**KW), TConfig(**KW)
N_VEH = 200


def test_hier_rows_and_selects_match_jax():
    hp = thier.hier_params(TCFG)
    rng = np.random.default_rng(4)
    dest = rng.integers(0, hp.direct_base + 40, (64, 64)).astype(np.int32)
    dest[:3] = 16383                                   # DEST_NONE rows
    p, r = jax.jit(functools.partial(jhier.hier_rows, CFG))(dest)
    tp, tr = thier.hier_rows(TCFG, torch.from_numpy(dest))
    assert np.array_equal(np.asarray(p), tp.numpy())
    assert np.array_equal(np.asarray(r), tr.numpy())
    assert (tp.numpy() >= 0).any() and (tp.numpy() < 0).any()
    local4 = rng.integers(-2**31, 2**31, (9 * hp.lmax // 4, 64, 64),
                          dtype=np.int64).astype(np.int32)
    dense4 = rng.integers(-2**31, 2**31, (5, 64, 64),
                          dtype=np.int64).astype(np.int32)
    # JAX's masked reduction and K6's plain version
    ref = jax.jit(jhier.select_planes)(local4, np.asarray(p))
    assert np.array_equal(np.asarray(ref), HE.select_dest_rows(
        torch.from_numpy(local4), tp).numpy())
    ref = jax.jit(functools.partial(jhier.hier_select, CFG))(
        dense4, local4, dest)
    got = thier.hier_select(TCFG, torch.from_numpy(dense4),
                            torch.from_numpy(local4), torch.from_numpy(dest))
    assert np.array_equal(np.asarray(ref), got.numpy())


@pytest.fixture(scope="module")
def hier_worlds():
    """(JAX cfg, world, port cfg, world), both with N_VEH vehicles."""
    from bench import inject_vehicles
    cfg, w = jsim.init_world_hier(CFG, jax.random.PRNGKey(0))
    tcfg, tw = tsim.init_world_hier(TCFG, prng.PRNGKey(0), "cpu")
    return (cfg, inject_vehicles(cfg, w, N_VEH), tcfg,
            tsim.inject_vehicles(tcfg, tw, N_VEH))


def test_assign_hier_matches_jax(hier_worlds):
    """The port's copies of the host-side id assignment and tables."""
    _, w, _, _ = hier_worlds
    pos, valid, kind = (np.asarray(a) for a in (
        w.dests.pos, w.dests.valid, w.dests.kind))
    ref = jghier.assign_hier_np(CFG, pos, valid, kind)
    got = tghier.assign_hier_np(TCFG, pos, valid, kind)
    for k in ref:
        assert np.array_equal(ref[k], got[k]), k
    rt = jghier.hier_tables_np(CFG, ref, pos, 64, 64)
    gt = tghier.hier_tables_np(TCFG, got, pos, 64, 64)
    for k in rt:
        assert np.array_equal(np.asarray(rt[k]), gt[k]), k


def test_init_world_hier_matches_jax(hier_worlds):
    cfg, w, tcfg, tw = hier_worlds
    assert tcfg.CAP_OVERRIDES == cfg.CAP_OVERRIDES
    assert tcfg.MAX_FIELD_DESTS == cfg.MAX_FIELD_DESTS
    ref, got = world_to_leaves(w), world_to_numpy(tw)
    assert ref.keys() == got.keys()
    assert_leaves_match(ref, got, skip=())
    assert "local_sdir4" in got and "dests.rid" in got
    # windows do not cover the grid: some cells route by the hub rows
    p, _ = thier.hier_rows(tcfg, tw.grid.dest_id.new_full((64, 64), 0))
    assert bool((p < 0).any()) and bool((p >= 0).any())


def test_hier_run_chunk_matches_jax(hier_worlds):
    cfg, w, tcfg, tw = hier_worlds
    cfg, tcfg = (c.replace(VEHICLE_MAX_SPEED=2) for c in (cfg, tcfg))
    n = tcfg.PATHFINDING_COOLDOWN
    ref = world_to_leaves(jax.jit(functools.partial(
        jsim.run_chunk, cfg, n=n))(w))
    got = world_to_numpy(tsim.run_chunk(tcfg, tw, n))
    assert_leaves_match(ref, got, skip=())
    assert (ref["vehicles.pos"] != world_to_leaves(w)["vehicles.pos"]).any()
