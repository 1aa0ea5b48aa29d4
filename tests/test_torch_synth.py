"""The port's synthetic worlds (`core/synth.py`) and host helpers
(`utils.py`) against the JAX package's.

`crossroad_world` must equal JAX's leaf for leaf, its key stack
included, at several configurations: the crossroad of the simulation
tests, with pedestrians, without traffic, a larger non-square one, and
another key, and with an RL controller.  `empty_statics` must equal
JAX's tables.  No JAX compile: JAX's crossroad is built eagerly.
"""

import dataclasses
import sys
import os

import numpy as np
import pytest
import torch

from trafficsimulation_tpu import utils as jutils
from trafficsimulation_tpu.config import Config as JConfig
from trafficsimulation_tpu.core import synth as jsynth

from trafficsimulation_tpu_torch import prng, utils
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core import synth
from trafficsimulation_tpu_torch.core.transfer import world_to_numpy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_snapshot import world_to_leaves  # noqa: E402

torch.set_num_threads(2)

BASE = dict(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64,
            VEHICLE_MAX_SPEED=2)


def _pair(**kw):
    return JConfig(**kw), Config(**kw)


def _assert_same(ref: dict, got: dict):
    assert set(ref) == set(got), sorted(set(ref) ^ set(got))
    bad = [k for k in ref if ref[k].dtype != got[k].dtype
           or ref[k].shape != got[k].shape
           or not np.array_equal(ref[k], got[k])]
    assert not bad, f"leaves differ: {bad}"


@pytest.mark.parametrize("kw,seed", [
    (BASE, 0),
    (dict(BASE, PEDESTRIANS_ENABLED=True, PEDESTRIANS_PER_DAY=2_000_000), 0),
    (dict(BASE, ENABLE_TRAFFIC=False), 0),
    (dict(BASE, WIDTH=48, HEIGHT=40, MAX_FIELD_DESTS=6), 5),
], ids=["crossroad", "pedestrians", "no_traffic", "48x40_key5"])
def test_crossroad_world_matches_jax(kw, seed):
    jcfg, tcfg = _pair(**kw)
    import jax
    ref = world_to_leaves(jsynth.crossroad_world(
        jcfg, key=jax.random.PRNGKey(seed)))
    got = world_to_numpy(synth.crossroad_world(
        tcfg, key=prng.PRNGKey(seed), device="cpu"))
    _assert_same(ref, got)


def test_empty_statics_match_jax():
    jcfg, tcfg = _pair(**BASE)
    for ref, got in zip(jsynth.empty_statics(jcfg),
                        synth.empty_statics(tcfg, "cpu")):
        _assert_same({f.name: np.asarray(getattr(ref, f.name))
                      for f in dataclasses.fields(ref)
                      if getattr(ref, f.name) is not None},
                     {f.name: getattr(got, f.name).numpy()
                      for f in dataclasses.fields(got)
                      if getattr(got, f.name) is not None})


def test_crossroad_world_with_rl_raises():
    """With an RL controller (A2C) the crossroad equals JAX's on every
    leaf, the train state's buffers and Adam state among them, and the
    initial parameters, which the port draws as flax does
    (`rl/nets.py`)."""
    import jax
    kw = dict(BASE, TRAFFIC_LIGHT_AGENT_ALGORITHM="RL_A2C_BATCHED")
    jcfg, tcfg = _pair(**kw)
    ref = world_to_leaves(jsynth.crossroad_world(
        jcfg, key=jax.random.PRNGKey(0)))
    got = world_to_numpy(synth.crossroad_world(tcfg, key=prng.PRNGKey(0),
                                               device="cpu"))
    drawn = {k for k in ref if k.startswith("rl.params.")}
    assert len(drawn) == 2 * (tcfg.A2C_HIDDEN_LAYERS + 3)
    assert got["rl.roll_s"].shape == (tcfg.A2C_UPDATE_EVERY,
                                      tcfg.capacities().max_groups, 13)
    _assert_same(ref, got)


def test_flow_helpers_match_jax(capsys, monkeypatch):
    """`assert_flow_mask` on the crossroad's arrows, `interactive_check`
    on scripted input and `str_to_unique_int`, against JAX's."""
    cfg = Config(**BASE)
    w = synth.crossroad_world(cfg, device="cpu")
    allowed = w.grid.allowed_dirs
    ym, xm = cfg.HEIGHT // 2 - 1, cfg.WIDTH // 2 - 1
    utils.assert_flow_mask(allowed, 2, ym, "E", True)
    utils.assert_flow_mask(allowed, 3, ym, "w", False)
    utils.assert_flow_mask(allowed, 3, ym, "S", True)
    with pytest.raises(AssertionError):
        utils.assert_flow_mask(allowed, xm, 3, "S", True)
    lines = iter([f"2 {ym}", f"{xm} 3 n", ""])
    monkeypatch.setattr("builtins.input", lambda _: next(lines))
    utils.interactive_check(allowed)
    got = capsys.readouterr().out
    lines = iter([f"2 {ym}", f"{xm} 3 n", ""])
    jutils.interactive_check(allowed.numpy())
    assert got == capsys.readouterr().out
    assert "['E']" in got and "True" in got
    for s in ("", "Horizontal_1_South_Entrance_1", "block 7"):
        assert utils.str_to_unique_int(s) == jutils.str_to_unique_int(s)
