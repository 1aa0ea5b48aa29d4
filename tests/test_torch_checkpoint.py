"""The port's checkpoints (`checkpoint.py`, `torch.save` of every leaf
and the JAX package's `config.json`): a saved world comes back leaf for
leaf, the RL controller's parameters and Adam state among them, and an
A2C crossroad run saved at tick 9 and resumed equals the run that went
through, bit for bit, at tick 20 (A2C trains every 4 ticks, so updates
fall on both sides of the cut)."""

import json

import numpy as np
import torch

from trafficsimulation_tpu import checkpoint as jcheckpoint
from trafficsimulation_tpu.config import Config as JConfig
from trafficsimulation_tpu.core import synth as jsynth

from trafficsimulation_tpu_torch import checkpoint, sim
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core import synth
from trafficsimulation_tpu_torch.core.transfer import world_to_numpy

torch.set_num_threads(2)

CROSS = dict(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64,
             VEHICLE_MAX_SPEED=2, TRAFFIC_LIGHT_AGENT_ALGORITHM="RL_A2C_BATCHED",
             A2C_UPDATE_EVERY=4)


def _equal(a: dict, b: dict):
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def test_save_restore_every_leaf(tmp_path):
    cfg = Config(**CROSS)
    w = sim.run_chunk(cfg, synth.crossroad_world(cfg, device="cpu"), 6)
    assert int(w.rl.opt_state.count) == 1
    checkpoint.save(str(tmp_path / "ck"), w, cfg)
    back = checkpoint.restore(str(tmp_path / "ck"), template=w)
    _equal(world_to_numpy(w), world_to_numpy(back))
    assert back.key.device == w.key.device
    # config.json as the JAX package writes it
    jcfg = JConfig(**CROSS)
    jcheckpoint.save(str(tmp_path / "jax"), jsynth.crossroad_world(jcfg),
                     jcfg)
    with open(tmp_path / "ck" / "config.json") as f:
        got = f.read()
    with open(tmp_path / "jax" / "config.json") as f:
        assert got == f.read()
    assert json.loads(got)["TRAFFIC_LIGHT_AGENT_ALGORITHM"] == \
        "RL_A2C_BATCHED"


def test_resume_equals_uninterrupted_run(tmp_path):
    cfg = Config(**CROSS)
    w0 = synth.crossroad_world(cfg, device="cpu")
    straight = sim.run_chunk(cfg, sim.run_chunk(cfg, w0, 9), 11)
    first = sim.run_chunk(cfg, w0, 9)
    checkpoint.save(str(tmp_path), first, cfg)
    resumed = sim.run_chunk(cfg, checkpoint.restore(str(tmp_path),
                                                    device="cpu"), 11)
    assert int(straight.rl.opt_state.count) == 5
    _equal(world_to_numpy(straight), world_to_numpy(resumed))
