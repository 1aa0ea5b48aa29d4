"""The frozen reference against the JAX package itself, on the CPU: the
witness that what the reference computes is JAX's semantics, and not
only the port's from which it was copied.

  * config #4's city (`tsim_bench/configs/sweep64x1024.json`, at its own
    64x64 size) from one of the batch's keys, and 10 ticks of the
    per-tick path;
  * the headline's set-up steps (`init_world`, `measure_and_shrink`,
    `inject_vehicles`) on a 64x64 city, and 10 ticks of the megakernel
    path, which JAX's per-tick path must give (JAX's `run_chunk`;
    `tests/test_megakernel.py` holds JAX's own megakernel to it).

Every leaf must be equal, f32 leaves too.  Each witness runs in a
process of its own (this file run as a script), so that JAX never loads
in the process of the other tests, whose harness refuses it; that
process imports JAX and the reference, never the port.  XLA's CPU
compile of JAX's `run_chunk` takes about two minutes at the
configurations' five movement sub-rounds."""

import functools
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tsim_bench.common import HERE, REFERENCE, Pkg  # noqa: E402

N_TICKS = 10


def _jax():
    import jax
    return jax


def _jax_leaves(world) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_torch_snapshot import world_to_leaves
    return world_to_leaves(world)


def _differ(want: dict, got: dict) -> list:
    """(leaf, elements that differ) of every leaf of `want` (JAX's) that
    the reference's `got` does not equal."""
    bad = []
    for k, a in want.items():
        b = got.get(k)
        if b is None or a.shape != b.shape or a.dtype != b.dtype:
            bad.append((k, "missing" if b is None else
                        f"{a.shape} {a.dtype} / {b.shape} {b.dtype}"))
        elif not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
            bad.append((k, int((a != b).sum())))
    return bad


def _configs(values: dict):
    from trafficsimulation_tpu.config import Config as JConfig
    ref = Pkg(REFERENCE)
    return JConfig(**values), ref.make_config(values)


def _run_jax(cfg, world, n):
    from trafficsimulation_tpu import sim as jsim
    return _jax().jit(functools.partial(jsim.run_chunk, cfg, n=n))(world)


def witness_config4():
    jax = _jax()
    os.environ["TSIM_NO_MEGAKERNEL"] = "1"
    from trafficsimulation_tpu import sim as jsim
    values = json.loads((HERE / "configs" / "sweep64x1024.json")
                        .read_text())["config"]
    jcfg, rcfg = _configs(values)
    ref = Pkg(REFERENCE)
    jkey = jax.random.split(jax.random.PRNGKey(2**31 + 5), 1024)[700]
    rkey = ref.prng.split(ref.prng.PRNGKey(2**31 + 5), 1024)[700]
    assert np.array_equal(np.asarray(jkey), rkey)
    jw = jax.jit(functools.partial(jsim.init_world, jcfg))(jkey)
    rw = ref.sim.init_world(rcfg, rkey, "cpu")
    assert _differ(_jax_leaves(jw), ref.transfer.world_to_numpy(rw)) == []
    jend = _jax_leaves(_run_jax(jcfg, jw, N_TICKS))
    rend = ref.transfer.world_to_numpy(ref.sim.run_chunk(rcfg, rw, N_TICKS))
    assert _differ(jend, rend) == []
    assert jend["metrics.created_internal"] + \
        jend["metrics.created_through"] > 0


def witness_headline():
    jax = _jax()
    sys.path.insert(0, ROOT)
    import bench
    from trafficsimulation_tpu import sim as jsim
    values = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6,
                  SIDEWALK_RING_WIDTH=2, MAX_FIELD_DESTS=640,
                  MAX_VEHICLES=400)
    jcfg, rcfg = _configs(values)
    ref = Pkg(REFERENCE)
    jw = jax.jit(functools.partial(jsim.init_world, jcfg))(
        jax.random.PRNGKey(2**31 + 7))
    jcfg, jw = jsim.measure_and_shrink(jcfg, jw)
    jw = bench.inject_vehicles(jcfg, jw, 300)
    rw = ref.sim.init_world(rcfg, ref.prng.PRNGKey(2**31 + 7), "cpu")
    rcfg, rw = ref.sim.measure_and_shrink(rcfg, rw)
    rw = ref.sim.inject_vehicles(rcfg, rw, 300)
    assert rcfg.MAX_FIELD_DESTS == jcfg.MAX_FIELD_DESTS < 640
    assert _differ(_jax_leaves(jw), ref.transfer.world_to_numpy(rw)) == []
    os.environ["TSIM_NO_MEGAKERNEL"] = "1"
    jend = _jax_leaves(_run_jax(jcfg, jw, N_TICKS))
    del os.environ["TSIM_NO_MEGAKERNEL"]
    os.environ["TSIM_MEGA_INTERPRET"] = "1"
    assert ref.megakernel.mega_ok(rcfg, rw)
    rend = ref.transfer.world_to_numpy(ref.sim.run_chunk(rcfg, rw, N_TICKS))
    assert _differ(jend, rend) == []


WITNESSES = {"config4": witness_config4, "headline": witness_headline}


@pytest.mark.parametrize("name", sorted(WITNESSES))
def test_witness(name):
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the JAX package needs jax, which is not installed")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TSIM_")}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.abspath(__file__), name],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=1500)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]


if __name__ == "__main__":
    WITNESSES[sys.argv[1]]()
    print(f"witness {sys.argv[1]}: every leaf equal")
