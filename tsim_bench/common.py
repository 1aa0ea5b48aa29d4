"""What the harness, the checks and the controls share: the paths, the
manifest and the per-name files, the two packages (the program and the
frozen reference) behind one interface, and the keys drawn from the
seed."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "trafficsimulation_tpu_torch"
REFERENCE = "tsim_bench.reference.tsim_ref"
# top-level module names that may not be loaded where the program runs
FORBIDDEN = ("jax", "jaxlib", "flax", "trafficsimulation_tpu")
# the program's path switches (ops/megakernel.mega_ok); a cell sets one
PATH_SWITCHES = ("TSIM_MEGA_FORCE", "TSIM_NO_MEGAKERNEL",
                 "TSIM_MEGA_INTERPRET")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load(kind: str, name: str) -> dict:
    """tsim_bench/<kind>/<name>.json (kind: configs or cells)."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def module(kind: str, name: str):
    """The module tsim_bench/<kind>/<name>.py (steps, rollouts, metrics),
    loaded from its file."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"tsim_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(names) -> list:
    """The entries of `names` (module names) whose top-level name, the
    part before the first dot, is one of FORBIDDEN, compared whole."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


class Pkg:
    """The modules the harness calls, of the program or of the reference
    copy (the copy mirrors the program's module tree, one world at a
    time: no `mesh`, and its kernels' plain versions in `ops/plain.py`)."""

    def __init__(self, root: str):
        self.root = root

    def __getattr__(self, name):
        path = {"sim": "sim", "prng": "prng", "mesh": "parallel.mesh",
                "transfer": "core.transfer", "config": "config",
                "megakernel": "ops.megakernel",
                "HE": ("ops.plain" if self.root == REFERENCE
                       else "ops.hopper_engine")}[name]
        mod = importlib.import_module(f"{self.root}.{path}")
        setattr(self, name, mod)
        return mod

    def make_config(self, values: dict):
        return self.config.Config(**values)


def config_values(cfg) -> dict:
    """A Config's fields as plain values (nested dataclasses as dicts),
    comparable across the program's and the reference's classes."""
    return dataclasses.asdict(cfg)


def rollout_keys(seed: int, rollout: int, n: int) -> np.ndarray:
    """The n worlds' keys of rollout `rollout` of a run with `seed`:
    uint32 [n, 2], the same for the program and the reference."""
    rng = np.random.default_rng([int(seed), int(rollout), n])
    return rng.integers(0, 1 << 32, size=(n, 2), dtype=np.uint64) \
        .astype(np.uint32)


def sample_worlds(seed: int, n_worlds: int, k: int) -> list:
    """k of the n_worlds worlds, one drawn from the seed in each of k
    equal strata, so that both halves, and every k-th part, of the batch
    are looked at."""
    k = min(k, n_worlds)
    rng = np.random.default_rng([int(seed), 7919])
    edges = np.linspace(0, n_worlds, k + 1).astype(int)
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges[:-1],
                                                        edges[1:])]


def build(pkg, cfgj: dict, seed: int, device, sample=None):
    """The configuration's set-up steps (`tsim_bench/steps/<step>.py`) in
    `pkg`, the program or the reference: (Config, world).  `sample`: the
    worlds a step that builds a batch of cities builds (the reference's
    sample); None for all."""
    ctx = {"cfg": pkg.make_config(cfgj["config"]),
           "key": pkg.prng.PRNGKey(seed), "device": device, "world": None,
           "sample": sample}
    for step in cfgj["steps"]:
        params = {k: v for k, v in step.items() if k != "step"}
        module("steps", step["step"]).run(pkg, ctx, **params)
    return ctx["cfg"], ctx["world"]
