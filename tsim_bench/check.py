"""The check of the outputs: the state that the timed path produced,
against the frozen plain reference (`tsim_bench/reference/tsim_ref`,
which imports nothing of the program and which a CPU test holds to the
JAX package) run from the same seed and keys, one world at a time.

Compared, on the worlds sampled from the seed (one in each of equal
strata of the batch):

  * the start state the set-up derived (the generated cities, the
    shrunk field, the injected vehicles) and the Config after the set-up
    steps;
  * the state after the checked rollout: every leaf of the world
    (vehicles, veh_map, lights, density, demand cursors, metrics ...).

Numbers: `int_diff`, the integer and boolean elements that differ, at
the start and at the end (a leaf of another shape or dtype, or missing,
counts all its elements; each differing Config field counts one);
`float_gap`, over the f32 leaves of both the largest |program -
reference| over the largest |reference| of the leaf (0 where both are
0).  Their parts at the start and at the end are printed beside them.
The reference runs on the card with every kernel replaced by its plain
PyTorch version, after the program's state is freed.  `run_seconds`
does not hold it: it runs after the window closes.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from tsim_bench.common import (REFERENCE, Pkg, build, config_values,
                               rollout_keys)


def leaves(pkg, world) -> dict:
    """A world's leaves by path, on the host."""
    return {k: t.detach().cpu().numpy()
            for k, t in pkg.transfer.world_leaves(world).items()}


def lower(ref, world, control: str):
    """The world with every f32 leaf rounded to the control's precision
    (bf16: the float state stored in bfloat16)."""
    import torch
    if control != "bf16":
        raise ValueError(f"no control {control!r}")
    lv = ref.transfer.world_leaves(world)
    return ref.transfer.world_from_leaves({
        k: (t.to(torch.bfloat16).to(torch.float32)
            if t.dtype == torch.float32 else t) for k, t in lv.items()})


def reference(cell, cfgj, roll, seed, dev, sample, rollout, ticks, B,
              control=None):
    """The reference's start worlds (those `roll.start_worlds` gives the
    program's) and its end state of rollout `rollout` after `ticks`
    ticks, for the sampled worlds, one world at a time (`sim.run_chunk`
    in chunks of the cell's), with its Config's values first: (start,
    end)."""
    ref = Pkg(REFERENCE)
    t0 = time.perf_counter()
    cfg, start = build(ref, cfgj, seed, dev, sample=roll.sample(sample))
    print(f"reference: set-up {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    starts = roll.ref_starts(ref, start)
    if control is not None:
        starts = [lower(ref, w, control) for w in starts]
    want_start = [leaves(ref, w) for w in starts]
    C = int(cell["chunk"])
    want = []
    for w in roll.ref_rollout(ref, starts,
                              rollout_keys(seed, rollout, B)[sample]):
        for _ in range(ticks // C):
            w = ref.sim.run_chunk(cfg, w, C)
            if control is not None:
                w = lower(ref, w, control)
        want.append(leaves(ref, w))
    return (config_values(cfg), want_start), want


def diff(got: dict, want: dict) -> tuple:
    """(integer elements that differ, the widest relative f32 gap)."""
    n, gap = 0, 0.0
    for k in sorted(set(got) | set(want)):
        g, w = got.get(k), want.get(k)
        if g is None or w is None:
            n += (g if w is None else w).size
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            n += max(g.size, w.size)
            continue
        if w.dtype == np.float32:
            d = np.abs(g.astype(np.float64) - w.astype(np.float64))
            nan = np.isnan(g) != np.isnan(w)
            if nan.any():
                gap = float("inf")
                continue
            d = np.where(np.isnan(d), 0.0, d)
            top = float(np.nanmax(np.abs(w))) if w.size else 0.0
            if d.size and d.max() > 0:
                gap = max(gap, float(d.max()) / max(top, 1e-30))
        else:
            n += int((g != w).sum())
    return n, gap


def compare(start_got: list, want_start: tuple, got: list, want: list,
            prog_cfg: dict) -> dict:
    ref_cfg, want_start = want_start
    cfg_diff = sum(prog_cfg.get(k) != v for k, v in ref_cfg.items()) \
        + len(set(prog_cfg) ^ set(ref_cfg))
    s = [diff(g, w) for g, w in zip(start_got, want_start)]
    e = [diff(g, w) for g, w in zip(got, want)]
    parts = {"start_int_diff": cfg_diff + sum(x[0] for x in s),
             "start_float_gap": max(x[1] for x in s),
             "end_int_diff": sum(x[0] for x in e),
             "end_float_gap": max(x[1] for x in e)}
    return {"int_diff": parts["start_int_diff"] + parts["end_int_diff"],
            "float_gap": max(parts["start_float_gap"],
                             parts["end_float_gap"]), "parts": parts}
