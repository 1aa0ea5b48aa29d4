#!/usr/bin/env python3
"""Count the host part of the megakernel path's routing segment by stage,
on the CPU, without a card.

Runs `run_chunk` over 50 ticks (10 segments) of a small world (64x64,
the megakernel tests' high-demand world) on the megakernel branch
(TSIM_MEGA_INTERPRET), and counts the aten ops each stage dispatches
under a `TorchDispatchMode`: on the card each such op is about one
kernel launch (views and scalar wrappers excluded), and each kernel
wrapper (K2, K3, K9, `rain_ticks`) counts as one launch, not as its
plain version's ops.  Prints the ops per segment by stage and the most
frequent ops of each.  The card's own count comes from
`tools/profile_torch_tick.py --mega`; this one needs no card, so a
change to the host part can be weighed before a chip run:

    python tools/count_segment_ops.py

With `--pedestrians` it counts the per-tick path of the same world with
pedestrians on instead (20 ticks), and the ops of the pedestrian step's
plain version apart from the rest: on the card the step is one
`step_pedestrians` launch and the sidewalk count's reduction.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TICKS = 50
# ops that launch nothing on the card
NO_LAUNCH = {
    "scalar_tensor", "view", "_unsafe_view", "expand", "slice", "select",
    "t", "transpose", "permute", "unsqueeze", "squeeze", "alias", "detach",
    "as_strided", "lift_fresh", "empty", "empty_like", "empty_strided",
    "unbind", "split", "split_with_sizes", "_reshape_alias", "reshape",
    "_local_scalar_dense", "unfold", "diagonal", "chunk", "narrow",
    "new_empty"}
KERNEL = "kernel"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pedestrians", action="store_true",
                    help="the per-tick path with pedestrians on")
    peds = ap.parse_args().pedestrians
    sys.path.insert(0, ROOT)
    os.environ.pop("TSIM_NO_MEGAKERNEL", None)
    if not peds:
        os.environ["TSIM_MEGA_INTERPRET"] = "1"
    from trafficsimulation_tpu_torch import prng, sim
    from trafficsimulation_tpu_torch.agents import pedestrians
    from trafficsimulation_tpu_torch.config import Config
    from trafficsimulation_tpu_torch.ops import engine, megakernel
    from trafficsimulation_tpu_torch.ops import hopper_engine as HE

    stage = ["outside the stages"]
    counts = collections.Counter()
    by_op = collections.defaultdict(collections.Counter)

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name not in NO_LAUNCH and stage[0] != KERNEL:
                counts[stage[0]] += 1
                by_op[stage[0]][name] += 1
            return func(*args, **(kwargs or {}))

    def tag(mod, fn, label):
        orig = getattr(mod, fn, None)
        if orig is None:        # an older tree without this function
            return

        def run(*a, **k):
            prev, stage[0] = stage[0], label
            try:
                if label == KERNEL:
                    counts[prev] += 1
                    by_op[prev][fn] += 1
                return orig(*a, **k)
            finally:
                stage[0] = prev
        setattr(mod, fn, run)

    for fn in ("build_sdir", "build_wavefront", "rain_ticks", "mega_segment"):
        tag(HE, fn, KERNEL)
    tag(engine, "routing_planes", "routing planes")
    tag(megakernel, "prepare_segment", "segment schedule")
    tag(megakernel, "step_rain_ticks", "of which rain")
    tag(megakernel, "segment_inputs", "segment inputs")
    tag(megakernel, "segment_state", "segment state")
    tag(megakernel, "fold_metrics", "of which metrics fold")
    tag(megakernel, "build_chunk_static", "chunk entry and exit")
    tag(sim, "_enter_engine", "chunk entry and exit")
    tag(sim, "_exit_engine", "chunk entry and exit")
    tag(pedestrians, "step_pedestrians_plain",
        "pedestrian step (plain version)")

    torch.set_num_threads(2)
    cfg = Config(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
                 MAX_FIELD_DESTS=32, MAX_VEHICLES=256,
                 INTERNAL_POPULATION_TRAFFIC_PER_DAY=60000,
                 PASSING_POPULATION_TRAFFIC_PER_DAY=20000,
                 RAIN_SPAWN_CHANCE=0.2, PEDESTRIANS_ENABLED=peds,
                 PEDESTRIANS_PER_DAY=200_000)
    world = sim.init_world(cfg, prng.PRNGKey(3), "cpu")
    cfg, world = sim.measure_and_shrink(cfg, world)
    world = sim.inject_vehicles(cfg, world, 120)
    n_ticks = 20 if peds else N_TICKS
    segs = n_ticks // cfg.PATHFINDING_COOLDOWN
    with Count():
        sim.run_chunk(cfg, world, n_ticks)
    if peds:
        total = sum(counts.values())
        plain = counts["pedestrian step (plain version)"]
        print(f"ops per tick ({n_ticks} ticks, pedestrians on): "
              f"{total / n_ticks:.1f}, of which the pedestrian step's "
              f"plain version {plain / n_ticks:.1f}; most frequent: "
              f"{by_op['pedestrian step (plain version)'].most_common(6)}")
        return 0
    # a nested stage's ops count in it, not in the stage around it
    outer = {"of which rain": "segment schedule",
             "of which metrics fold": "segment state"}
    total = sum(counts.values())
    print(f"ops per segment ({n_ticks} ticks, {segs} segments): "
          f"{total / segs:.1f}")
    for name, n in counts.most_common():
        rest = " (the rest)" if name in outer.values() else ""
        print(f"  {name}{rest}: {n / segs:.1f}; most frequent: "
              f"{by_op[name].most_common(6)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
