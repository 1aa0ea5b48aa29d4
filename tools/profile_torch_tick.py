#!/usr/bin/env python3
"""Where the PyTorch port's tick spends its time, on one GPU.

Loads the headline snapshot (BASELINE config #2: 256x256, 10k vehicles,
D = 608), rebuilds the key stack on the card, warms up with one chunk,
then profiles `run_chunk` over N ticks with `torch.profiler` (CPU and
CUDA activities).  Prints the wall time per tick, the summed device
kernel time per tick, the device idle share, the host and device time
per tick of each layer (routing segment, lights, decide + move: K1, or
K1-hier under hierarchical routing, post-move: each layer's entry
function runs inside a profiler range), and the top entries of
`key_averages()` by device time.  With --batch B it profiles the
shared-geometry batch of B rollouts of the same city instead
(`parallel.mesh.run_batch_shared`; keys from a fixed seed); with
--config5 BASELINE config #5 (1024x1024, 100k vehicles, hierarchical
routing), built on the card from seed 0 (about 70 s); with --mega the
headline on the megakernel path (TSIM_MEGA_FORCE=1: one K9 launch per
routing segment; its layers are the segment schedule, the K9 call and
the state rebuilt after it).  Run from the repository root:

    python3 tools/profile_torch_tick.py [--ticks 25]
                                        [--batch B | --config5 | --mega]
                                        [--out DIR] [--trace]

With --out the full table goes to DIR, and with --trace also a chrome
trace (40-65 MB for 25 ticks).  Needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG5 = dict(WIDTH=1024, HEIGHT=1024, MAX_VEHICLES=100_000,
               ROUTING_HIER=True, INTERNAL_POPULATION_TRAFFIC_PER_DAY=100_000,
               PASSING_POPULATION_TRAFFIC_PER_DAY=20_000)


class _Op(torch.autograd.Function):
    """fn(*args) as an op: torch.profiler links a kernel to the layer
    whose range ran it through the op that launched it, and the lean
    wrappers of K1, K3, K4, K9, the ordered add and `rain_ticks`, and K5
    from the vmap rule of `build_sdir`, launch through ctypes outside
    any op."""

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


def annotate_layers() -> list:
    """Run each layer's entry functions inside a `torch.profiler` range
    named after the layer (the modules look them up at call time), and
    return the names."""
    from torch.profiler import record_function
    from trafficsimulation_tpu_torch import sim
    from trafficsimulation_tpu_torch.lights import fsm
    from trafficsimulation_tpu_torch.ops import engine, megakernel
    from trafficsimulation_tpu_torch.ops import hopper_engine as HE
    layers = {
        "routing segment": [(engine, "routing_planes")],
        "lights": [(fsm, f) for f in (
            "group_reductions", "run_controllers", "execute_phase_change",
            "apply_light_overrides", "build_stop_map")],
        "decide + move": [(HE, "decide_move")],
        "post-move": [(engine, "_post_move")],
        "segment schedule (mega)": [(megakernel, "prepare_segment")],
        "of which rain (mega)": [(megakernel, "step_rain_ticks")],
        "segment kernel (K9)": [(HE, "mega_segment")],
        "segment state (mega)": [(megakernel, "segment_state")],
        "of which metrics fold (mega)": [(megakernel, "fold_metrics")],
        "chunk entry and exit": [(sim, "_enter_engine"), (sim, "_exit_engine"),
                                 (megakernel, "build_chunk_static")]}
    for label, targets in layers.items():
        for mod, name in targets:
            def span(*a, _fn=getattr(mod, name), _label=label, **k):
                with record_function(_label):
                    return _fn(*a, **k)
            setattr(mod, name, span)
    for name in ("_prefix_launch", "_dm_launch", "ordered_add_rows",
                 "_rain_single", "build_sdir_batched", "_wavefront_launch",
                 "_mega_launch"):
        setattr(HE, name, lambda *a, _fn=getattr(HE, name): _Op.apply(_fn,
                                                                     *a))
    return list(layers)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=25)
    ap.add_argument("--batch", type=int, default=0,
                    help="profile a shared-geometry batch of this size")
    ap.add_argument("--config5", action="store_true",
                    help="profile BASELINE config #5 (1024^2, hier routing)")
    ap.add_argument("--mega", action="store_true",
                    help="profile the headline on the megakernel path")
    ap.add_argument("--trace", action="store_true",
                    help="also write a chrome trace to --out")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_tick: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import numpy as np
    from trafficsimulation_tpu_torch import prng, sim, snapshot
    from trafficsimulation_tpu_torch.config import Config
    from trafficsimulation_tpu_torch.parallel import mesh

    layers = annotate_layers()
    if args.mega:
        os.environ.pop("TSIM_NO_MEGAKERNEL", None)
        os.environ["TSIM_MEGA_FORCE"] = "1"
    if args.config5:
        cfg, world = sim.init_world_hier(Config(**CONFIG5), prng.PRNGKey(0))
        world = sim.inject_vehicles(cfg, world, CONFIG5["MAX_VEHICLES"])
    else:
        cfg, world, _ = snapshot.load_snapshot(snapshot.HEADLINE, "cuda")
        world = snapshot.build_field(cfg, world)
    run = sim.run_chunk
    if args.batch:
        keys = prng.split(np.array([0, 2026], np.uint32), args.batch)
        world = mesh.tile_dynamic(world, keys)
        run = mesh.run_batch_shared
    world = run(cfg, world, 10)          # warm-up, kernel build
    torch.cuda.synchronize()

    n = args.ticks
    t0 = time.perf_counter()
    world = run(cfg, world, n)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        world = run(cfg, world, n)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # device time = the kernels and copies themselves (the aten ops that
    # launched them carry the same time again; the layers' ranges also
    # show on the device as annotations)
    kern = [e for e in ka if e.device_type == DeviceType.CUDA
            and e.key not in layers]
    dev = sum(e.self_device_time_total for e in kern) / 1e6 / n
    syncs = sum(e.count for e in ka if e.key == "aten::_local_scalar_dense")
    launches = sum(e.count for e in kern)
    what = ("config #5" if args.config5 else "megakernel path, batch 1"
            if args.mega else f"batch {max(args.batch, 1)}")
    print(f"{what}, {n} ticks: wall {wall * 1e3:.3f} "
          f"ms/tick (no profiler), device "
          f"busy {dev * 1e3:.3f} ms/tick, device idle share "
          f"{1 - dev / wall:.3f}; per tick {launches / n:.0f} device "
          f"kernels/copies, {syncs / n:.1f} host syncs")
    # device launches of each layer: the kernels and copies of every op
    # that ran inside its ranges
    def kernels(e):
        return len(e.kernels) + sum(kernels(c) for c in e.cpu_children)
    per_layer = dict.fromkeys(layers, 0)
    for e in prof.events():
        if e.name in per_layer and e.device_type == DeviceType.CPU:
            per_layer[e.name] += kernels(e)
    print("layer: host ms/tick (under the profiler), device ms/tick, "
          "calls/tick, device kernels/copies per tick")
    for e in ka:
        if e.key in layers and e.device_type == DeviceType.CPU:
            print(f"  {e.key}: {e.cpu_time_total / 1e3 / n:.3f}, "
                  f"{e.device_time_total / 1e3 / n:.3f}, {e.count / n:g}, "
                  f"{per_layer[e.key] / n:.1f}")
    table = ka.table(sort_by="self_device_time_total", row_limit=30)
    print(table)
    if args.out:
        tag = ("_config5" if args.config5 else "_mega" if args.mega
               else f"_b{args.batch}" if args.batch else "")
        os.makedirs(args.out, exist_ok=True)
        table_path = os.path.join(args.out, f"profile_table{tag}.txt")
        with open(table_path, "w") as f:
            f.write(ka.table(sort_by="self_device_time_total", row_limit=200))
            f.write("\n")
            f.write(ka.table(sort_by="self_cpu_time_total", row_limit=60))
        if args.trace:
            prof.export_chrome_trace(os.path.join(
                args.out, f"profile_trace{tag}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
