#!/usr/bin/env python3
"""Where the PyTorch port's headline tick spends its time, on one GPU.

Loads the headline snapshot (BASELINE config #2: 256x256, 10k vehicles,
D = 608), rebuilds the key stack on the card, warms up with one chunk,
then profiles `run_chunk` over N ticks with `torch.profiler` (CPU and
CUDA activities).  Prints the wall time per tick, the summed device
kernel time per tick, the device idle share, and the top entries of
`key_averages()` by device time.  Run from the repository root:

    python3 tools/profile_torch_tick.py [--ticks 25] [--out DIR]

With --out the full table and a chrome trace go to DIR.  Needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=25)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_tick: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from trafficsimulation_tpu_torch import sim, snapshot

    cfg, world, _ = snapshot.load_snapshot(snapshot.HEADLINE, "cuda")
    world = snapshot.build_field(cfg, world)
    world = sim.run_chunk(cfg, world, 10)          # warm-up, kernel build
    torch.cuda.synchronize()

    n = args.ticks
    t0 = time.perf_counter()
    world = sim.run_chunk(cfg, world, n)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        world = sim.run_chunk(cfg, world, n)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # device time = the kernels and copies themselves (the aten ops that
    # launched them carry the same time again)
    dev = sum(e.self_device_time_total for e in ka
              if e.device_type == DeviceType.CUDA) / 1e6 / n
    syncs = sum(e.count for e in ka if e.key == "aten::_local_scalar_dense")
    launches = sum(e.count for e in ka if e.device_type == DeviceType.CUDA)
    print(f"{n} ticks: wall {wall * 1e3:.3f} ms/tick (no profiler), device "
          f"busy {dev * 1e3:.3f} ms/tick, device idle share "
          f"{1 - dev / wall:.3f}; per tick {launches / n:.0f} device "
          f"kernels/copies, {syncs / n:.1f} host syncs")
    table = ka.table(sort_by="self_device_time_total", row_limit=30)
    print(table)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_table.txt"), "w") as f:
            f.write(ka.table(sort_by="self_device_time_total", row_limit=200))
            f.write("\n")
            f.write(ka.table(sort_by="self_cpu_time_total", row_limit=60))
        prof.export_chrome_trace(os.path.join(args.out, "profile_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
