#!/usr/bin/env python3
"""Where K9's time goes inside its one launch, on one GPU.

Builds `trafficsimulation_tpu_torch/csrc/megakernel.cu` with
`-DTSIM_K9_MARKS` (thread 0 of block 0 appends a stage code and the
global timer once its block has finished each stage or passed each
stage barrier; the last block to finish records the end) into
`trafficsimulation_tpu_torch/_build/k9_marks/`, runs K9 on a reference
segment and prints the median of 5 calls in microseconds: each stage
and each barrier summed over the segment and divided by its ticks, the
barriers a tick, and the whole launch.  A barrier line is block 0's wait
for the slowest block (in the block-per-world form, its own block's).
The segments (`--case`):

  one      the headline's (the shipped headline world, its key stack
           rebuilt on the card, the 5 ticks from tick 0 as `run_chunk`
           launches them on the megakernel path): the cooperative form,
           one world;
  b16      the first segment of the 16 rollouts of that world (the
           world's key and 15 more) under `run_batch_shared`: the
           cooperative form over 16 worlds, block 0 in world 0;
  config4  the first segment of config #4's 1024 cities (64^2, from
           `split(PRNGKey(0), 1024)`) under `run_chunk_batch`: the
           block-per-world form, block 0 owning world 0.

Run from the repository root on a machine with a CUDA card:

    python3 tools/k9_phase_times.py [--case one|b16|config4] [--out DIR]

Needs nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

import sass_count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_MARKS = 512
# the kernel's stage codes (megakernel.cu, K9_ENTRY ...)
STAGES = ("entry", "prologue", "queue counts", "groups", "lights",
          "stop paint", "neediest-block partials", "decide", "intent",
          "commit", "finish + service", "spawn",
          "stats + stop runs cleared", "barrier", "stats fold")
BARRIER = STAGES.index("barrier")
PROLOGUE = STAGES.index("prologue")


def build_marked():
    """The marked K9 library (ctypes)."""
    from trafficsimulation_tpu_torch.ops import build
    out = build.BUILD_DIR / "k9_marks"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libk9_marks.so"
    res = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-DTSIM_K9_MARKS", "-I",
         str(build.CSRC), "-shared", "-o", str(so),
         str(build.CSRC / "megakernel.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for name in ("tsim_mega_segment", "tsim_mega_plan"):
        fn = getattr(lib, name)
        fn.argtypes = build._ARGTYPES[name]
        fn.restype = ctypes.c_int
    lib.tsim_k9_marks.argtypes = [ctypes.c_void_p] * 3
    lib.tsim_k9_marks.restype = ctypes.c_int
    return lib, res.stdout + res.stderr


def reference_segment(R: int):
    """(cfg, K9's inputs) of the headline's first segment of R ticks, and
    the world."""
    from trafficsimulation_tpu_torch import sim as tsim
    from trafficsimulation_tpu_torch import snapshot
    from trafficsimulation_tpu_torch.ops import engine, megakernel
    cfg, world, _ = snapshot.load_snapshot(snapshot.HEADLINE, "cuda")
    world = snapshot.build_field(cfg, world)
    es = tsim._enter_engine(cfg, world)
    cs = megakernel.build_chunk_static(cfg, world)
    draws, _ = engine.tick_draws(cfg, tsim._key_np(world.key), R)
    args, _ = megakernel.segment_inputs(
        cfg, world, es, cs, engine.routing_planes(cfg, world, es), R,
        torch.from_numpy(draws).cuda())
    return cfg, args, world


def batch_segment(case: str, R: int):
    """(cfg, K9's inputs, B, batched names) of the first segment of R
    ticks of a batch on the megakernel path, captured from its runner."""
    from trafficsimulation_tpu_torch import prng
    from trafficsimulation_tpu_torch.config import Config
    from trafficsimulation_tpu_torch.ops import hopper_engine as HE
    from trafficsimulation_tpu_torch.parallel import mesh
    if case == "b16":
        import numpy as np
        cfg, _, world = reference_segment(R)
        keys = np.concatenate([
            world.key.cpu().numpy().view(np.uint32)[None],
            prng.split(np.array([0, 2026], np.uint32), 15)])
        batch = mesh.tile_dynamic(world, keys)

        def run():
            mesh.run_batch_shared(cfg, batch, R)
    else:
        cfg = Config(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6,
                     SIDEWALK_RING_WIDTH=2, MAX_FIELD_DESTS=32,
                     MAX_VEHICLES=256,
                     INTERNAL_POPULATION_TRAFFIC_PER_DAY=2000,
                     PASSING_POPULATION_TRAFFIC_PER_DAY=500)
        worlds = mesh.init_world_batch(cfg, prng.PRNGKey(0), 1024)

        def run():
            mesh.run_chunk_batch(cfg, worlds, R)
    seen = []
    orig = HE.mega_segment_batched

    def spy(cfg_, a, B, batched, form=None):
        seen.append((a, B, batched))
        return orig(cfg_, a, B, batched, form)
    HE.mega_segment_batched = spy
    os.environ["TSIM_MEGA_FORCE"] = "1"
    try:
        run()
    finally:
        HE.mega_segment_batched = orig
        os.environ.pop("TSIM_MEGA_FORCE")
    a, B, batched = seen[0]
    return cfg, a, B, batched


def timeline(codes, times, end):
    """[(label, us)] of one call: each mark's time since the last, a
    barrier labelled by the stage before it; then the last block's end."""
    rows, prev = [], None
    for i in range(1, len(codes)):
        c = codes[i]
        if c == BARRIER:
            label = f"barrier after {STAGES[prev]}"
        else:
            label = STAGES[c]
            prev = c
        rows.append((label, (times[i] - times[i - 1]) / 1e3))
    rows.append(("the last block after block 0", (end - times[-1]) / 1e3))
    return rows


def summary(rows, R: int, codes):
    """{label: us a tick} summed over the segment, the barriers a tick
    (the prologue's once a segment apart), and the whole launch."""
    out = {}
    for label, us in rows:
        out[label] = out.get(label, 0.0) + us / R
    n_bar = sum(1 for c in codes if c == BARRIER)
    n_pro = sum(1 for i in range(1, len(codes)) if codes[i] == BARRIER
                and codes[i - 1] == PROLOGUE)
    out["barriers a tick"] = (n_bar - n_pro) / R
    out["barriers a segment"] = n_bar
    out["total (us a segment)"] = sum(us for _, us in rows)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the JSON timeline")
    ap.add_argument("--ticks", type=int, default=5,
                    help="ticks of the segment (default 5)")
    ap.add_argument("--case", choices=("one", "b16", "config4"),
                    default="one", help="the segment (default: one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k9_phase_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from trafficsimulation_tpu_torch.ops import hopper_engine as HE
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    lib, log = build_marked()
    if args.case == "one":
        cfg, a, _ = reference_segment(args.ticks)

        def call():
            HE.mega_segment(cfg, a)
    else:
        cfg, a, B, batched = batch_segment(args.case, args.ticks)

        def call():
            HE.mega_segment_batched(cfg, a, B, batched)
    codes = (ctypes.c_int * MAX_MARKS)()
    times = (ctypes.c_ulonglong * MAX_MARKS)()
    end = ctypes.c_ulonglong(0)
    saved = {k: HE._entries.get(k) for k in ("tsim_mega_segment",
                                             "tsim_mega_plan")}
    HE._entries["tsim_mega_segment"] = lib.tsim_mega_segment
    HE._entries["tsim_mega_plan"] = lib.tsim_mega_plan
    HE._mega_cache.clear()
    HE._mega_plans.clear()
    runs, seq = [], None
    try:
        for _ in range(6):
            call()
            torch.cuda.synchronize()
            n = lib.tsim_k9_marks(codes, times, ctypes.byref(end))
            if n < 2:
                raise RuntimeError(f"reading the marks failed ({n})")
            seq = list(codes[:n])
            rows = timeline(seq, list(times[:n]), end.value)
            runs.append(rows)
    finally:
        for k, v in saved.items():
            if v is None:
                HE._entries.pop(k, None)
            else:
                HE._entries[k] = v
        HE._mega_cache.clear()
        HE._mega_plans.clear()
    med = [(label, statistics.median(r[i][1] for r in runs[1:]))
           for i, (label, _) in enumerate(runs[0])]
    summ = summary(med, args.ticks, seq)
    kind = {"one": 0, "b16": 1, "config4": 2}[args.case]
    print(f"K9 stages ({card}), case {args.case}, R = {args.ticks}, "
          f"median of 5 (us a tick):")
    for label, us in summ.items():
        print(f"  {label:44s} {us:10.2f}")
    print(f"ptxas (mega_kernel<{kind}>): "
          f"{sass_count.ptxas_info(log, f'mega_kernelILi{kind}E')}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"k9_phase_times_{args.case}.json"),
                  "w") as f:
            json.dump({"card": card, "case": args.case,
                       "ticks": args.ticks,
                       "summary": summ, "timeline": med,
                       "ptxas": log}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
