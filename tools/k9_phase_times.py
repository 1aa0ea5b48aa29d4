#!/usr/bin/env python3
"""Where K9's time goes inside its one cooperative launch, on one GPU.

Builds `trafficsimulation_tpu_torch/csrc/megakernel.cu` with
`-DTSIM_K9_MARKS` (thread 0 of block 0 appends a stage code and the
global timer once its block has finished each stage or passed each grid
barrier; the last block to finish records the end) into
`trafficsimulation_tpu_torch/_build/k9_marks/`, runs K9 through
`hopper_engine.mega_segment` on the headline's reference segment (the
shipped headline world, its key stack rebuilt on the card, the 5 ticks
from tick 0 as `run_chunk` launches them on the megakernel path), and
prints the median of 5 calls in microseconds: each stage and each
barrier summed over the segment and divided by its ticks, the grid
barriers a tick, and the whole launch.  A barrier line is block 0's wait
for the slowest block.  Run from the repository root on a machine with a
CUDA card:

    python3 tools/k9_phase_times.py [--out DIR]

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
    for name in ("tsim_mega_segment", "tsim_mega_grid"):
        fn = getattr(lib, name)
        fn.argtypes = build._ARGTYPES[name]
        fn.restype = ctypes.c_int
    lib.tsim_k9_marks.argtypes = [ctypes.c_void_p] * 3
    lib.tsim_k9_marks.restype = ctypes.c_int
    return lib, res.stdout + res.stderr


def reference_segment(R: int):
    """(cfg, K9's inputs) of the headline's first segment of R ticks."""
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
    return cfg, args


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
    out["grid barriers a tick"] = (n_bar - n_pro) / R
    out["grid barriers a segment"] = n_bar
    out["total (us a segment)"] = sum(us for _, us in rows)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the JSON timeline")
    ap.add_argument("--ticks", type=int, default=5,
                    help="ticks of the segment (default 5)")
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
    cfg, a = reference_segment(args.ticks)
    codes = (ctypes.c_int * MAX_MARKS)()
    times = (ctypes.c_ulonglong * MAX_MARKS)()
    end = ctypes.c_ulonglong(0)
    saved = {k: HE._entries.get(k) for k in ("tsim_mega_segment",
                                             "tsim_mega_grid")}
    HE._entries["tsim_mega_segment"] = lib.tsim_mega_segment
    HE._entries["tsim_mega_grid"] = lib.tsim_mega_grid
    getattr(HE, "_mega_cache", {}).clear()
    runs, seq = [], None
    try:
        for _ in range(6):
            HE.mega_segment(cfg, a)
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
        getattr(HE, "_mega_cache", {}).clear()
    med = [(label, statistics.median(r[i][1] for r in runs[1:]))
           for i, (label, _) in enumerate(runs[0])]
    summ = summary(med, args.ticks, seq)
    print(f"K9 stages ({card}), the headline's first segment, "
          f"R = {args.ticks}, median of 5 (us a tick):")
    for label, us in summ.items():
        print(f"  {label:44s} {us:10.2f}")
    print(f"ptxas (mega_kernel): {sass_count.ptxas_info(log, 'mega_kernel')}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "k9_phase_times.json"), "w") as f:
            json.dump({"card": card, "ticks": args.ticks,
                       "summary": summ, "timeline": med,
                       "ptxas": log}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
