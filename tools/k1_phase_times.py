#!/usr/bin/env python3
"""Where K1's (or K7's) time goes inside its one launch, on one GPU.

Builds `trafficsimulation_tpu_torch/csrc/decide_move.cu` with
`-DTSIM_K1_MARKS` (thread 0 of block 0 reads the global timer once its
block has finished each pass of each phase; the last block to finish
records the end) into `trafficsimulation_tpu_torch/_build/k1_marks/`,
runs K1 through `hopper_engine.decide_move_batched` on seeded worlds of
256 x 256 cells (one world and a batch of 16; a tenth of the cells
holding a vehicle that can move, or half of them holding random words),
and prints the median timeline of 5 calls in microseconds: the decide's
two passes (every cell; the vehicles) and its barrier, per sub-round the
intent's and the commit's two passes and barriers, and the finish.
The barrier lines are block 0's wait for the slowest block.  With
`--k7`, the same for K7 (`csrc/decide_tiled.cu` with `-DTSIM_K7_MARKS`,
`hopper_engine.decide_move_tiled`) on one of those worlds at tiles of
64 x 64 and 16 x 32: block 0 owns the top-left window, its timeline
starts with the window's copy, and its barriers are block barriers.
Run from the repository root on a machine with a CUDA card:

    python3 tools/k1_phase_times.py [--k7] [--out DIR]

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MARKS = 64
END_BLOCK0, END_ALL = 40, 41
START_K7 = 42            # K7's block 0 before its window copy


def build_marked(kernel: str, source: str, entry: str):
    """`entry` of csrc/`source` built with -DTSIM_<KERNEL>_MARKS (ctypes),
    and its marks reader `tsim_<kernel>_marks`."""
    from trafficsimulation_tpu_torch.ops import build
    out = build.BUILD_DIR / f"{kernel}_marks"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{kernel}_marks.so"
    res = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, f"-DTSIM_{kernel.upper()}_MARKS",
         "-I", str(build.CSRC), "-shared", "-o", str(so),
         str(build.CSRC / source)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, entry)
    fn.argtypes = build._ARGTYPES[entry]
    fn.restype = ctypes.c_int
    read = getattr(lib, f"tsim_{kernel}_marks")
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    return fn, read


def worlds(g, B, H, W, D, moving):
    """K1's arguments for B worlds: `moving`, a tenth of the cells hold a
    vehicle without faults, stuck count or allowance (most move); else
    every plane is random words (half the cells hold a vehicle, most of
    them stranded or blocked)."""
    from trafficsimulation_tpu_torch.ops import engine

    def rint(lo, hi, *s):
        return torch.randint(lo, hi, s, generator=g, device="cuda",
                             dtype=torch.int64).to(torch.int32)

    def bern(p, *s):
        return torch.rand(s, generator=g, device="cuda") < p
    nd = rint(0, 256, B, D, H, W)
    if moving:
        nd &= torch.where(bern(0.8, B, D, H, W), 0xF7, 0xFF).to(torch.int32)
    sdir4 = torch.stack([engine.pack_sdir4(x.to(torch.uint8)) for x in nd])
    del nd
    wb = rint(0, 16, B, 4, H, W)
    wnd = wb[:, 0] | (wb[:, 1] << 8) | (wb[:, 2] << 16) | (wb[:, 3] << 24)
    planes = [rint(-2**31, 2**31, B, H, W) for _ in range(5)] + [
        torch.rand((B, H, W), generator=g, device="cuda")]
    if moving:
        planes[0] = (planes[0] & ((1 << 14) - 2)) | bern(0.1, B, H, W) | \
            (rint(0, D, B, H, W) << 18)
        planes[1] &= 0x00FFF000
    masks = (bern(0.02 if moving else 0.15, B, H, W), bern(0.1, B, H, W),
             bern(0.02, B, H, W))
    randoms = (torch.rand((B, H, W), generator=g, device="cuda"),
               torch.rand((B, H, W), generator=g, device="cuda"),
               rint(1, 6, B, H, W), rint(-2**31, 2**31, B, H, W))
    return (sdir4, wnd, tuple(planes), masks, bern(0.1, H, W),
            rint(-1, D, H, W), randoms)


def timeline(marks, K, start=0):
    """[(phase, us)] from one call's marks (K7's from its window copy,
    mark `start`)."""
    t = [m / 1e3 for m in marks]
    rows = [("window copy", t[0] - t[start])] if start else []
    rows += [("decide, every cell", t[1] - t[0]),
            ("decide, vehicles", t[2] - t[1]),
            ("decide barrier", t[3] - t[2])]
    for r in range(K):
        a = 4 + 6 * r
        prev = t[3] if r == 0 else t[a - 1]
        rows += [(f"sub-round {r}: intent, every cell", t[a] - prev),
                 (f"sub-round {r}: intent, listed", t[a + 1] - t[a]),
                 (f"sub-round {r}: intent barrier", t[a + 2] - t[a + 1]),
                 (f"sub-round {r}: commit, every cell", t[a + 3] - t[a + 2]),
                 (f"sub-round {r}: commit, listed", t[a + 4] - t[a + 3]),
                 (f"sub-round {r}: commit barrier", t[a + 5] - t[a + 4])]
    rows += [("finish, block 0", t[END_BLOCK0] - t[3 + 6 * K]),
             ("finish, the last block after block 0",
              t[END_ALL] - t[END_BLOCK0]),
             ("total", t[END_ALL] - t[start])]
    return rows


def median_timeline(call, read, K, start=0):
    """The median timeline of 5 calls after one warm-up."""
    marks = (ctypes.c_ulonglong * N_MARKS)()
    runs = []
    for _ in range(6):
        call()
        torch.cuda.synchronize()
        if read(marks):
            raise RuntimeError("reading the marks failed")
        runs.append(timeline(list(marks), K, start))
    return [(name, statistics.median(r[i][1] for r in runs[1:]))
            for i, (name, _) in enumerate(runs[0])]


def k1_runs(HE, cfg, g, K):
    fn, read = build_marked("k1", "decide_move.cu", "tsim_decide_move")
    HE._entries["tsim_decide_move"] = fn
    try:
        for moving in (True, False):
            for B in (1, 16):
                a = worlds(g, B, 256, 256, 64, moving)
                label = (f"B = {B}, {'a tenth moving' if moving else 'random'}"
                         f", K = {K}")
                yield label, median_timeline(
                    lambda: HE.decide_move_batched(cfg, a[0], a[1], a[2],
                                                   *a[3], a[4], a[5], a[6]),
                    read, K)
    finally:
        HE._entries.pop("tsim_decide_move", None)


def k7_runs(HE, cfg, g, K):
    fn, read = build_marked("k7", "decide_tiled.cu", "tsim_decide_tiled")
    HE._entries["tsim_decide_tiled"] = fn
    try:
        for moving in (True, False):
            sdir4, wnd, planes, masks, inter, dest, randoms = worlds(
                g, 1, 256, 256, 64, moving)
            a = (sdir4[0], wnd[0], tuple(p[0] for p in planes),
                 *(m[0] for m in masks), inter, dest,
                 tuple(r[0] for r in randoms))
            for th, tw in ((64, 64), (16, 32)):
                kind = "a tenth moving" if moving else "random"
                label = f"tiles {th}x{tw}, {kind}, K = {K}"
                yield label, median_timeline(
                    lambda: HE.decide_move_tiled(cfg, *a, th, tw), read, K,
                    start=START_K7)
    finally:
        HE._entries.pop("tsim_decide_tiled", None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the JSON timelines")
    ap.add_argument("--k7", action="store_true",
                    help="K7 (the halo-tiled decide + move) in place of K1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_phase_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from trafficsimulation_tpu_torch.config import Config
    from trafficsimulation_tpu_torch.ops import hopper_engine as HE
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(1)
    K = 5
    cfg = Config(WIDTH=256, HEIGHT=256, VEHICLE_MAX_SPEED=K,
                 VEHICLE_MALFUNCTION_CHANCE=0.01,
                 VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    report = {"card": card}
    if args.k7:
        name, runs = "K7", k7_runs(HE, cfg, g, K)
    else:
        name, runs = "K1", k1_runs(HE, cfg, g, K)
    for label, med in runs:
        report[label] = dict(med)
        print(f"{name} phases ({card}), {label}, median of 5 (us):")
        for phase, us in med:
            print(f"  {phase:42s} {us:8.2f}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{name.lower()}_phase_times.json"),
                  "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
