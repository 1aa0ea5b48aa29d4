#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--out DIR]

Phases (any failure raises and the script exits nonzero):

  1. the card's name and power limit, torch / CUDA versions, and the
     build of the port's CUDA kernels from `trafficsimulation_tpu_torch/
     csrc/` (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the card, at the
     headline's shapes (256x256, D = 608 destination rows), on seeded
     random inputs: outputs must be bit-equal; median times of both;
  3. the headline world (BASELINE config #2, 10k vehicles) from the
     shipped snapshot: the key stack is rebuilt on the card and must
     hash to the JAX package's sha256, then `TrafficSim.step(23)` must
     reproduce the JAX end state stored in the snapshot (integer leaves
     exactly, f32 leaves within rtol 1e-6), and every kernel must have
     launched on that path;
  4. throughput: one `step(200)`, steps/s and cell-updates/s.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.  With `--out DIR` the nvcc log and the
full report are written there too.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_REF_TICKS = 23
N_BENCH_TICKS = 200
REPORT = {}

KERNELS = {
    # name: (source, TPU kernel it replaces: file:line of its pallas_call)
    "decide_move": ("trafficsimulation_tpu_torch/csrc/decide_move.cu",
                    "trafficsimulation_tpu/ops/pallas_engine.py:1026"),
    "build_sdir": ("trafficsimulation_tpu_torch/csrc/sdir.cu",
                   "trafficsimulation_tpu/ops/pallas_engine.py:844"),
    "build_wavefront": ("trafficsimulation_tpu_torch/csrc/wavefront.cu",
                        "trafficsimulation_tpu/ops/pallas_engine.py:466"),
    "prefix_planes": ("trafficsimulation_tpu_torch/csrc/prefix.cu",
                      "trafficsimulation_tpu/ops/pallas_engine.py:520"),
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype.is_floating_point:
        return float((a.double() - b.double()).abs().max())
    return float((a.long() - b.long()).abs().max())


def compare(name, got, ref):
    """Bit-equality of two output tuples; returns the max abs error."""
    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        gi = g.view(torch.int32) if g.dtype == torch.float32 else g
        ri = r.view(torch.int32) if r.dtype == torch.float32 else r
        if not torch.equal(gi, ri):
            n = int((gi != ri).sum())
            raise AssertionError(f"{name}: output {i} differs from the "
                                 f"plain version in {n} entries")
        err = max(err, max_abs_err(g, r))
    return err


def phase_kernels(cfg, HE, engine):
    """Each kernel vs its plain version at the headline shapes."""
    dev = torch.device("cuda")
    H, W, D = cfg.HEIGHT, cfg.WIDTH, cfg.MAX_FIELD_DESTS
    g = torch.Generator(device=dev).manual_seed(0)

    def bits(*shape):
        return torch.randint(-2**31, 2**31, shape, generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def unif(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def bern(p, *shape):
        return torch.rand(shape, generator=g, device=dev) < p

    def rint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    results = {}
    # K1: dense random planes, every fault flag present, fault rolls that
    # fire often, random sdir bytes and wavefront bytes
    kcfg = cfg.replace(VEHICLE_MALFUNCTION_CHANCE=0.01,
                       VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    sd = rint(0, 256, D, H, W).to(torch.uint8)
    sdir4 = engine.pack_sdir4(sd)
    wb = rint(0, 16, 4, H, W)
    wnd = wb[0] | (wb[1] << 8) | (wb[2] << 16) | (wb[3] << 24)
    planes = tuple(bits(H, W) for _ in range(5)) + (unif(H, W),)
    masks = (bern(0.15, H, W), bern(0.1, H, W), bern(0.02, H, W),
             bern(0.1, H, W))
    dest = rint(-1, D, H, W)
    randoms = (unif(H, W), unif(H, W), rint(1, 6, H, W), bits(H, W))

    def k1():
        return HE.decide_move(kcfg, sdir4, wnd, planes, *masks, dest,
                              randoms)

    def p1():
        return HE.decide_move_core(kcfg, sdir4, wnd, *planes, *masks, dest,
                                   *randoms)
    results["decide_move"] = (k1, p1)

    # K2: key stack with unreachable (KBIG) rows and hard-blocked (2^17)
    # pens
    q = rint(0, 60000, D, 4, H, W)
    q = torch.where(bern(0.15, D, 4, H, W), 65535, q)
    K0 = engine.costs_u16_to_keys(q)
    del q
    pen4 = torch.where(bern(0.1, 4, H, W), 1 << 17, rint(0, 3000, 4, H, W))
    legal4 = bern(0.6, 4, H, W).to(torch.int32)
    tp2 = int(round(2 * cfg.VEHICLE_TURN_PENALTY))
    results["build_sdir"] = (lambda: (HE.build_sdir(K0, pen4, legal4, tp2),),
                             lambda: (HE.sdir_encode(K0, pen4, legal4, tp2),))

    # K3: random geometry
    allowed = rint(0, 16, H, W).to(torch.uint8)
    road = bern(0.5, H, W)
    hard = bern(0.1, H, W) & road
    results["build_wavefront"] = (
        lambda: (HE.build_wavefront(cfg, allowed, road, hard),),
        lambda: (HE.wavefront_core(cfg, allowed, road, hard),))

    # K4: random occupancy
    occ = bern(0.3, H, W).to(torch.int32)
    results["prefix_planes"] = (lambda: HE.prefix_planes(occ),
                                lambda: HE.prefix_planes_plain(occ))

    out = {}
    for name, (kern, plain) in results.items():
        err = compare(name, kern(), plain())
        torch.cuda.synchronize()
        ms = median_ms(kern)
        plain_ms = median_ms(plain, reps=5 if name == "build_sdir" else 20)
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        log(f"kernel {name}: bit-equal to plain; median {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
    return out


FLOAT_RTOL = 1e-6


def phase_headline(HE, snapshot, tsim, transfer):
    """Rebuild the key stack, run 23 ticks, hold them against JAX."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, world, ref = snapshot.load_snapshot(snapshot.HEADLINE, dev)
    log(f"snapshot: D={cfg.MAX_FIELD_DESTS} V="
        f"{int(world.vehicles.active.sum())} active "
        f"({time.perf_counter() - t0:.1f} s)")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    world = snapshot.build_field(cfg, world)
    torch.cuda.synchronize()
    t_field = time.perf_counter() - t0
    sha = snapshot.field_sha256(world.cost_field)
    log(f"key stack {tuple(world.cost_field.shape)} rebuilt on the card in "
        f"{t_field:.2f} s; sha256 {sha}")
    if sha != ref["field_sha256"]:
        rows = snapshot.field_row_sums(world.cost_field)
        bad = np.nonzero(rows != ref["field_row_sums"])[0]
        raise AssertionError(f"key stack sha256 differs from JAX's "
                             f"({ref['field_sha256']}); rows differing: "
                             f"{bad[:20].tolist()} ({len(bad)} in all)")
    REPORT["field_build_s"] = t_field

    sim = tsim.TrafficSim.from_world(cfg, world)
    HE.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(N_REF_TICKS)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    launches = dict(HE.launches)
    log(f"step({N_REF_TICKS}) in {t_ref:.2f} s; kernel launches {launches}")

    got = transfer.world_to_numpy(sim.world)
    bad = []
    for k, a in ref["end"].items():
        b = got[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append((k, "shape/dtype", a.shape, b.shape))
        elif np.issubdtype(a.dtype, np.floating):
            if not np.allclose(a, b, rtol=FLOAT_RTOL, atol=0.0):
                bad.append((k, int((a != b).sum())))
        elif not np.array_equal(a, b):
            bad.append((k, int((a != b).sum())))
    if bad:
        raise AssertionError(f"end state differs from JAX (leaf, entries): "
                             f"{bad}")
    n_exact = sum(1 for a in ref["end"].values()
                  if not np.issubdtype(a.dtype, np.floating))
    log(f"end state after {N_REF_TICKS} ticks equals JAX's: {n_exact} "
        f"integer/bool leaves exact, {len(ref['end']) - n_exact} f32 leaves "
        f"within rtol {FLOAT_RTOL}")
    st = sim.stats()
    log("stats: " + json.dumps({k: st[k] for k in (
        "tick", "live_internal", "created_internal", "created_through",
        "completed_internal", "completed_through", "stuck", "raining")}))
    need = {"decide_move": N_REF_TICKS, "prefix_planes": N_REF_TICKS,
            "build_sdir": 5, "build_wavefront": 5}
    for k, n in need.items():
        if launches[k] < n:
            raise AssertionError(f"kernel {k} launched {launches[k]} times "
                                 f"on the main path, expected >= {n}")
    return cfg, sim, launches


def phase_throughput(cfg, sim, card):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(N_BENCH_TICKS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sps = N_BENCH_TICKS / dt
    cups = cfg.HEIGHT * cfg.WIDTH * sps
    log(f"throughput ({card}): {N_BENCH_TICKS} ticks in {dt:.3f} s = "
        f"{sps:.2f} steps/s = {cups:.4g} cell-updates/s")
    REPORT["throughput"] = {"ticks": N_BENCH_TICKS, "seconds": dt,
                            "steps_per_s": sps, "cell_updates_per_s": cups,
                            "card": card}
    pa = sim.world.vehicles.active
    if not bool(pa.any()):
        raise AssertionError("no vehicle left after the throughput run")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the build log and report")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from trafficsimulation_tpu_torch import snapshot
    from trafficsimulation_tpu_torch import sim as tsim
    from trafficsimulation_tpu_torch.core import transfer
    from trafficsimulation_tpu_torch.ops import build, engine
    from trafficsimulation_tpu_torch.ops import hopper_engine as HE
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    card = card_line()
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.load()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds if build.build_seconds else 0:.1f} s)")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_nvcc.log"), "w") as f:
            f.write(build.build_log)

    cfg0 = snapshot.config_from_json(
        str(np.load(snapshot.HEADLINE)["meta.cfg_json"]))
    kern = phase_kernels(cfg0, HE, engine)
    torch.cuda.empty_cache()
    cfg, sim, launches = phase_headline(HE, snapshot, tsim, transfer)
    phase_throughput(cfg, sim, card)

    summary = {"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches[k],
         "max_abs_err": kern[k]["max_abs_err"], "ms": kern[k]["ms"],
         "plain_ms": kern[k]["plain_ms"]} for k in KERNELS]}
    if args.out:
        REPORT["kernels"] = summary["kernels"]
        REPORT["card"] = card
        with open(os.path.join(args.out, "chip_smoke_report.json"), "w") as f:
            json.dump(REPORT, f, indent=1)
    log(json.dumps(summary))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
