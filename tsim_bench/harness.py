"""One run of one cell of the port's benchmark.

    python3 tsim_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root, on a machine with the cards the cell asks
for.  Everything is found by name: the cell `tsim_bench/cells/<cell>.
json` (its configuration, rollout kind, horizon, chunk, path switch and
the limits of its checks), the configuration `tsim_bench/configs/
<config>.json` (the `Config` keys and the set-up steps, each a file
`tsim_bench/steps/<step>.py`), the rollout kind `tsim_bench/rollouts/
<kind>.py` and each per-layer metric `tsim_bench/metrics/<metric>.py`
that `BENCHMARK.json` lists for the cell.

A run: set-up (imports, the kernel library's load, the worlds built from
the seed, a host copy of the sampled worlds' start state, one untimed
rollout of the horizon, the path check); the window, rollout after
rollout from the start state with each rollout's own keys, in chunks,
the host reading the batch's fleet sums at each chunk's end, until the
first chunk that ends after `--seconds`; then, with `--trace 1`, the
per-layer metrics of the traced chunks; then the check of the outputs
against the frozen reference (`check.py`).  The last line of standard
output is the result's JSON object.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

from tsim_bench import check
from tsim_bench.common import (HERE, PATH_SWITCHES, PROGRAM, REFERENCE, Pkg,
                               build, config_values, forbidden_loaded, load,
                               manifest, module, rollout_keys, sample_worlds)
from tsim_bench.devtrace import TRACED_SPAN, Profiler

CACHE = HERE / "_cache"
OUT = HERE / "_out"


class PathError(RuntimeError):
    pass


def cell_entry(name: str) -> dict:
    for w in manifest()["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def set_environment(cell: dict) -> None:
    """The cell's path switch, and every build and kernel cache of the
    program at a fixed path inside the checkout; set before the program
    is imported."""
    for k in PATH_SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(cell["path"]["env"])
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def check_path(launches: dict, path: dict) -> None:
    """The run took its cell's path: after the warm-up every counter in
    `positive` is above 0 and every one in `zero` is 0."""
    bad = [k for k in path["positive"] if launches.get(k, 0) <= 0] + \
          [k for k in path["zero"] if launches.get(k, 0) != 0]
    if bad:
        raise PathError(
            f"the warm-up took another path than the cell's: counters "
            f"{bad} wrong; ops/hopper_engine.launches = {launches}; the "
            f"cell asks {path['positive']} > 0 and {path['zero']} == 0")


class GCClock:
    """The garbage collector's passes and their seconds while open."""

    def __init__(self):
        self.n, self.s, self._t = 0, 0.0, None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.n += 1
            self.s += time.perf_counter() - self._t

    def close(self):
        gc.callbacks.remove(self)


def _allocator(dev) -> dict:
    """The caching allocator's counts of device allocations and of
    retries after a cache flush."""
    import torch
    st = torch.cuda.memory_stats(dev)
    return {k: int(st.get(k, 0)) for k in ("num_device_alloc",
                                           "num_device_free",
                                           "num_alloc_retries")}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0].strip() if out else "nvidia-smi: no card"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_start=None, cell=None, cfgj=None, pin=True, control=None) -> dict:
    """One run of cell `name`; returns the result (its keys as printed,
    with "checks" last) and, under "_lines", the check lines.  `cell`,
    `cfgj`: the cell's and configuration's dicts in place of their files
    (tests); `pin`: check the path's launch counters (False on the CPU,
    where no kernel launches); `control`: also hold the reference in a
    lower precision ("bf16") to the reference, under "_control"
    (`controls.py`, the tests)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load("cells", name) if cell is None else cell
    cfgj = load("configs", cell["config"]) if cfgj is None else cfgj
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    prog = Pkg(PROGRAM)
    HE = prog.HE
    roll = module("rollouts", cell["rollout"])
    C, horizon = int(cell["chunk"]), int(cell["horizon"])
    if horizon % C:
        raise ValueError(f"horizon {horizon} is not a whole number of "
                         f"chunks of {C}")
    n_chunks = horizon // C
    check_ticks = int(cell["check"].get("ticks", horizon))
    if check_ticks % C or not 0 < check_ticks <= horizon:
        raise ValueError(f"check ticks {check_ticks}: not a whole number "
                         f"of chunks of {C} within the horizon")

    # ---- set-up ----------------------------------------------------------
    cfg, start = build(prog, cfgj, seed, dev)
    B = roll.worlds(prog, cfg, start, cell)
    sample = sample_worlds(seed, B, int(cell["check"]["worlds"]))
    start_copy = [check.leaves(prog, w)
                  for w in roll.start_worlds(prog, start, sample)]

    def fleet(batch):
        m = prog.mesh.fleet_metrics(batch)
        return torch.stack(list(m.values())).tolist()

    HE.reset_launches()
    batch = roll.begin(prog, cfg, start, rollout_keys(seed, 0, B))
    for _ in range(n_chunks):
        batch = roll.chunk(prog, cfg, batch, C)
        fleet(batch)
    sync()
    launches = dict(HE.launches)
    if pin:
        check_path(launches, cell["path"])
    del batch
    gc.collect()

    # ---- the window --------------------------------------------------------
    # with --trace 1: the chunks after the first, `trace_chunks` of them,
    # under a profile of CUDA activities (the per-layer metrics), then
    # one chunk under a profile of the host's operations too (the
    # breakdown)
    traced = range(1, 1 + int(cell["trace_chunks"])) if trace else range(0)
    host_chunk = traced.stop if trace else -1
    prof = hprof = span = None
    states, walls = [], {}
    kept = None              # (rollout, ticks, batch) to check
    r, tick_in, chunks, batch = 1, 0, 0, None
    chunk_ends = []          # each chunk's end on the window's clock
    gcs = GCClock()
    allocs = _allocator(dev) if cuda else {}
    begin_s = 0.0
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        if chunks == traced.start and trace:
            prof = Profiler().__enter__()
            tw0 = time.perf_counter()
        if chunks == host_chunk:
            hprof = Profiler(host=True).__enter__()
            span = torch.profiler.record_function(TRACED_SPAN)
            span.__enter__()
            th0 = time.perf_counter()
        if batch is None:
            tb = time.perf_counter()
            with torch.profiler.record_function("tsim_bench.begin"):
                batch = roll.begin(prog, cfg, start, rollout_keys(seed, r, B))
            begin_s += time.perf_counter() - tb
        before = batch
        with torch.profiler.record_function("tsim_bench.chunk"):
            batch = roll.chunk(prog, cfg, batch, C)
        with torch.profiler.record_function("tsim_bench.read"):
            fleet(batch)     # the host's read: a synchronise
        t1 = time.perf_counter()
        chunk_ends.append(t1 - t0)
        if chunks in traced:
            states.append((before, batch))
            if chunks + 1 == traced.stop:
                walls["traced"] = t1 - tw0
                prof.__exit__(None, None, None)
        if chunks == host_chunk:
            span.__exit__(None, None, None)
            hprof.__exit__(None, None, None)
            walls["host"] = t1 - th0
        tick_in += C
        chunks += 1
        if tick_in == check_ticks:
            kept = (r, tick_in, batch)
        if tick_in == horizon:
            r, tick_in, batch = r + 1, 0, None
        # a window ends after `seconds`, past the traced chunks, and not
        # before a rollout has reached the checked tick
        if t1 - t0 >= seconds and chunks > host_chunk and kept is not None:
            break
    window_s = t1 - t0
    gcs.close()
    allocs = {k: v - allocs[k] for k, v in _allocator(dev).items()} \
        if cuda else {}
    found = forbidden_loaded(sys.modules)
    if found:
        raise RuntimeError(f"loaded in the program's process: {found}")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    cells_done = chunks * C * B * cfg.HEIGHT * cfg.WIDTH
    out = {"correct": None, "attempted": chunks, "failed": 0,
           "metrics": {}, "device": {}}
    man = manifest()
    e2e = {m["name"]: m for m in man["end_to_end"]}
    per_layer = {m["name"]: m for m in man["per_layer"]}
    if not trace:
        for m, v in (("cell_updates_per_s", cells_done / window_s),
                     ("setup_s", setup_s)):
            out["metrics"][m] = {"value": v, "unit": e2e[m]["unit"]}
    else:
        t = prof.trace(ticks=len(states) * C, worlds=B,
                       wall_s=walls["traced"])
        t.extra.update(states=states, cfg=cfg, pkg=prog, ref=Pkg(REFERENCE),
                       cfg_values=config_values(cfg), rollout=roll)
        for m in [m for m, d in per_layer.items()
                  if name in d.get("workloads", [name])]:
            v = module("metrics", m).read(t)
            if v is not None:
                out["metrics"][m] = {"value": v,
                                     "unit": per_layer[m]["unit"]}
        OUT.mkdir(exist_ok=True)
        size = t.save(OUT / f"{name}.trace.json.gz")
        print(f"trace: {len(t.device)} device activities, {size} bytes "
              f"in {OUT / (name + '.trace.json.gz')}", file=sys.stderr)
        out["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        ht = hprof.trace(ticks=C, worlds=B)
        out["breakdown"] = ht.breakdown()
        untraced = [b - a for i, (a, b) in enumerate(
            zip([0.0] + chunk_ends, chunk_ends))
            if i not in traced and i != host_chunk]
        print(f"profiler cost: a chunk took {walls['traced'] / len(traced):.3f}"
              f" s under the CUDA profile, {walls['host']:.3f} s under the "
              f"host's, {sorted(untraced)[len(untraced) // 2]:.3f} s (median) "
              f"untraced; device busy {t.busy_s / len(traced):.4f} s and "
              f"{ht.busy_s:.4f} s a chunk", file=sys.stderr)
        del t, ht
    out["device"] = {"platform": "gpu" if cuda else dev.type,
                     "kind": torch.cuda.get_device_name(dev) if cuda
                     else "cpu", "count": 1, "memory_peak_bytes": peak,
                     **out["device"]}
    durs = [b - a for a, b in zip([0.0] + chunk_ends, chunk_ends)]
    q = sorted(durs)
    print(f"window: {chunks} chunks of {C} ticks, {B} worlds, "
          f"{window_s:.3f} s (a chunk {q[0]:.3f} / {q[len(q) // 2]:.3f} / "
          f"{q[-1]:.3f} s, least / median / most); set-up {setup_s:.3f} s; "
          f"launches after the warm-up {launches}; peak {peak} bytes",
          file=sys.stderr)
    print(f"window's host: chunks (s) {[round(d, 3) for d in durs]}; "
          f"rollout starts {begin_s:.3f} s; garbage collection "
          f"{gcs.n} passes, {gcs.s:.3f} s; allocator {allocs}",
          file=sys.stderr)

    # ---- the check ---------------------------------------------------------
    kr, kticks, kbatch = kept
    got = [check.leaves(prog, roll.world(prog, kbatch, b)) for b in sample]
    prog_cfg = config_values(cfg)
    del batch, before, kbatch, kept, states, prof, hprof, start
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want_start, want = check.reference(
        cell, cfgj, roll, seed, dev, sample, kr, kticks, B)
    readings = check.compare(start_copy, want_start, got, want,
                             prog_cfg)
    print(f"check: rollout {kr} at tick {kticks}, worlds {sample}, the "
          f"reference took {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    if control is not None:
        # the control: the reference in a lower precision in the
        # program's place, held to the reference
        del got, start_copy
        ctl_start, ctl = check.reference(
            cell, cfgj, roll, seed, dev, sample, kr, kticks, B, control)
        out["_control"] = check.compare(ctl_start[1], want_start, ctl,
                                        want, ctl_start[0])
    print(f"check parts: {readings.pop('parts')}", file=sys.stderr)
    limits = cell["limits"]
    out["correct"] = all(readings[k] <= limits[k] for k in limits)
    out["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                     for k in limits}
    out["_lines"] = [f"{k} {readings[k]!r} limit {limits[k]!r}"
                     for k in limits]
    out["_readings"] = readings
    found = forbidden_loaded(sys.modules)
    if found:
        raise RuntimeError(f"loaded in the program's process: {found}")
    return out


def main(argv, t_start) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    entry = cell_entry(a.workload)
    cell = load("cells", a.workload)
    set_environment(cell)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(entry["chips"]):
        print(f"needs {entry['chips']} CUDA device(s), found {found}",
              file=sys.stderr)
        return 3
    print(card_line(), torch.__version__, torch.version.cuda,
          file=sys.stderr)
    out = run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
              t_start=t_start, cell=cell)
    lines = out.pop("_lines")
    out.pop("_readings")
    out.pop("_control", None)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0
