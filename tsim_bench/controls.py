#!/usr/bin/env python3
"""The readings the check's limits are set from, for one cell, in one
process (set-up is long): the program's readings on many seeds, and the
control's on some of them.

    python3 tsim_bench/controls.py --workload <cell> --seeds 11 12 ... \
        --control-seeds 11 12 13 [--seconds 0] [--out DIR]

For each seed a run as the benchmark makes it (set-up, a window of
`--seconds` that holds at least one checked rollout, the check); on the
control seeds also the control: the reference computed in the nearest
lower precision (its carried f32 state stored in bfloat16 at each
chunk's end) in the program's place, held to the reference.  One JSON
line a seed on standard output, and in DIR/controls_<cell>.jsonl.  The
benchmark's runs do not run this."""

import os
import sys
import time

T0 = time.perf_counter()
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    from tsim_bench.common import load
    from tsim_bench.harness import card_line, run, set_environment
    cell = load("cells", a.workload)
    set_environment(cell)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    card = card_line()
    print(card, file=sys.stderr)
    sink = None
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        sink = open(os.path.join(a.out, f"controls_{a.workload}.jsonl"), "a")
    for seed in a.seeds:
        t = time.perf_counter()
        out = run(a.workload, seed, a.seconds, False, "cuda",
                  control="bf16" if seed in a.control_seeds else None)
        line = {"cell": a.workload, "seed": seed, "card": card,
                "correct": out["correct"], "readings": out["_readings"],
                "control": out.get("_control"),
                "cell_updates_per_s": out["metrics"]["cell_updates_per_s"]
                ["value"], "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
