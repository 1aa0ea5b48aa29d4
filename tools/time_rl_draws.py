#!/usr/bin/env python
"""Time the two forms of the RL plan's and initial parameters' draws.

`prng` computes a draw two ways, bit for bit the same: numpy's threefry
on the host (`prng.bits`, the result copied to the device) or torch's
on the device (`prng.bits_on`).  This script times both on one device
at config #4's sizes (1024 worlds, chunks of 50 ticks, up to 26 light
groups, REINFORCE at the Config's defaults):

  * `plan`: one chunk's REINFORCE draws, the Gumbel noise [B, n, G, 2]
    and the replay indices [B, n, 64] with a maxval per world and tick;
  * `init`: the policy net's kernels for `--init-worlds` worlds (10 x
    128, `nets.init_params`' truncated normals; ~150k draws a world).

Each time is the median of `--repeats` calls after one warm-up, host
wall clock (the device synchronized after each call).  Prints one JSON
line.

    python tools/time_rl_draws.py --device cpu --worlds 64 --repeats 3
    python tools/time_rl_draws.py --device cuda      # on the card
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worlds", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--groups", type=int, default=26)
    ap.add_argument("--init-worlds", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--threads", type=int, default=0,
                    help="torch's CPU threads (default: torch's own)")
    args = ap.parse_args()
    import torch
    if args.threads:
        torch.set_num_threads(args.threads)

    from trafficsimulation_tpu_torch import prng
    from trafficsimulation_tpu_torch.config import Config
    from trafficsimulation_tpu_torch.rl import controllers, nets
    dev = torch.device(args.device)
    B, n, G = args.worlds, args.ticks, args.groups
    cfg = Config(TRAFFIC_LIGHT_AGENT_ALGORITHM="NEIGHBOR_RL_BATCHED")
    keys = prng.split(prng.PRNGKey(0), B * n).reshape(B, n, 2)
    k_act, k_samp = np.moveaxis(prng.split(keys, 2), -2, 0)
    fills = np.random.default_rng(0).integers(1, 1 << 12, (B, n))
    wkeys = prng.split(prng.PRNGKey(1), args.init_worlds)
    net = controllers.net_of(cfg)
    kernels = [(name, tuple(p.shape)) for name, p in net.named_parameters()
               if name.endswith("kernel")]

    def plan(on):
        if on is None:
            g = torch.from_numpy(prng.gumbel(k_act, (G, 2))).to(dev)
            i = torch.from_numpy(prng.randint(
                k_samp, 0, fills, (cfg.SRL_BATCH_SIZE,)).astype(
                    np.int64)).to(dev)
        else:
            g = prng.gumbel(k_act, (G, 2), on)
            i = prng.randint(k_samp, 0, fills, (cfg.SRL_BATCH_SIZE,), on)
        return g, i

    def init(on):
        out = []
        for name, shape in kernels:
            kk = nets._path_key(wkeys, name.rsplit(".", 1)[0].split("."))
            out.append(torch.from_numpy(prng.truncated_normal(kk, shape))
                       .to(dev) if on is None
                       else prng.truncated_normal(kk, shape, on))
        return out

    def timed(fn):
        fn()
        ts = []
        for _ in range(args.repeats):
            t = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        return statistics.median(ts), out

    res = {"device": str(dev), "worlds": B, "ticks": n, "groups": G,
           "init_worlds": args.init_worlds,
           "torch_threads": torch.get_num_threads()}
    if dev.type == "cuda":
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    for name, fn in (("plan", plan), ("init", init)):
        t_np, a = timed(lambda fn=fn: fn(None))
        t_on, b = timed(lambda fn=fn: fn(dev))
        same = all(torch.equal(x.to(y.dtype), y) for x, y in zip(a, b))
        res[name] = {"numpy_s": t_np, "bits_on_s": t_on, "equal": same}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
