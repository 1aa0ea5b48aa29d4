"""Tracing and timing helpers (the JAX package's `profiling.py`).

The reference's only timing instrumentation is a 200-sample rolling
average of wall-clock render deltas inside the dashboard
(`traffic_statistics.py:17-55`).  Here: the same rolling tick-time
counters as a host-side helper, a `torch.profiler` trace of a block, and
a throughput measurement that waits for the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch


class TickTimer:
    """Rolling tick-time statistics (reference dashboard semantics:
    avg tick ms, delta per tick, ticks/sec, real-vs-sim time ratio)."""

    def __init__(self, window: int = 200,
                 seconds_per_tick: float = 6.0):
        self.samples = deque(maxlen=window)
        self.seconds_per_tick = seconds_per_tick
        self._last = None
        self._last_ticks = 0

    def record(self, ticks_advanced: int = 1):
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append((now - self._last, ticks_advanced))
        self._last = now
        self._last_ticks = ticks_advanced

    def stats(self) -> dict:
        if not self.samples:
            return {"avg_tick_ms": 0.0, "ticks_per_sec": 0.0,
                    "sim_to_real_ratio": 0.0}
        total_t = sum(s for s, _ in self.samples)
        total_ticks = sum(n for _, n in self.samples)
        avg_tick = total_t / max(total_ticks, 1)
        return {
            "avg_tick_ms": 1000.0 * avg_tick,
            "ticks_per_sec": total_ticks / total_t if total_t else 0.0,
            "sim_to_real_ratio": (self.seconds_per_tick / avg_tick
                                  if avg_tick else 0.0),
        }


@contextlib.contextmanager
def trace(log_dir: str = "tsim_trace"):
    """A `torch.profiler` trace (host and, with a card, device activity)
    of a block, written as a Chrome trace into `log_dir`:

        with profiling.trace("chiprun_out/trace") as prof:
            sim.step(100)

    yields the profiler, whose `key_averages()` sum the time by op."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _wait(sim):
    """Wait until the card has finished the world's pending work."""
    dev = sim.world.tick.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_steps(sim, n: int, chunk: int = 10) -> dict:
    """Advance n ticks measuring throughput, waiting for the card after
    each chunk; returns TickTimer stats plus cell-updates/sec."""
    t = TickTimer(seconds_per_tick=sim.cfg.TIME_PER_STEP_IN_SECONDS)
    _wait(sim)
    t.record(0)
    done = 0
    while done < n:
        k = min(chunk, n - done)
        sim.step(k)
        _wait(sim)
        t.record(k)
        done += k
    s = t.stats()
    s["cell_updates_per_sec"] = (s["ticks_per_sec"]
                                 * sim.cfg.WIDTH * sim.cfg.HEIGHT)
    return s
