"""The traced run's two `torch.profiler` sessions and what is read from
them.

The per-layer readers read the first, which records CUDA activities
alone (kernels, copies and memsets, by name, start and duration) over
the traced chunks; the traced interval is the host's clock from a
synchronise before the first traced chunk's call to the synchronise at
its last one's end.  The device's busy time is the union of its
activities' intervals.  The second session, over the next chunk,
records the host's operations beside the device's, for the
`breakdown`: the idle gaps named by what the host was running (the
`tsim_bench.traced` span bounds it).  Recording the host's operations
slows the host several times over, so no per-layer metric reads it."""

from __future__ import annotations

import gzip
import json
import re
from dataclasses import dataclass, field

TRACED_SPAN = "tsim_bench.traced"
# host operations that only wait on or talk to the driver: an idle gap is
# named by the operation of the program that was running around them
_RUNTIME = re.compile(r"^(cuda|cu[A-Z]|Memcpy|Memset|Runtime)")


def kernel_base(name: str) -> str:
    """A device kernel's function name, without `void`, namespaces,
    template arguments and parameters: `void dm_worlds<GridSelect>(...)`
    gives `dm_worlds`."""
    s = name.strip()
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(]", s, 1)[0]
    return s.rsplit("::", 1)[-1].strip()


@dataclass
class Trace:
    """A traced window.  Times in ns on the profiler's clock."""
    device: list            # (name, start, duration) of device activities
    host: list              # (name, start, duration) on the main thread
    t0: int                 # the traced interval on the profiler's clock
    t1: int
    ticks: int              # ticks the traced chunks advanced the batch
    worlds: int
    extra: dict = field(default_factory=dict)   # state the byte counts read
    wall_s: float = None    # the traced interval on the host's clock

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9 if self.wall_s is None \
            else self.wall_s

    def merged(self) -> list:
        """The device's busy intervals inside the traced interval,
        merged, as (start, end)."""
        iv = sorted((max(s, self.t0), min(s + d, self.t1))
                    for _, s, d in self.device)
        out = []
        for s, e in iv:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    def kernels(self, bases) -> list:
        """The device activities whose `kernel_base` is in `bases`."""
        bases = set(bases)
        return [e for e in self.device if kernel_base(e[0]) in bases]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the idle
        gaps summed by the host operation running at each gap's middle
        (the innermost one of the program's, not the driver's), each in
        seconds."""
        ops = {}
        for name, _, d in self.device:
            k = kernel_base(name)[:80] or name[:80]
            ops[k] = ops.get(k, 0) + d / 1e9
        busy = self.merged()
        gaps, prev = [], self.t0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        # the host's operations on one thread nest: sweep them in order
        # of start with a stack, the gaps in order of their middle; the
        # innermost operation covering a middle is the stack's top
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        idle, stack, i = {}, [], 0
        for s, e in gaps:
            mid = (s + e) // 2
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][1] + stack[-1][2] <= host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] + stack[-1][2] < mid:
                stack.pop()
            label = "host, outside any operation"
            for name, _, _ in reversed(stack):
                if not _RUNTIME.match(name) and name != TRACED_SPAN:
                    label = name[:80]
                    break
            idle[label] = idle.get(label, 0) + (e - s) / 1e9
        rank = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gap_rank = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in rank],
                "idle_gaps": [[k, v] for k, v in gap_rank]}

    def save(self, path) -> int:
        """The device activities and the interval as gzipped JSON; the
        file's size in bytes."""
        with gzip.open(path, "wt") as f:
            json.dump({"t0": self.t0, "t1": self.t1, "ticks": self.ticks,
                       "worlds": self.worlds, "device": self.device}, f)
        return path.stat().st_size


class Profiler:
    """One torch.profiler session: CUDA activities alone, or with `host`
    the host's operations too."""

    def __init__(self, host: bool = False):
        self.host = host

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA]
        if self.host:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def trace(self, ticks: int, worlds: int, wall_s: float = None) -> Trace:
        """The session's Trace: with `host`, bounded by the
        `tsim_bench.traced` span; without, by the device activities, and
        `wall_s` the traced interval on the host's clock."""
        from torch.autograd import DeviceType
        events = self.prof.profiler.kineto_results.events()
        if not self.host:
            device = [(e.name(), e.start_ns(), e.duration_ns())
                      for e in events if e.device_type() == DeviceType.CUDA
                      and not e.is_user_annotation() and e.duration_ns() > 0]
            t0 = min((s for _, s, _ in device), default=0)
            t1 = max((s + d for _, s, d in device), default=0)
            return Trace(device, [], t0, t1, ticks, worlds, wall_s=wall_s)
        span = [e for e in events if e.name() == TRACED_SPAN
                and e.device_type() == DeviceType.CPU]
        if not span:
            raise RuntimeError(f"the profile holds no {TRACED_SPAN} span")
        main = span[0].start_thread_id()
        t0 = span[0].start_ns()
        t1 = t0 + span[0].duration_ns()
        device, host = [], []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation() and e.duration_ns() > 0:
                    device.append((e.name(), e.start_ns(), e.duration_ns()))
            elif e.start_thread_id() == main:
                host.append((e.name(), e.start_ns(), e.duration_ns()))
        return Trace(device, host, t0, t1, ticks, worlds)
