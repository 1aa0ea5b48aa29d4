"""CSV results recording (the JAX package's `recording.py`: the
reference's `DynamicTrafficAgent` recorders,
`dynamic_traffic_generator.py:432-522`; `_STAT_HEADERS` `:18-33`;
cleanup `general.py:63-94`).

Writes under `./Results/{run_timestamp}/`:
  totals.csv     — one row, overwritten every RESULTS_TOTAL_INTERVAL
  snapshots.csv  — appended row every RESULTS_INDIVIDUAL_INTERVAL
Intervals are in sim-minutes, converted to ticks via
TIME_PER_STEP_IN_SECONDS.  Recording runs host-side on the stats dict —
no device sync beyond the metrics already fetched.
"""

from __future__ import annotations

import csv
import os
import shutil
import time

from .config import Config

HEADERS = [
    "tick", "sim_day", "sim_time_of_day",
    "created_internal", "created_through", "created_service",
    "completed_internal", "completed_through",
    "errored_internal", "errored_through",
    "live_internal", "live_through",
    "live_service_food", "live_service_waste",
    # completed / live / combined averages (`_STAT_HEADERS` `:18-29`)
    "avg_duration_internal", "avg_duration_through",
    "avg_time_per_cell_internal", "avg_time_per_cell_through",
    "avg_duration_internal_live", "avg_duration_through_live",
    "avg_time_per_cell_internal_live", "avg_time_per_cell_through_live",
    "avg_duration_internal_total", "avg_duration_through_total",
    "avg_time_per_cell_internal_total", "avg_time_per_cell_through_total",
    "avg_daily_difference",
    "daily_total_internal", "remaining_internal",
    "daily_total_through", "remaining_through",
    "collisions_total", "malfunctions_total",
    "parked", "stuck", "overtaking", "in_stuck_detour",
    "avg_stuck_duration", "max_stuck_duration", "raining",
]


def _interval_ticks(cfg: Config, unit: str, value: int) -> int:
    secs = {"seconds": 1, "minutes": 60, "hours": 3600}.get(unit, 60) * value
    return max(1, secs // cfg.TIME_PER_STEP_IN_SECONDS)


class ResultsRecorder:
    def __init__(self, cfg: Config, root: str = "./Results"):
        self.cfg = cfg
        self.root = root
        self.run_dir = os.path.join(root, time.strftime("%Y%m%d-%H%M%S"))
        self._totals_every = _interval_ticks(
            cfg, cfg.RESULTS_TOTAL_INTERVAL_UNIT,
            cfg.RESULTS_TOTAL_INTERVAL_VALUE)
        self._snap_every = _interval_ticks(
            cfg, cfg.RESULTS_INDIVIDUAL_INTERVAL_UNIT,
            cfg.RESULTS_INDIVIDUAL_INTERVAL_VALUE)
        self._last_totals = -1
        self._last_snap = -1
        self._wrote_any = False
        if cfg.SAVE_TOTAL_RESULTS or cfg.SAVE_INDIVIDUAL_RESULTS:
            os.makedirs(self.run_dir, exist_ok=True)

    def maybe_record(self, stats: dict):
        tick = stats["tick"]
        if self.cfg.SAVE_TOTAL_RESULTS and \
                tick // self._totals_every > self._last_totals:
            self._last_totals = tick // self._totals_every
            self._write(os.path.join(self.run_dir, "totals.csv"),
                        stats, mode="w")
        if self.cfg.SAVE_INDIVIDUAL_RESULTS and \
                tick // self._snap_every > self._last_snap:
            self._last_snap = tick // self._snap_every
            self._write(os.path.join(self.run_dir, "snapshots.csv"),
                        stats, mode="a")

    def _write(self, path: str, stats: dict, mode: str):
        new = mode == "w" or not os.path.exists(path)
        with open(path, mode, newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(HEADERS)
            w.writerow([stats.get(h, "") for h in HEADERS])
        self._wrote_any = True

    def cleanup_if_empty(self):
        """Delete data-less run folders (`cleanup_empty_results`
        `general.py:63-94`, called on model reset
        `dynamic_grid_server.py:12`)."""
        if not self._wrote_any and os.path.isdir(self.run_dir):
            shutil.rmtree(self.run_dir, ignore_errors=True)


def cleanup_empty_results(root: str = "./Results"):
    """Remove any run folder containing no CSV data files."""
    if not os.path.isdir(root):
        return
    for d in os.listdir(root):
        p = os.path.join(root, d)
        if os.path.isdir(p) and not any(
                fn.endswith(".csv") and os.path.getsize(
                    os.path.join(p, fn)) > 0
                for fn in os.listdir(p)):
            shutil.rmtree(p, ignore_errors=True)
