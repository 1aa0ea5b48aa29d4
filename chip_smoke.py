#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--out DIR]

Phases (any failure raises and the script exits nonzero):

  1. the card's name and power limit, torch / CUDA versions, and the
     build of the port's CUDA kernels from `trafficsimulation_tpu_torch/
     csrc/` (one nvcc per source, sm_90a); the port must not have loaded
     jax or any module of the JAX package;
  2. each kernel against its plain PyTorch version on the card, on
     seeded random inputs at the headline's shapes (256x256, D = 608
     destination rows): K1-K4 for one world, then K5 and the batched K1,
     K3, K4 for B = 16 worlds; outputs must be bit-equal; each batched
     kernel's B = 1 call must equal the single-world kernel; median
     times of kernel and plain version, the bound of each kernel (bytes
     over 3.35 TB/s or, the larger, the operations: for the integer
     kernels the ALU-only ones over the ALU rate, 64 lanes an SM at its
     max SM clock, or all of them over twice that rate, adds issuing as
     IMAD on the FMA pipe too; for the f32 ones over 67 T/s), the device
     kernels one call runs (K1: one cooperative launch), and for K4
     the two `torch.cumsum` calls that compute the same function; K5's
     registers (ptxas) and SASS instructions per key row and world
     (`tools/sass_count.py`); then
     K6 at config #5's shapes (1024^2; the windowed stack, 108 words,
     and the dense stack, 36 words; dest planes holding -1 and rows past
     the stack; its bound counts dest and the result, 8 B a cell, and 32
     B for each distinct 32-byte sector the gathers touch, the old count
     of one word a hit beside it); the rain clouds' tick loop (no TPU
     kernel) for 16 worlds over 200 ticks, bit-equal to its plain
     version; the
     pedestrian step (`step_pedestrians`, no TPU kernel; one tiled
     shared-memory pass, given the world's cached sidewalk count) at
     256^2, 1024^2, a ragged 37 x 300 grid with counts up to 2000 a
     cell, and B = 3 worlds each with its own cell types, bit-equal to
     its plain version (which counts the sidewalks itself), one launch
     and one device kernel a call;
  3. the service FSM's ordered scatter-add on a case whose f32 sum
     depends on the order, and on signed zeros, subnormals and sums
     that flush to zero, runs of +-0 and dropped indices: the card must
     give the CPU's update-order
     result bit for bit; then on its inputs of the generated headline
     world's first tick (and, in group `config5`, of config #5's),
     captured from a one-tick `run_chunk`, against its plain version
     with its median, device time and bound, beside the PyTorch calls
     that could compute it (`index_put_` with accumulate, deterministic
     `index_add_`; `library_ms` only where one gives the same bits on
     every case); and the rain clouds' loop (`rain_ticks`) at the shape
     the per-tick path launches it with, on the headline's first-tick
     inputs, beside one launch with no work;
  4. generation: the headline world (BASELINE config #2) generated on
     the card from seed 0 (`sim.init_world`, `measure_and_shrink`,
     `inject_vehicles(..., 10_000)`) must equal the shipped snapshot of
     JAX's world on every leaf, and its key stack must hash to JAX's
     sha256;
  5. the headline from that world: `TrafficSim.step(23)` must reproduce
     the JAX end state stored in the snapshot (integer leaves exactly,
     f32 leaves within rtol 1e-6), with K1 23, K2 5, K3 5, K4 23
     launches on that path;
  6. the shared-geometry batch: `tile_dynamic` of the same world for 16
     keys (key 0 the world's own), `run_batch_shared(..., 23)`: world
     0 must equal JAX's end state, worlds 1 and 15 the single-world
     `run_chunk(23)` with their keys; launches K5 5, K1 23, K3 5, K4 23
     for the whole batch and K2 0;
  7. throughput in this one process: `run_batch_shared(..., 200)` from
     tick 23 (after the demand-window check) and the single-world
     `step(200)` from tick 23; steps/s and cell-updates/s of both, the
     batch's device idle share from `torch.profiler`; world 0 of the
     batch must then equal the single world at tick 223;
  8. service deliveries at full size: two food vehicles serving one
     block, parked on two block entrances of the headline world, deliver
     into the same tank in the first tick, with loads whose f32 sum
     depends on the order; world 0 of a B = 2 batch on the card must
     equal the plain version's run of the same world on the CPU (the
     tank bit for bit);
  9. hierarchical routing held to JAX: config #5 cut to 512^2
     (`init_world_hier` from seed 0, 25k vehicles) must match the JAX
     digest shipped in `trafficsimulation_tpu_torch/data/` on every leaf
     (sha256), at init and after `run_chunk(20)`; launches K1 20 (K1-hier,
     the hierarchical select inside K1), K6 0, K2 4, K3 4, K4 20, and the
     plain decide core never called;
 10. config #5 at full size: 1024^2, 100k vehicles, built on the card
     with the seconds of each stage; 20 ticks (launches checked as in
     9), then 20 more timed (steps/s, cell-updates/s), the device idle
     share over 10 ticks, and K1-hier, K2, K3, K4 on that world's inputs
     (K1-hier's those of its first tick, captured from a one-tick
     `run_chunk`) against their plain versions; K6 on the rows
     `hier_rows` gives for the dest field of K1-hier's planes after the
     first 20 ticks (the windowed stack with p, the dense stack with r);
 11. the megakernel path (group `mega`, TSIM_MEGA_FORCE=1) from the
     generated headline world: `TrafficSim.step(23)` must reproduce
     JAX's end state as in 5, with K9 5 (four segments of 5 ticks and
     one of 3), K2 5, K3 5 and no K1, K4 or ordered add; K9 against its
     plain version on one segment of 5 ticks from tick 0 and one of 3
     from tick 23 (every plane, light row, tank and stats row bit-equal
     but the f32 duration sums, within rtol 1e-5), its median, device
     time and bound; its grid, registers and shared memory (ptxas), and
     its grid barriers a tick under every FSM controller (counted by the
     kernel; each controller's segment held to the plain version), with
     nothing but K9's kernel in the profile of its calls (no memset);
     then 200 ticks of each path from tick 23 in this
     one process (steps/s, cell-updates/s, wall and device-busy ms per
     tick, idle share, launches per segment, K9's device ms per call)
     and their end states held equal;
 12. the halo-tiled decide + move (group `tiled`, K7, on no path of the
     JAX package or the port): K1's arguments on the first tick of the
     generated headline world (D4 = 152), captured from a one-tick
     `run_chunk`; K1 on them against its plain version (median, device
     time, bound); K7 at tiles (64, 64) and (16, 32) must equal its plain
     version and K1 bit for bit, in one launch and one device kernel per
     call, its plan (one block a window: tiles, shared memory, registers,
     blocks an SM) the kernel's own; medians, device times, and the bound
     (K1's bytes and operations: the function's, at every tiling; the
     windows' bytes are reported beside it);
 13. the framebuffer (group `render`): the port's `TrafficSim.render` of
     its 23-tick headline end state must hash to the sha256 of JAX's
     `render_frame` of that end state (`data/headline256_frame_digest.
     json`); K8 (`render_planes`, on no path) on that state against its
     plain version, bit-equal; in group `config5`, K8 on config #5's
     1024^2 state and the config #5 frame time as the JAX bench takes it
     (one warm-up, then the mean of 5 synchronized frames);
 14. a batch of cities (group `config4`, BASELINE config #4 letter for
     letter, `bench.py` `bench_config4`): 1024 worlds of 64^2, each from
     its own key of `split(PRNGKey(0), 1024)`, generated on the card by
     `init_world_batch` (`generate_all_sec` and the seconds by stage);
     worlds 0-3 held to the JAX digest shipped in
     `trafficsimulation_tpu_torch/data/` (`tools/make_torch_batch_digest.
     py`) on every leaf at init and after the first 50 ticks of
     `run_chunk_batch` (`sim.advance` under vmap, the bench's
     `jax.vmap(run_chunk)`); K1 50 in its block-per-world form (one
     launch a tick, one block a world; the form `k1_form` chooses and
     its plan printed, at least 2 blocks an SM), none in its cooperative
     form, K4 50, K2 10 (the batched K2 over the worlds' own key
     stacks), K3 10, K5 0, K9 0 (each count the launches for the whole
     batch, so a kernel mapping the worlds one by one would show B
     times as many); K1 in both forms on the path's own inputs of tick
     51 against its plain version; then 3 timed chunks of 50 ticks
     (median: cell-updates/s = 1024 x 4096 x steps/s, steps/s per
     world), launches and device busy time a tick, the idle share and
     the bench's cap diagnostics; K1 in both forms, K2 and K3's
     per-world forms against their plain versions at B = 1024 and B = 3
     on seeded inputs, and K1 in the form the shape chooses at 1024
     ragged 60 x 50 worlds;
 15. the host bridge (group `bridge`): `BridgeState` over the generated
     headline world on the card; one group's axis lights forced to stop
     and flushed must stop on the next tick and the override must clear,
     the group forced to go must have no light stopped a tick later;
     three chunks of the stepping loop's body (flush, `step(20)`,
     stats), timed, with their kernel launches checked; an
     ordinary and a food service vehicle spawned; the `/state` and
     `/metrics` dicts; the frame shows the spawned vehicles;
 16. pedestrians (group `config3`, BASELINE config #3 letter for letter,
     `bench.py` `bench_config3`): 256^2 from seed 0 generated on the
     card, `measure_and_shrink`, `inject_vehicles(..., 4000)`; every
     leaf (the pedestrian planes and ped_map among them) held to the JAX
     digest `data/ped_digest.json` (`tools/make_torch_ped_digest.py`)
     at init and after 100 and 200 ticks of `run_chunk`; launches
     `step_pedestrians` 100 (one a tick), K1 100, K4 100, K2 and K3 20,
     no plain pedestrian step or decide core;
     then 3 timed chunks of 100 ticks (median steps/s, cell-updates/s),
     launches and device busy ms a tick (a profile of 25 ticks), idle
     share, active pedestrians,
     the expected spawns a tick, active vehicles and the bench's cap
     diagnostics; the step on its inputs of tick 500 of that run (the
     world's cached sidewalk count checked) against its plain version,
     one device kernel a call;
 17. no traffic (group `config1`, BASELINE config #1, `bench_config1`):
     100^2 generated from seeds 1-3 after a warm seed 0 (ms a seed),
     each held to the digest at init; seed 0 after 200 ticks held to the
     digest; light cycling steps/s over 200 more ticks, the number of
     lights, launches and device busy ms a tick (a profile of 25);
 18. the RL light controllers (group `rl`) at the headline: REINFORCE
     (NEIGHBOR_RL_BATCHED, 10 x 128), A2C (RL_A2C_BATCHED, 10 x 256) and
     GAT-DQN (GAT_DQN_BATCHED), each world generated on the card from
     seed 0 with its controller, its initial parameters drawn on the
     card equal to flax's (the digest's sha256s), held to JAX's digest
     (`data/rl_digest.json`,
     `tools/make_torch_rl_digest.py`) at init and after 23 ticks with
     training held off (K1 and K4 23, K2 and K3 5 launches, no plain
     decide core, no megakernel, every leaf on the card); then 64 ticks
     at the Config's defaults with training on (parameters moved, Adam's
     count equal to the host's mirror of the updates, no NaN, the grid's
     arrows JAX's), a tick of `TrafficSim.step(1)`, and NEIGHBOR_RL and
     GAT_DQN through `TrafficSim`; one training update's device ms and
     kernels; and 3
     timed chunks of 50 ticks and a profile of 25 for each family and
     for QUEUE_ACTUATED on the same world, in one process (steps/s,
     launches and device busy ms a tick, idle share);
 19. the batched megakernel (group `mega_batch`, TSIM_MEGA_FORCE=1): K8
     on seeded planes at [3, 1024, 1024], [3, 256, 256], 37 x 300 and a
     view one byte off a 16-byte boundary (the wrapper's path named),
     each bit-equal to its plain version; the B = 16 rollouts of the
     generated headline world (phase 6's keys) for 23 ticks on the
     megakernel path: world 0 equal to JAX's end state, worlds 1 and 15
     to their single-world runs, K9 5 launches for the whole batch (its
     cooperative form), K5 5, no K1, K4 or ordered add; one batched K9
     call from tick 23 against the plain batched version world for world
     (`compare_mega`), one device kernel a call, its plan and bound
     (each input read once: the shared chunk tables once); config #4's
     1024 cities (`init_world_batch`) on the megakernel path for 50
     ticks: worlds 0-3 equal to JAX's `chunk50` but a world whose chunk
     tables reach one of K9's JAX quirks (`megakernel.quirks`, named and
     held to the plain version only), K9 10 launches in its
     block-per-world form, none cooperative; one batched K9 call against
     the plain version on worlds 0-3 and every 64th; and both paths of
     both batches in this process (steps/s, wall and device-busy ms a
     tick, idle share, launches a segment, K9's device ms a call).  With
     `--tree DIR` an older tree's K9 (one launch a world) is timed on the
     same paths (config #4 over 10 ticks) beside K8.
 20. the RL families in the world batches (group `rl_batch`; functorch's
     per-world fallback warning an error): for each family at full
     width, B = 16 rollouts of its headline world (`run_batch_shared`,
     world 0 with the world's key): 23 ticks with training held off,
     world 0 equal to the one-world digest's `headline256` (K1 and K4 23,
     K5 and K3 5 launches for the batch); 50 ticks at the Config's
     defaults, worlds 0 and 15 against their single-world runs (a world
     with a near tie in either run passed over for the next; integers
     exact, floats within RL_BATCH_RTOL / RL_BATCH_ATOL or, trained,
     RL_TRAINED_FRAC of their displacement), two control runs of
     REINFORCE that the gates must reject (TF32 products, replay indices
     rolled by a world), Adam's count of every world equal to the host's
     mirror and >= 1, parameters moved, nothing non-finite; one training
     update's device kernels at B = 4 and 16 (equal); 2 timed chunks of
     25 ticks and a profile of each family
     and of QUEUE_ACTUATED at B = 16 (steps/s per world, launches and
     device busy ms a tick, idle share); then config #4 with REINFORCE
     (1024 cities: per-world train ticks counted, worlds 0-3 against
     their single-world runs, K1 50 and K2 10 launches for the batch,
     steps/s beside the FSM config #4).
 21. the sharded world batches (group `mesh`): 4 ranks share the card
     over gloo (`parallel/launch.spawn`, one process a rank): the
     headline's B = 16 rollouts as 4 x 4 (rank 0 generates the world,
     `replicate_world` sends it; 23 ticks on the per-tick and the
     megakernel path) and config #4 letter for letter as 4 x 256
     (`init_world_batch(..., mesh)`, 50 ticks on both paths): every
     world's digest equal to the single-process runs of groups
     `headline`, `mega_batch` and `config4` (integer leaves bit for
     bit), world 0 to JAX's end state, worlds 0-3 to JAX's digest, the
     fleet metrics all-reduced over the ranks to the single process's,
     each rank's launches one a call for its slice (K1 23, K5 5, K3 5,
     K4 23; K9 5 a 23-tick run), each rank's K1 and K9 forms logged
     beside the single process's; the A2C crossroad shared batch of
     `data/rl_batch_digest.json` as 2 ranks x 2 (integers JAX's, trained
     floats within rtol 1e-4); the dry run's rank body
     (`dryrun.dryrun_rank`, 4 ranks x 2 worlds: the A2C update on every
     rank, the all-reduced total and the 8 worlds JAX's,
     `data/mesh_digest.json`).  All in one spawn of 4 ranks.
     `--only mesh_scaling` (development, no gate) times B = 16 over 1, 2
     and 4 ranks on the card.
 22. one world split over ranks by rows (group `spatial`,
     `parallel/spatial.py`): one spawn of 4 ranks sharing the card over
     gloo; the headline world (rank 0 generates it, `shard_world` sends
     each rank its windows) split over 2 and then 4 ranks, 23 ticks on
     the per-tick path with TSIM_MEGA_FORCE set: the gathered world
     equals the one-process `run_chunk` end state on every leaf by
     sha256, f32 included; each rank launches K1 and K4 23 times, K2 and
     K3 5 times, K9 never; each rank's resident key stack is its decide
     window's rows (printed with its share, its peak allocated memory
     and its all-reduces a tick); the dry run's crossroad over 4 ranks
     against JAX's `spatial_chunk_fn` on 8 devices
     (`data/spatial_digest.json`); K1-K4 on the headline's first-tick
     inputs cut to an edge and an inner rank's windows of 4 and the first
     of 2, against their plain versions.  `--only spatial_scaling`
     (development, no gate) times the headline over 1, 2 and 4 ranks.
 23. config #5 split over ranks by rows (group `spatial_hier`): the
     1024^2 world with 100k vehicles under hierarchical routing (group
     `config5`'s, or built here), 10 ticks (two routing segments) in
     this process, counting the vehicles whose row changes owner; then
     written to a file that rank 0 of one spawn of 4 ranks (gloo, the
     card shared) loads, split over 2 and 4 ranks: every leaf equal to
     the one-process run by sha256; each rank launches K1-hier and K4 a
     tick, K2 and K3 a segment, K9 never; each rank's dense key stack and
     `local_sdir4` hold its decide window's rows alone (printed beside
     the whole world's bytes and the window's limit, with the peak
     memory and all-reduces a tick).  K1-hier on config #5's first-tick
     inputs cut to an edge and an inner rank's decide windows of 4, with
     the window's first world row, against its plain version.
 24. config #3 split over ranks by rows (group `spatial_peds`): the 256^2
     world with pedestrians (group `config3`'s start, or built here), 23
     ticks in this process, counting the walkers and crossers that step
     across a slab edge (`step_pedestrians_plain(flux=True)` on each
     tick's inputs), then split over 2 and 4 ranks as above: every leaf
     equal, the pedestrian step launched once a tick on every rank.  The
     pedestrian step on the inputs of the next tick cut to an edge and
     an inner rank's pedestrian windows (the decide window widened by
     `engine.PED_REACH`), with the window's first world row, against its
     plain version.

The line before the last is the kernels' JSON summary, the one before it
the card's name and power limit; the last line is {"ok": true, "device":
{...}}.  With `--out DIR` the nvcc log and the full report are written
there too.
"""

from __future__ import annotations

import argparse
import hashlib
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
# long enough to amortise the per-call set-up (5 segments); 50 until the
# `mesh` group came: a profile's processing grows with its events (~1000
# launches a tick under RL), and the script's phases passed ~950 s
N_PROFILE_TICKS = 25
BATCH = 16
FLOAT_RTOL = 1e-6
REPORT = {}
T0 = time.perf_counter()

# H100 SXM peaks (the bound of each kernel): device memory bytes/s; the
# FP32 rate of the data sheet (an FMA counted as two flops on 128 FP32
# lanes an SM), for the kernels whose work is f32 arithmetic; and for the
# integer kernels the ALU rate: 64 INT32 (ALU) lanes an SM (Hopper white
# paper) x the SMs x the SM clock `nvidia-smi --query-gpu=clocks.max.sm`
# reports, set in main() (about 16.7e12 at 132 SMs and 1980 MHz).  Only
# the ALU pipe runs compares, mins, selects, logic and byte permutes; an
# integer add or move may also issue as IMAD on the FMA pipe beside it,
# so an integer kernel's ops take at least max(ALU-only ops / ALU rate,
# all ops / twice the ALU rate)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
ALU_LANES = 64
PEAK_ALU = None
# K2's and K5's operations per key row, cell and world: 4 adds (the keys)
# and 1 for the straight bound's add may go to the FMA pipe; 3 mins, 1 to
# take the argmin, 1 for the bound's min, 4 compares, 1 unreachable select
# and 1 to place the byte run on the ALU pipe only
SDIR_OPS = 16
SDIR_ALU_OPS = 11

KERNELS = {
    # name: (source, TPU kernel it replaces: file:line of its pallas_call,
    # the type of its arithmetic, which sets its op bound)
    "decide_move": ("trafficsimulation_tpu_torch/csrc/decide_move.cu",
                    "trafficsimulation_tpu/ops/pallas_engine.py:1026",
                    "int32"),
    "build_sdir": ("trafficsimulation_tpu_torch/csrc/sdir.cu",
                   "trafficsimulation_tpu/ops/pallas_engine.py:844",
                   "int32"),
    "build_wavefront": ("trafficsimulation_tpu_torch/csrc/wavefront.cu",
                        "trafficsimulation_tpu/ops/pallas_engine.py:466",
                        "int32"),
    "prefix_planes": ("trafficsimulation_tpu_torch/csrc/prefix.cu",
                      "trafficsimulation_tpu/ops/pallas_engine.py:520",
                      "int32"),
    "build_sdir_batched": ("trafficsimulation_tpu_torch/csrc/sdir.cu",
                           "trafficsimulation_tpu/ops/pallas_engine.py:889",
                           "int32"),
    "select_rows": ("trafficsimulation_tpu_torch/csrc/select_rows.cu",
                    "trafficsimulation_tpu/ops/pallas_engine.py:581",
                    "int32"),
    "mega": ("trafficsimulation_tpu_torch/csrc/megakernel.cu",
             "trafficsimulation_tpu/ops/megakernel.py:1175",
             "int32"),
    "decide_move_tiled": ("trafficsimulation_tpu_torch/csrc/decide_tiled.cu",
                          "trafficsimulation_tpu/ops/pallas_engine.py:699",
                          "int32"),
    "render": ("trafficsimulation_tpu_torch/csrc/render.cu",
               "trafficsimulation_tpu/ops/pallas_render.py:85",
               "f32"),
    # no TPU kernel: the JAX package runs these in XLA ops
    "ordered_add": ("trafficsimulation_tpu_torch/csrc/ordered_add.cu",
                    "none (XLA scatter-add, trafficsimulation_tpu/ops/"
                    "engine.py:923)", "f32"),
    "rain_ticks": ("trafficsimulation_tpu_torch/csrc/rain.cu",
                   "none (XLA ops per tick, trafficsimulation_tpu/agents/"
                   "rain.py:26)", "f32"),
    "step_pedestrians": ("trafficsimulation_tpu_torch/csrc/pedestrians.cu",
                         "none (XLA ops per tick, trafficsimulation_tpu/"
                         "agents/pedestrians.py:126)", "int32"),
    # K9 with a world dimension (`jax.vmap` of the pallas_call): one launch
    # a segment for a batch, in its cooperative form (the B = 16 rollouts
    # of one city) and its block-per-world form (config #4's cities)
    "mega_batch": ("trafficsimulation_tpu_torch/csrc/megakernel.cu",
                   "trafficsimulation_tpu/ops/megakernel.py:1175", "int32"),
    "mega_worlds": ("trafficsimulation_tpu_torch/csrc/megakernel.cu",
                    "trafficsimulation_tpu/ops/megakernel.py:1175", "int32"),
    # the per-world-geometry forms (config #4's batch of cities): K1 with
    # its geometry one plane a world (the cooperative form), K2 over the
    # worlds' own key stacks, K3 with its geometry one plane a world
    "decide_move_worlds": ("trafficsimulation_tpu_torch/csrc/decide_move.cu",
                           "trafficsimulation_tpu/ops/pallas_engine.py:1026",
                           "int32"),
    # K1's block-per-world form (one block owns one small world), which
    # config #4's batch takes by shape (`hopper_engine.k1_form`)
    "decide_move_blocks": ("trafficsimulation_tpu_torch/csrc/decide_move.cu",
                           "trafficsimulation_tpu/ops/pallas_engine.py:1026",
                           "int32"),
    "build_sdir_stacks": ("trafficsimulation_tpu_torch/csrc/sdir.cu",
                          "trafficsimulation_tpu/ops/pallas_engine.py:844",
                          "int32"),
    "build_wavefront_worlds": ("trafficsimulation_tpu_torch/csrc/"
                               "wavefront.cu",
                               "trafficsimulation_tpu/ops/pallas_engine.py:"
                               "466", "int32"),
}
# the launch counter (`HE.launches`) of each summary entry
COUNTER = {"decide_move_worlds": "decide_move", "mega_batch": "mega",
           "build_sdir_stacks": "build_sdir",
           "build_wavefront_worlds": "build_wavefront"}
# which run's launch count the summary reports: K2 on the single-world
# path, K6 on config #5's, K9 on the megakernel path, the others on the
# batched path
SUMMARY_PATH = {"build_sdir": "single", "select_rows": "config5",
                "mega": "mega", "decide_move_tiled": "single",
                "render": "single", "decide_move_worlds": "config4",
                "decide_move_blocks": "config4",
                "build_sdir_stacks": "config4",
                "build_wavefront_worlds": "config4",
                "step_pedestrians": "config3", "mega_batch": "mega_batch",
                "mega_worlds": "config4_mega"}
# on no path of the port (0 launches on every path); chip_smoke.py drives
# them directly.  K6 serves the plain version of K1-hier's select; K1's
# cooperative form with per-world geometry serves batches of different
# cities too few to fill the card (config #4's takes the block-per-world
# form).
OFF_PATH = ("decide_move_tiled", "render", "select_rows",
            "decide_move_worlds")
MEGA_DUR_COLS = [2, 3, 7]      # the stats rows' f32 duration sums
# the kernels whose call is one device kernel (the profiler's count)
ONE_KERNEL = ("decide_move", "build_wavefront", "prefix_planes", "mega",
              "decide_move_worlds", "decide_move_blocks", "build_sdir_stacks",
              "build_wavefront_worlds", "step_pedestrians", "select_rows",
              "decide_move_tiled")
CONFIG5 = dict(WIDTH=1024, HEIGHT=1024, MAX_VEHICLES=100_000,
               ROUTING_HIER=True, INTERNAL_POPULATION_TRAFFIC_PER_DAY=100_000,
               PASSING_POPULATION_TRAFFIC_PER_DAY=20_000)
CONFIG5_VEHICLES = 100_000
N_HIER_TICKS = 20
# BASELINE config #4 (`bench.py` `bench_config4`), letter for letter
CONFIG4 = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
               MAX_FIELD_DESTS=32, MAX_VEHICLES=256,
               INTERNAL_POPULATION_TRAFFIC_PER_DAY=2000,
               PASSING_POPULATION_TRAFFIC_PER_DAY=500)
CONFIG4_WORLDS = 1024
CONFIG4_TICKS = 50
CONFIG4_REPEATS = 3
CONFIG4_ODD_B = 3
CONFIG4_RAGGED = (60, 50)       # a ragged world within one block's reach
# the megakernel path's batches (group `mega_batch`): ticks timed on each
# path of the B = 16 batch; an older tree's config #4 on its megakernel
# path (1024 K9 launches a segment) over this many ticks
MEGA_BATCH_TICKS = 100
MEGA_OLD_CONFIG4_TICKS = 10
CONFIG4_DIGEST = os.path.join("trafficsimulation_tpu_torch", "data",
                              "config4_batch_digest.json")
# BASELINE config #3 (`bench.py` `bench_config3`), letter for letter
CONFIG3 = dict(WIDTH=256, HEIGHT=256, MAX_VEHICLES=4096,
               MAX_FIELD_DESTS=640, PEDESTRIANS_ENABLED=True,
               PEDESTRIANS_PER_DAY=200_000)
CONFIG3_REPEATS = 3
# BASELINE config #1 (`bench.py` `bench_config1`), letter for letter
CONFIG1 = dict(WIDTH=100, HEIGHT=100, ENABLE_TRAFFIC=False,
               MAX_FIELD_DESTS=64, MAX_VEHICLES=256)
PED_DIGEST = os.path.join("trafficsimulation_tpu_torch", "data",
                          "ped_digest.json")
PHASES = ("kernels", "ordered_add", "headline", "mega", "mega_batch",
          "hier_digest",
          "config4", "config5", "config3", "config1", "tiled", "render",
          "bridge", "rl", "rl_batch", "mesh", "spatial", "spatial_hier",
          "spatial_peds")
# development groups, run only when named in --only: `forms` times K1's
# forms over K1_SWEEP worlds and the pedestrian step (phase_forms),
# `select_rows` K6 alone (phase_select_rows), `mesh_scaling` the B = 16
# rollouts over 1, 2 and 4 ranks on the card (phase_mesh_scaling),
# `spatial_scaling` one headline world split over 1, 2 and 4 ranks
# (phase_spatial_scaling)
DEV_PHASES = ("forms", "select_rows", "mesh_scaling", "spatial_scaling")
# the groups --tree may run (an older tree's kernels beside this one's)
TREE_PHASES = ("forms", "select_rows", "tiled", "mega", "mega_batch")
K1_SWEEP = (3, 16, 132, 264, 528, 1024)
SWEEP_PED_TICKS = 500
SWEEP_VEHICLES = 4000
TILES = ((64, 64), (16, 32))     # K7's tilings of the headline grid
# the numbers of a kernel's other shapes in the summary line
SUB_KEYS = ("max_abs_err", "ms", "device_ms", "kernels_per_call",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")


def log(*a):
    """Print a line; the report keeps each line's start and seconds since
    the script began (where the time goes)."""
    print(*a, flush=True)
    REPORT.setdefault("log_s", []).append(
        (round(time.perf_counter() - T0, 1), " ".join(map(str, a))[:90]))


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


def device_profile(fn, reps: int = 10):
    """(device ms a call, device kernels a call) of fn from torch.profiler
    (a CUDA-event interval around one call also holds the host's time in
    the wrapper, which is larger for small kernels), over `reps` calls
    after two warm-up calls inside the profiler's window; (None, None)
    when three profiles in a row record no device time.  The profiler
    may drop some calls' kernels (a profile after a long one may come
    back empty, or with 0.3-0.9 kernels a call recorded for a one-kernel
    call), so each kernel counts at its mean recorded duration, times its
    launches a call (its recorded count over `reps`, rounded, at least
    one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=2, active=reps,
                                       repeat=1)) as prof:
            for _ in range(reps + 2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        per = [(e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count]
        if sum(t for t, _ in per) > 0:
            calls = [max(1, round(c / reps)) for _, c in per]
            ms = sum(t / c * k for (t, c), k in zip(per, calls)) / 1e3
            return ms, float(sum(calls))
    return None, None


def device_ms(fn, reps: int = 10):
    return device_profile(fn, reps)[0]


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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


def alu_rate():
    """(ALU-pipe integer operations/s, SMs, max SM clock in MHz) of card
    0."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ALU_LANES * mhz * 1e6, sms, mhz


def ops_ms(ops, kernel: str) -> float:
    """The least time of a kernel's operations: for an f32 kernel ops
    (a count) at PEAK_F32; for an integer one ops = (ALU-only ops, all
    ops), the larger of the ALU-only ops on the ALU pipe and all ops on
    the ALU and FMA pipes together."""
    if KERNELS[kernel][2] == "f32":
        return ops / PEAK_F32 * 1e3
    alu, total = ops
    return max(alu / PEAK_ALU, total / (2 * PEAK_ALU)) * 1e3


def bound(nbytes: float, ops, kernel: str):
    """(bound_ms, bound_by): the least time for these bytes and `kernel`'s
    ops (ops_ms)."""
    tb = nbytes / PEAK_BYTES * 1e3
    to = ops_ms(ops, kernel)
    return (tb, "bytes") if tb >= to else (to, "operations")


def k1_cost(planes, kcfg, shared_geometry=False, stack_words=None):
    """(bytes, ops) of K1 (one world, or B worlds) on these vehicle
    planes, counting what this data needs.  At every cell of every world
    the 5 i32 + 1 f32 planes in and the 6 planes and flags out; at a cell
    where a vehicle stands also what only a vehicle reads: its 4 random
    draws, wnd, the stop, rain and pedestrian masks, and the geometry
    (intersection and dest_id, 5 bytes; once for a cell where any world
    holds a vehicle when the worlds share it); and `stack_words` packed
    stack words (default: one a vehicle).  Operations: at least one
    compare (ALU only) per cell, world and phase (2 K + 2 phases)."""
    H, W = planes[0].shape[-2:]
    present = ((planes[0] & 1) == 1).reshape(-1, H, W)
    cells = present.numel()
    n_veh = int(present.sum())
    geo = int(present.any(0).sum()) if shared_geometry else n_veh
    words = n_veh if stack_words is None else stack_words
    nbytes = cells * (6 * 4 + 7 * 4) + n_veh * (4 * 4 + 4 + 3) + geo * 5 \
        + words * 4
    return nbytes, (cells * (2 * kcfg.VEHICLE_MAX_SPEED + 2),) * 2


def measure(name, kern, plain, nbytes, ops, shape, lib=None, reps=20,
            plain_reps=3, one_kernel=True) -> dict:
    """One kernel (the KERNELS entry `name` begins with) against its plain
    version on the same inputs (bit-equal or raise), its median and
    device time, the plain version's median, the bound (bound), and the
    library call's median where there is one; a ONE_KERNEL entry must be
    one device kernel a call unless `one_kernel` is False (an older
    tree's, timed by the `forms` group)."""
    got = kern()
    torch.cuda.synchronize()
    ref = plain()
    err = compare(name, got, ref)
    if lib is not None:
        compare(f"{name} library call", lib(), ref)
    del got, ref
    ms = median_ms(kern, reps=reps)
    dms, nk = device_profile(kern)
    plain_ms = median_ms(plain, reps=plain_reps, warmup=1)
    lib_ms = median_ms(lib, reps=reps) if lib is not None else None
    kernel = name.split()[0]
    if one_kernel and kernel in ONE_KERNEL and nk is not None and nk > 1:
        raise AssertionError(f"{name}: {nk} device kernels a call, not one")
    bms, by = bound(nbytes, ops, kernel)
    to = ops_ms(ops, kernel)
    log(f"kernel {name} ({shape}): bit-equal to plain; median {ms:.4f} ms "
        f"(device {fmt_ms(dms)} in {nk} kernels a call), plain "
        f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}, "
        f"{nbytes / 1e6:.2f} MB, {to:.4f} ms of {KERNELS[kernel][2]} ops)"
        + (f", library {lib_ms:.4f} ms" if lib_ms else ""))
    return {"max_abs_err": err, "ms": ms, "device_ms": dms,
            "kernels_per_call": nk, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms, "bytes": nbytes,
            "ops": ops, "bytes_ms": nbytes / PEAK_BYTES * 1e3,
            "ops_ms": to, "shape": shape}


class Inputs:
    """Seeded random inputs on the card."""

    def __init__(self, seed):
        self.dev = torch.device("cuda")
        self.g = torch.Generator(device=self.dev).manual_seed(seed)

    def bits(self, *shape):
        return torch.randint(-2**31, 2**31, shape, generator=self.g,
                             device=self.dev,
                             dtype=torch.int64).to(torch.int32)

    def unif(self, *shape):
        return torch.rand(shape, generator=self.g, device=self.dev)

    def bern(self, p, *shape):
        return torch.rand(shape, generator=self.g, device=self.dev) < p

    def rint(self, lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=self.g,
                             device=self.dev, dtype=torch.int32)


def kernel_cases(cfg, HE, engine, B):
    """{name: (kernel fn, plain fn, bytes, ops, library fn or None)} at
    the headline's shapes: one world (B = 0) or a batch of B worlds
    sharing the geometry and the key stack."""
    H, W, D = cfg.HEIGHT, cfg.WIDTH, cfg.MAX_FIELD_DESTS
    HW = H * W
    D4 = (D + 3) // 4
    r = Inputs(0)               # B = 0 and B = 1 draw the same inputs
    nb = max(B, 1)
    lead = (B,) if B else ()
    cases = {}

    # K1: dense random planes, every fault flag present, fault rolls that
    # fire often, random sdir bytes and wavefront bytes
    kcfg = cfg.replace(VEHICLE_MALFUNCTION_CHANCE=0.01,
                       VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    sdir4 = torch.stack([engine.pack_sdir4(r.rint(0, 256, D, H, W).to(
        torch.uint8)) for _ in range(nb)])
    wb = r.rint(0, 16, nb, 4, H, W)
    wnd = wb[:, 0] | (wb[:, 1] << 8) | (wb[:, 2] << 16) | (wb[:, 3] << 24)
    planes = tuple(r.bits(nb, H, W) for _ in range(5)) + (
        r.unif(nb, H, W),)
    masks = (r.bern(0.15, nb, H, W), r.bern(0.1, nb, H, W),
             r.bern(0.02, nb, H, W))
    inter = r.bern(0.1, H, W)
    dest = r.rint(-1, D, H, W)
    randoms = (r.unif(nb, H, W), r.unif(nb, H, W), r.rint(1, 6, nb, H, W),
               r.bits(nb, H, W))
    k1_bytes, k1_ops = k1_cost(planes, kcfg, shared_geometry=True)
    if B:
        cases["decide_move"] = (
            lambda: HE.decide_move_batched(kcfg, sdir4, wnd, planes, *masks,
                                           inter, dest, randoms),
            lambda: HE.decide_move_core_batched(kcfg, sdir4, wnd, planes,
                                                *masks, inter, dest,
                                                randoms),
            k1_bytes, k1_ops, None)
    else:
        one = (sdir4[0], wnd[0], tuple(p[0] for p in planes),
               *(m[0] for m in masks), inter, dest,
               tuple(x[0] for x in randoms))
        cases["decide_move"] = (
            lambda: HE.decide_move(kcfg, *one),
            lambda: HE.decide_move_core(
                kcfg, one[0], one[1], *one[2], *one[3:8],
                *one[8]), k1_bytes, k1_ops, None)

    # K2 / K5: key stack with unreachable (KBIG) rows and hard-blocked
    # (2^17) pens.  Bytes: K0 once, pen (per world) and legal, the packed
    # stacks out.  Operations: the function's need per key row, cell and
    # world (SDIR_OPS, SDIR_ALU_OPS of them on the ALU pipe only).
    q = r.rint(0, 60000, D, 4, H, W)
    q = torch.where(r.bern(0.15, D, 4, H, W), 65535, q)
    K0 = engine.costs_u16_to_keys(q)
    del q
    pen4 = torch.where(r.bern(0.1, nb, 4, H, W), 1 << 17,
                       r.rint(0, 3000, nb, 4, H, W))
    legal4 = r.bern(0.6, 4, H, W).to(torch.int32)
    tp2 = int(round(2 * cfg.VEHICLE_TURN_PENALTY))
    sd_bytes = D * 4 * HW * 4 + nb * 4 * HW * 4 + 4 * HW * 4 \
        + nb * D4 * HW * 4
    sd_ops = (D * HW * nb * SDIR_ALU_OPS, D * HW * nb * SDIR_OPS)
    if B:
        cases["build_sdir_batched"] = (
            lambda: (HE.build_sdir_batched(K0, pen4, legal4, tp2),),
            lambda: (HE.sdir_encode_batched(K0, pen4, legal4, tp2),),
            sd_bytes, sd_ops, None)
    else:
        cases["build_sdir"] = (
            lambda: (HE.build_sdir(K0, pen4[0], legal4, tp2),),
            lambda: (HE.sdir_encode(K0, pen4[0], legal4, tp2),),
            sd_bytes, sd_ops, None)

    # K3: random geometry.  Bytes: allowed and road once, hard in and the
    # packed word out per world; operations: per relax step, direction
    # and neighbour a select and a min (ALU only).
    allowed = r.rint(0, 16, H, W).to(torch.uint8)
    road = r.bern(0.5, H, W)
    hard = r.bern(0.1, nb, H, W) & road
    k3_bytes = 2 * HW + nb * HW * 5
    k3_ops = (nb * HW * 4 * 4 * 2
              * cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS,) * 2
    if B:
        cases["build_wavefront"] = (
            lambda: (HE.build_wavefront_batched(cfg, allowed, road, hard),),
            lambda: (HE.wavefront_core_batched(cfg, allowed, road, hard),),
            k3_bytes, k3_ops, None)
    else:
        cases["build_wavefront"] = (
            lambda: (HE.build_wavefront(cfg, allowed, road, hard[0]),),
            lambda: (HE.wavefront_core(cfg, allowed, road, hard[0]),),
            k3_bytes, k3_ops, None)

    # K4: random occupancy.  Bytes: one plane in, two out; one add per
    # element and scan (either pipe).
    occ = r.bern(0.3, *lead, H, W).to(torch.int32)
    k4_bytes = nb * HW * 12
    k4_ops = (0, nb * HW * 2)

    def cumsums():
        return (torch.cumsum(occ, -1, dtype=torch.int32),
                torch.cumsum(occ, -2, dtype=torch.int32))
    kern4 = HE.prefix_planes_batched if B else HE.prefix_planes
    cases["prefix_planes"] = (lambda: kern4(occ),
                              lambda: HE.prefix_planes_plain(occ),
                              k4_bytes, k4_ops, cumsums)
    return cases


def phase_kernels(cfg, HE, engine, B):
    """Each kernel vs its plain version on the card; medians and
    bounds."""
    out = {}
    cases = kernel_cases(cfg, HE, engine, B)
    shape = f"{cfg.HEIGHT}x{cfg.WIDTH}, D = {cfg.MAX_FIELD_DESTS}"
    for name, (kern, plain, nbytes, ops, lib) in cases.items():
        heavy = name in ("build_sdir", "build_sdir_batched") or B
        out[name] = measure(f"{name} (B={B or 1})", kern, plain, nbytes,
                            ops, shape, lib, plain_reps=5 if heavy else 20)
    del cases
    torch.cuda.empty_cache()
    return out


def phase_batch_one(cfg, HE, engine):
    """Each batched kernel's B = 1 call equals the single-world kernel
    (K5 at B = 1 against K2)."""
    cases1 = kernel_cases(cfg, HE, engine, 1)
    cases0 = kernel_cases(cfg, HE, engine, 0)
    pairs = {"decide_move": "decide_move", "build_wavefront":
             "build_wavefront", "prefix_planes": "prefix_planes",
             "build_sdir_batched": "build_sdir"}
    for b1, single in pairs.items():
        got = [g[0] for g in cases1[b1][0]()]
        compare(f"{b1} at B=1 vs {single}", got, cases0[single][0]())
    log("batched kernels at B=1 equal the single-world kernels "
        "(K5 at B=1 equals K2)")
    del cases0, cases1
    torch.cuda.empty_cache()


def k6_row(name, HE, sdir4, dest, shape) -> dict:
    """K6 on these inputs against its plain version (`measure`), its bound
    from the bytes this dest plane makes the memory move: dest in and the
    result out, 8 B a cell, and 32 B for every distinct 32-byte sector of
    the stack that the in-range gathers touch (the stack's base is
    32-byte aligned); beside it the old count, one 4-byte word a hit,
    and the bytes if the memory moved 64 bytes for every distinct
    64-byte segment gathered (DRAM's fetch).  8 operations a cell (the
    row's range compares, the shifts and the byte extract), counted as
    ALU only."""
    D4 = sdir4.shape[0]
    HW = dest.numel()
    hi = dest.reshape(-1).to(torch.int64) >> 2
    hit = (hi >= 0) & (hi < D4)
    word = (hi * HW + torch.arange(HW, device=dest.device))[hit]
    sectors = int(torch.unique(word >> 3).numel())
    segments = int(torch.unique(word >> 4).numel())
    words = HW * 8 + 4 * int(hit.sum())
    nbytes = HW * 8 + 32 * sectors
    m = measure(name, lambda: (HE.select_rows(sdir4, dest),),
                lambda: (HE.select_dest_rows(sdir4, dest),), nbytes,
                (HW * 8,) * 2, shape, plain_reps=20)
    seg_bytes = HW * 8 + 64 * segments
    m.update(sectors=sectors, bytes_words=words,
             bound_ms_words=words / PEAK_BYTES * 1e3, segments_64b=segments,
             bound_ms_64b=seg_bytes / PEAK_BYTES * 1e3)
    log(f"{name}: {sectors} distinct 32-byte sectors gathered "
        f"({sectors / HW:.3f} a cell), bound {m['bound_ms']:.4f} ms on "
        f"{nbytes / 1e6:.2f} MB (one word a hit: {words / 1e6:.2f} MB, "
        f"{m['bound_ms_words']:.4f} ms; {segments} 64-byte segments: "
        f"{seg_bytes / 1e6:.2f} MB, {m['bound_ms_64b']:.4f} ms); device "
        f"{fmt_ms(m['device_ms'])}")
    return m


def phase_select_rows(HE):
    """K6 against its plain version at config #5's shapes: the windowed
    stack (9 * 48 planes, 108 words) and the dense stack (144 rows, 36
    words) at 1024^2, dest planes with -1 and rows past the stack."""
    H = W = CONFIG5["WIDTH"]
    r = Inputs(1)
    out = {}
    for name, D4 in (("local", 108), ("dense", 36)):
        sdir4 = r.bits(D4, H, W)
        dest = r.rint(-5, 4 * D4 + 8, H, W)
        out[name] = k6_row(f"select_rows ({name} stack)", HE, sdir4, dest,
                           f"sdir4 [{D4}, {H}, {W}], dest [{H}, {W}]")
        del sdir4, dest
    torch.cuda.empty_cache()
    REPORT["select_rows"] = out
    return out


def phase_rain_ticks(HE):
    """The rain clouds' tick loop (`rain_ticks`, no TPU kernel) for
    B = 16 worlds of the headline's size over 200 ticks, clouds moving
    fast enough to leave and be replaced, against its plain version per
    world: every table, flag and cooldown bit-equal."""
    from trafficsimulation_tpu_torch.agents import rain
    from trafficsimulation_tpu_torch.config import Config
    B, R, n, H, W = BATCH, 3, N_BENCH_TICKS, 256, 256
    cfg = Config(WIDTH=W, HEIGHT=H)
    r = Inputs(7)

    def table(x, y, vx, vy, rad):
        return torch.stack([x, y, vx, vy, -rad, -rad, W + rad, H + rad,
                            rad], dim=-2).contiguous()
    u = r.unif(5, B, R)
    clouds = table(u[0] * (W + 200) - 100, u[1] * (H + 200) - 100,
                   u[2] * 6 - 3, u[3] * 6 - 3,
                   float(cfg.RAIN_RADIUS_MIN) + torch.floor(u[4] * 50))
    draws = torch.stack([r.rint(0, 2, B * n), r.rint(0, 4, B * n),
                         r.rint(0, 1 << 23, B * n), r.rint(0, 2, B * n),
                         r.rint(cfg.RAIN_RADIUS_MIN, cfg.RAIN_RADIUS_MAX + 1,
                                B * n)], dim=1).to(torch.int64)
    spawn = table(*rain._spawn_params(cfg, H, W, draws)) \
        .reshape(9, B, n).permute(1, 0, 2).contiguous()
    want_cd = torch.where(r.bern(0.1, B, n), 0, -1).to(torch.int32)
    args = (clouds, r.bern(0.7, B, R), r.rint(0, 3, B), spawn, want_cd)
    cool = 30
    got = HE.rain_ticks_batched(*args, cool)
    ref = [torch.stack(o) for o in zip(*(rain.cloud_ticks_plain(
        *(a[b] for a in args), cool) for b in range(B)))]
    err = compare("rain_ticks", got, ref)
    act = torch.cat([args[1][:, None], got[1]], dim=1)
    spawns = int((~act[:, :-1] & act[:, 1:]).sum())
    exits = int((act[:, :-1] & ~act[:, 1:]).sum())
    if not (spawns and exits):
        raise AssertionError(f"rain_ticks: the check saw {spawns} spawns "
                             f"and {exits} exits")
    ms = median_ms(lambda: HE.rain_ticks_batched(*args, cool))
    plain_ms = median_ms(lambda: [rain.cloud_ticks_plain(
        *(a[b] for a in args), cool) for b in range(B)], reps=3, warmup=1)
    log(f"kernel rain_ticks (B={B}, {R} clouds, {n} ticks): bit-equal to "
        f"plain (max abs err {err:g}; {exits} exits, {spawns} spawns into "
        f"free slots); "
        f"median {ms:.4f} ms, plain {plain_ms:.2f} ms (per world "
        f"{n} x ~20 launches)")
    # every input read once, every output written once; ~40 operations
    # per cloud and tick
    nbytes = sum(a.numel() * a.element_size() for a in args) + sum(
        t.numel() * t.element_size() for t in got)
    bms, by = bound(nbytes, B * R * n * 40, "rain_ticks")
    dms = device_ms(lambda: HE.rain_ticks_batched(*args, cool))
    REPORT["rain_ticks"] = {"max_abs_err": err, "ms": ms, "device_ms": dms,
                            "plain_ms": plain_ms, "bound_ms": bms,
                            "bound_by": by, "library_ms": None,
                            "spawns": spawns, "exits": exits,
                            "shape": f"B = {B}, {R} clouds, {n} ticks"}
    return REPORT["rain_ticks"]


def k5_code(build, out_dir, key_worlds: int) -> dict:
    """K5's code at B = 16 (`sdir_batched_kernel<4, 4>`): ptxas's
    registers and spills from the build log, and from its SASS
    (`tools/sass_count.py`) the instructions of its word loop (4 key rows
    x 4 worlds a thread) outside the copy loop nested in it (the cp.async
    copies, whose ragged path never runs at 256^2), per key row and world,
    in all, in arithmetic, and of that on the FMA pipe (IMAD); and the
    floor of that code over `key_worlds` key rows, cells and worlds: the
    larger of its ALU-pipe instructions at the ALU rate and all its
    instructions at the SM's issue rate (4 warp instructions a clock,
    twice the ALU rate).  The SASS goes to DIR/k5_sass.txt with --out."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import sass_count
    name = "sdir_batched_kernelILi4ELi4E"
    info = (sass_count.ptxas_info(build.build_log, name)
            if build.build_log else {})
    fn, insns, labels = sass_count.function_sass(build.library_path, name)
    loop = sass_count.loops(insns, labels)[0]
    rows_worlds = 4 * 4
    k2_info = (sass_count.ptxas_info(build.build_log, "11sdir_kernel")
               if build.build_log else {})
    fma = loop["own_opcodes"].get("IMAD", 0)
    alu_pipe = loop["own_alu"] - fma
    floor = max(alu_pipe / PEAK_ALU, loop["own"] / (2 * PEAK_ALU)) \
        * key_worlds / rows_worlds * 1e3
    out = {"ptxas": info, "k2_ptxas": k2_info,
           "loop_instructions": loop["instructions"],
           "copy_loop_instructions": loop["instructions"] - loop["own"],
           "per_key_world": loop["own"] / rows_worlds,
           "alu_per_key_world": loop["own_alu"] / rows_worlds,
           "fma_pipe_per_key_world": fma / rows_worlds,
           "alu_pipe_per_key_world": alu_pipe / rows_worlds,
           "code_floor_ms": floor, "opcodes": loop["own_opcodes"]}
    if out_dir:
        with open(os.path.join(out_dir, "k5_sass.txt"), "w") as f:
            f.write("\n".join(f"/*{a:04x}*/ {i}" for a, i in insns))
    log(f"K5 code (B = 16): {info.get('registers', 'not measured')} "
        f"registers, spills {info.get('spill_stores', 'not measured')} B; "
        f"word loop {loop['instructions']} SASS instructions, "
        f"{loop['own']} outside its copy loop (the cp.async copies, "
        f"{out['copy_loop_instructions']} static) = "
        f"{out['per_key_world']:.2f} per key row and world "
        f"({out['alu_per_key_world']:.2f} arithmetic: "
        f"{out['alu_pipe_per_key_world']:.2f} on the ALU pipe, "
        f"{out['fma_pipe_per_key_world']:.2f} IMAD on the FMA pipe); the "
        f"code's pipe floor {floor:.4f} ms; opcodes "
        f"{json.dumps(out['opcodes'])}")
    return out


def launch_floor_ms(HE) -> float:
    """One launch of the port's kernel with no work (K4 on a 1x1
    plane): the latency floor of any single launch."""
    occ = torch.zeros((1, 1, 1), dtype=torch.int32, device="cuda")
    return median_ms(lambda: HE.prefix_planes_batched(occ), reps=50)


def phase_ordered_add(HE):
    """Duplicate block indices whose f32 sum depends on the order: the
    card folds them in update order, as the CPU (and XLA's CPU
    scatter-add) does."""
    base = torch.tensor([[1.0, 0.0, 5.0], [0.0, 3.0, 0.0]])
    idx = torch.tensor([[0, 0, 0, 2, 1, 0], [1, 1, 1, 1, 2, -1]])
    vals = torch.tensor([[1e8, 1.0, -1e8, 2.0, 7.0, 0.5],
                         [1e8, -1e8, 1.0, 1.0, 9.0, 9.0]])
    cpu = HE.ordered_add_plain(base, idx, vals)
    got = HE.ordered_add(base.cuda(), idx.cuda(), vals.cuda()).cpu()
    compare("ordered_add", (got,), (cpu,))
    want = np.float32(np.float32(np.float32(np.float32(
        np.float32(1.0) + np.float32(1e8)) + np.float32(1.0))
        - np.float32(1e8)) + np.float32(0.5))
    if got[0, 0].item() != want:
        raise AssertionError(f"ordered_add: {got[0, 0].item()} is not the "
                             f"update-order fold {want}")
    log(f"ordered scatter-add: card == CPU update order bit for bit "
        f"({got.tolist()})")
    for name, (b, i, v) in ordered_add_cases().items():
        compare(f"ordered_add ({name})",
                (HE.ordered_add(b.cuda(), i.cuda(), v.cuda()).cpu(),),
                (HE.ordered_add_plain(b, i, v),))
    log(f"ordered scatter-add: card == CPU on {sorted(ordered_add_cases())}")


def ordered_add_cases() -> dict:
    """{name: (base, idx, vals) on the CPU}: the signed zeros that decide
    a bare -0 base (+0 and -0 updates, cancellation to +0), runs of
    thousands of +-0 with a few nonzero updates, subnormal sums, sums
    that flush to -0 before +0 or -0 updates (XLA's flush to zero),
    indices outside [0, T), and the fold order of the 1e8 case."""
    nz = -0.0
    base = torch.tensor([[nz, nz, nz, 0.0, nz, 2.0, nz, 1e-39]])
    idx = torch.tensor([[0, 1, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 7, 7, 9, -1,
                         0]])
    vals = torch.tensor([[0.0, nz, 0.0, nz, 0.0, 7.0, -7.0, -2.0, nz, 0.0,
                          1e-40, -1e-40, -2e-39, 5e-40, 3.0, 4.0, nz]])
    g = torch.Generator().manual_seed(11)
    n = 6000
    zi = torch.randint(0, 3, (2, n), generator=g)
    zv = torch.where(torch.rand((2, n), generator=g) < 0.5, 0.0, nz)
    zv[0, [10, 3000, 5999]] = torch.tensor([0.1, -3.7, 1e-3])
    zi[0, [10, 3000, 5999]] = 1
    # flush to zero: tiny sums that flush to -0 or +0, then +0, -0 or a
    # subnormal update; bases that only zero updates reach flush, a
    # subnormal base that no update reaches keeps its bits
    a, b = 1.5e-38, 1.4e-38
    fb = torch.tensor([[-a, -a, -a, -a, a, nz, 2e-39, -2e-39, 3e-39, -a]])
    fi = torch.tensor([[0, 1, 2, 3, 4, 5, 7, 8, 0, 1, 2, 3, 5, 9, 9, 9, 9]])
    fv = torch.tensor([[b, b, 0.0, b, -b, -1e-40, nz, 0.0, 0.0, nz, b,
                        1e-40, 1e-40, b, 0.0, 1.0, -1.0]])
    return {"signed zeros, subnormals, dropped": (base, idx, vals),
            "flush to zero": (fb, fi, fv),
            "zero runs": (torch.tensor([[nz, nz, 0.0], [1.0, nz, nz]]), zi,
                          zv),
            "fold order": (torch.tensor([[1.0, 0.0, 5.0]]),
                           torch.tensor([[0, 0, 0, 2, 1, 0]]),
                           torch.tensor([[1e8, 1.0, -1e8, 2.0, 7.0,
                                          0.5]]))}


def ordered_add_library(b, i, v, ref, HE) -> dict:
    """The PyTorch calls that could compute the ordered add, on the rows
    flattened with a sink slot per row for the dropped indices:
    `index_put_(..., accumulate=True)` and `index_add_` under
    `torch.use_deterministic_algorithms(True)`.  Each one's median on
    these inputs, and whether it gives the plain version's bits here and
    on `ordered_add_cases()`: only then is it the same function."""
    def flat(b, i, v):
        R, T = b.shape
        rows = torch.arange(R, device=b.device)[:, None] * (T + 1)
        keep = (i >= 0) & (i < T)
        fi = (rows + torch.where(keep, i, T)).reshape(-1)
        fb = torch.cat([b, torch.zeros_like(b[:, :1])], 1).reshape(-1)
        return fb, fi, v.reshape(-1)

    def put(fb, fi, fv):
        return fb.index_put_((fi,), fv, accumulate=True)

    def add_det(fb, fi, fv):
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            return fb.index_add_(0, fi, fv)
        finally:
            torch.use_deterministic_algorithms(was)

    cases = {"path": (b, i, v, ref)}
    for name, (cb, ci, cv) in ordered_add_cases().items():
        cases[name] = (cb.cuda(), ci.cuda(), cv.cuda(),
                       HE.ordered_add_plain(cb, ci, cv).cuda())
    out = {}
    for lname, fn in (("index_put_ accumulate", put),
                      ("index_add_ deterministic", add_det)):
        differs = []
        for name, (cb, ci, cv, cref) in cases.items():
            fb, fi, fv = flat(cb, ci, cv)
            got = fn(fb, fi, fv).reshape(cb.shape[0], -1)[:, :-1]
            n = int((got.view(torch.int32) != cref.view(torch.int32)).sum())
            if n:
                differs.append(f"{name}: {n} of {cref.numel()} targets")
        fb, fi, fv = flat(b, i, v)
        out[lname] = {"ms": median_ms(lambda: fn(fb, fi, fv)),
                      "same_function": not differs, "differs": differs}
    return out


def compare_leaves(name, ref: dict, got: dict):
    bad = []
    for k, a in ref.items():
        b = got[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append((k, "shape/dtype", a.shape, b.shape))
        elif np.issubdtype(a.dtype, np.floating):
            if not np.allclose(a, b, rtol=FLOAT_RTOL, atol=0.0):
                bad.append((k, int((a != b).sum())))
        elif not np.array_equal(a, b):
            bad.append((k, int((a != b).sum())))
    if bad:
        raise AssertionError(f"{name}: leaves differ (leaf, entries): "
                             f"{bad}")
    return sum(1 for a in ref.values()
               if not np.issubdtype(a.dtype, np.floating))


def check_launches(name, launches, need):
    for k, n in need.items():
        if launches[k] != n:
            raise AssertionError(f"{name}: kernel {k} launched "
                                 f"{launches[k]} times, expected {n}")


def phase_generation(snapshot, tsim, transfer, prng, Config):
    """Generate the headline world on the card and hold it to the
    snapshot of JAX's world, every leaf, and its key stack to JAX's
    sha256.  Returns (cfg, world on the card, reference)."""
    cfg_snap, snap, ref = snapshot.load_snapshot(snapshot.HEADLINE, "cpu")
    cfg = Config(**snapshot.HEADLINE_CFG)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    world = tsim.init_world(cfg, prng.PRNGKey(snapshot.HEADLINE_SEED),
                            "cuda")
    cfg, world = tsim.measure_and_shrink(cfg, world)
    world = tsim.inject_vehicles(cfg, world, snapshot.HEADLINE_VEHICLES)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    if cfg != cfg_snap:
        raise AssertionError(f"shrunk config differs from the snapshot's: "
                             f"{cfg.CAP_OVERRIDES}, {cfg.MAX_FIELD_DESTS} "
                             f"vs {cfg_snap.CAP_OVERRIDES}, "
                             f"{cfg_snap.MAX_FIELD_DESTS}")
    sha = snapshot.field_sha256(world.cost_field)
    if sha != ref["field_sha256"]:
        rows = snapshot.field_row_sums(world.cost_field)
        bad = np.nonzero(rows != ref["field_row_sums"])[0]
        raise AssertionError(f"key stack sha256 differs from JAX's "
                             f"({ref['field_sha256']}); rows differing: "
                             f"{bad[:20].tolist()} ({len(bad)} in all)")
    snap_np = transfer.world_to_numpy(snap)
    n = compare_leaves("generated headline world vs the JAX snapshot",
                       snap_np, transfer.world_to_numpy(world.replace(
                           cost_field=None)))
    log(f"generation: the headline world from seed "
        f"{snapshot.HEADLINE_SEED} generated on the card in {t_gen:.2f} s "
        f"(init_world + measure_and_shrink + inject_vehicles) equals JAX's "
        f"snapshot on all {len(snap_np)} leaves ({n} integer/bool "
        f"exact); key stack "
        f"{tuple(world.cost_field.shape)} sha256 {sha} equals JAX's")
    REPORT["generation_s"] = t_gen
    return cfg, world, ref


def phase_headline(HE, tsim, transfer, cfg, world, ref):
    """Run 23 ticks of the generated headline world, hold them to
    JAX."""
    sim = tsim.TrafficSim.from_world(cfg, world)
    HE.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(N_REF_TICKS)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    launches = dict(HE.launches)
    log(f"step({N_REF_TICKS}) in {t_ref:.2f} s; kernel launches {launches}")

    n_exact = compare_leaves("single-world end state vs JAX", ref["end"],
                             transfer.world_to_numpy(sim.world))
    log(f"end state after {N_REF_TICKS} ticks equals JAX's: {n_exact} "
        f"integer/bool leaves exact, {len(ref['end']) - n_exact} f32 leaves "
        f"within rtol {FLOAT_RTOL}")
    st = sim.stats()
    log("stats: " + json.dumps({k: st[k] for k in (
        "tick", "live_internal", "created_internal", "created_through",
        "completed_internal", "completed_through", "stuck", "raining")}))
    check_launches("single-world path", launches, {
        "decide_move": N_REF_TICKS, "prefix_planes": N_REF_TICKS,
        "build_sdir": 5, "build_wavefront": 5, "build_sdir_batched": 0,
        "rain_ticks": N_REF_TICKS, "select_rows": 0,
        "decide_move_blocks": 0})
    return sim, launches


def batch_keys(world_key: torch.Tensor, prng) -> np.ndarray:
    """Key 0 is the world's own; keys 1.. come from a fixed key."""
    k0 = world_key.cpu().numpy().view(np.uint32)
    rest = prng.split(np.array([0, 2026], np.uint32), BATCH - 1)
    return np.concatenate([k0[None], rest]).astype(np.uint32)


def phase_batch(cfg, world, ref, HE, mesh, tsim, transfer, prng):
    """B = 16 rollouts of the headline city, 23 ticks, held to JAX (world
    0) and to the single-world runs (worlds 1 and 15)."""
    keys = batch_keys(world.key, prng)
    batch = mesh.tile_dynamic(world, keys)
    HE.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = mesh.run_batch_shared(cfg, batch, N_REF_TICKS)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    launches = dict(HE.launches)
    log(f"run_batch_shared(B={BATCH}, {N_REF_TICKS}) in {t_b:.2f} s; "
        f"kernel launches {launches}")
    check_launches("batched path", launches, {
        "build_sdir_batched": 5, "decide_move": N_REF_TICKS,
        "build_wavefront": 5, "prefix_planes": N_REF_TICKS,
        "rain_ticks": N_REF_TICKS, "build_sdir": 0, "select_rows": 0,
        "decide_move_blocks": 0})
    compare_leaves("batch world 0 vs JAX", ref["end"],
                   transfer.world_to_numpy(mesh.world_at(batch, 0)))
    log(f"batch world 0 after {N_REF_TICKS} ticks equals JAX's end state")
    for b in (1, BATCH - 1):
        w = world.replace(key=torch.from_numpy(
            keys[b].view(np.int32).copy()).cuda())
        single = transfer.world_to_numpy(tsim.run_chunk(cfg, w, N_REF_TICKS))
        compare_leaves(f"batch world {b} vs single run", single,
                       transfer.world_to_numpy(mesh.world_at(batch, b)))
    log(f"batch worlds 1 and {BATCH - 1} equal the single-world runs with "
        "their keys")
    vm = batch.veh_map
    if tuple(vm.shape) != (BATCH, cfg.HEIGHT, cfg.WIDTH):
        raise AssertionError(f"batch veh_map shape {tuple(vm.shape)}")
    REPORT["batch_ref"] = {"seconds": t_b, "launches": launches}
    keep_ref("b16_per_tick", batch, launches, mesh)
    return batch, launches


def device_busy_ms(fn, n_ticks) -> float:
    """Summed device kernel time per tick of fn() under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    return sum(e.self_device_time_total for e in ka
               if e.device_type == DeviceType.CUDA) / 1e3 / n_ticks


def profile_ticks(fn, n_ticks, top: int = 8):
    """(device busy ms per tick, kernel launches per tick, the `top`
    kernels by device time: (name, ms per tick, launches per tick)) of
    fn() under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    ev.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / n_ticks
    launches = sum(e.count for e in ev) / n_ticks
    return busy, launches, [(e.key[:60], e.self_device_time_total / 1e3
                             / n_ticks, e.count / n_ticks)
                            for e in ev[:top]]


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_throughput(cfg, sim, batch, card, HE, mesh, transfer):
    """Batched and single-world ticks/s in this one process, from tick
    23 over 200 ticks (the first service trips are due at tick 200)."""
    HW = cfg.HEIGHT * cfg.WIDTH
    mesh.assert_demand_window(cfg, batch, N_BENCH_TICKS)
    HE.reset_launches()
    batch, dt_b = timed(lambda: mesh.run_batch_shared(cfg, batch,
                                                      N_BENCH_TICKS))
    adds = HE.launches["ordered_add"]
    world, dt_1 = timed(lambda: sim.step(N_BENCH_TICKS))
    sps_b, sps_1 = N_BENCH_TICKS / dt_b, N_BENCH_TICKS / dt_1
    cups_b, cups_1 = BATCH * HW * sps_b, HW * sps_1
    log(f"throughput ({card}): batch B={BATCH}: {N_BENCH_TICKS} ticks in "
        f"{dt_b:.3f} s = {sps_b:.2f} steps/s = {cups_b:.4g} "
        f"cell-updates/s; single world: {dt_1:.3f} s = {sps_1:.2f} "
        f"steps/s = {cups_1:.4g} cell-updates/s; ratio {cups_b / cups_1:.2f}")
    # the batch's device idle share over a short window
    _, wall = timed(lambda: mesh.run_batch_shared(cfg, batch,
                                                  N_PROFILE_TICKS))
    busy = device_busy_ms(lambda: mesh.run_batch_shared(cfg, batch,
                                                        N_PROFILE_TICKS),
                          N_PROFILE_TICKS)
    wall_ms = wall * 1e3 / N_PROFILE_TICKS
    idle = 1 - busy / wall_ms
    log(f"batch B={BATCH} over {N_PROFILE_TICKS} ticks: wall {wall_ms:.3f} "
        f"ms/tick, device busy {busy:.3f} ms/tick, idle share {idle:.3f}")
    # world 0 of the batch is the single world, tick for tick
    compare_leaves(f"batch world 0 vs single world at tick "
                   f"{N_REF_TICKS + N_BENCH_TICKS}",
                   transfer.world_to_numpy(world),
                   transfer.world_to_numpy(mesh.world_at(batch, 0)))
    m = batch.metrics
    svc = {k: getattr(m, k).tolist() for k in (
        "created_service", "completed_service", "errored_through")}
    fleet = {k: int(v) for k, v in mesh.fleet_metrics(batch).items()}
    log(f"batch world 0 at tick {N_REF_TICKS + N_BENCH_TICKS} equals the "
        f"single world; fleet {fleet}; service trips per world {svc}; "
        f"ordered_add launches {adds}")
    if not bool(batch.vehicles.active.any(dim=1).all()):
        raise AssertionError("a world of the batch has no vehicle left")
    for name, t in (("veh_map", batch.veh_map), ("density", batch.density)):
        if tuple(t.shape) != (BATCH, cfg.HEIGHT, cfg.WIDTH):
            raise AssertionError(f"{name} shape {tuple(t.shape)}")
    if not bool(torch.isfinite(batch.density).all()):
        raise AssertionError("non-finite density")
    REPORT["throughput"] = {
        "ticks": N_BENCH_TICKS, "card": card, "batch": BATCH,
        "batch_seconds": dt_b, "batch_steps_per_s": sps_b,
        "batch_cell_updates_per_s": cups_b, "single_seconds": dt_1,
        "single_steps_per_s": sps_1, "single_cell_updates_per_s": cups_1,
        "batch_wall_ms_per_tick": wall_ms, "batch_busy_ms_per_tick": busy,
        "batch_idle_share": idle, "service": svc, "fleet": fleet,
        "ordered_add_launches": adds}


def service_world(cfg, world):
    """The world with pool slots 0 and 1 turned into food vehicles that
    both serve one block and stand on two free block entrances (their
    destinations), and that block's tank set so that the two deliveries'
    f32 sum depends on their order.  Returns (world, the two pool slots,
    block, the tank's start value, the loads in update order)."""
    v, d, bs = world.vehicles, world.dests, world.blocks_static
    DF = world.cost_field.shape[0]
    dpos, dvalid, dkind = (t.cpu().numpy() for t in (d.pos, d.valid, d.kind))
    taken = set(v.pos[v.active].cpu().numpy().tolist())
    free = [i for i in range(DF) if dvalid[i] and dkind[i] == 0
            and int(dpos[i]) not in taken]
    d1, d2 = free[0], free[1]
    b = int(np.nonzero((bs.valid & bs.needs_food).cpu().numpy())[0][0])
    cap = float(bs.food_cap[b])
    rng = np.random.default_rng(7)
    f32 = np.float32
    while True:
        f, a, c = (f32(x) for x in rng.uniform(0, cap / 4, 3))
        if f32(f32(f + a) + c) != f32(f32(f + c) + a):
            break
    slots = [0, 1]

    def put(t, vals):
        t = t.clone()
        t[slots] = torch.tensor(vals, dtype=t.dtype, device=t.device)
        return t
    v = v.replace(
        active=put(v.active, [True, True]), pos=put(v.pos, [int(dpos[d1]), int(dpos[d2])]), dest=put(v.dest,
                                                              [d1, d2]),
        kind=put(v.kind, [2, 2]), service_block=put(v.service_block, [b, b]),
        service_phase=put(v.service_phase, [0, 0]),
        load=put(v.load, [float(a), float(c)]),
        heading=put(v.heading, [-1, -1]), parked=put(v.parked, [0, 0]),
        current_speed=put(v.current_speed, [0, 0]),
        base_speed=put(v.base_speed, [0, 0]))
    food = world.blocks.food.clone()
    food[b] = float(f)
    return (world.replace(vehicles=v,
                          blocks=world.blocks.replace(food=food)),
            slots, b, f, (a, c))


def phase_service(cfg, world, HE, mesh, tsim, transfer, keys):
    """Duplicate service deliveries at full size: the card's batched run
    against the plain version's run on the CPU."""
    n = 2
    w, slots, b, f, (a, c) = service_world(cfg, world)
    HE.reset_launches()
    batch = mesh.run_batch_shared(cfg, mesh.tile_dynamic(w, keys[:2]), n)
    adds = HE.launches["ordered_add"]
    card = transfer.world_to_numpy(mesh.world_at(batch, 0))
    leaves = transfer.world_leaves(w)
    t0 = time.perf_counter()
    cpu = transfer.world_to_numpy(tsim.run_chunk(
        cfg, transfer.world_from_leaves({k: t.cpu() for k, t in
                                         leaves.items()}), n))
    t_cpu = time.perf_counter() - t0
    compare_leaves("service deliveries, card batch vs CPU plain", cpu, card)
    got, ref = card["blocks.food"][b], cpu["blocks.food"][b]
    if got.view(np.int32) != ref.view(np.int32):
        raise AssertionError(f"tank {b}: card {got!r} != CPU {ref!r}")
    if card["vehicles.service_phase"][slots].tolist() != [1, 1] or \
            card["vehicles.load"][slots].tolist() != [0.0, 0.0]:
        raise AssertionError("the two food vehicles did not both deliver")
    f32 = np.float32
    log(f"service deliveries: 2 food vehicles into tank {b} in one tick "
        f"(start {f:.9g}, loads {a:.9g}, {c:.9g}; update order "
        f"{f32(f32(f + a) + c):.9g}, the other order "
        f"{f32(f32(f + c) + a):.9g}); after {n} ticks the card's batch "
        f"equals the CPU plain run ({t_cpu:.1f} s), tank {got:.9g} bit for "
        f"bit; ordered_add launches {adds}")
    if adds != n:
        raise AssertionError(f"ordered_add launched {adds} times, "
                             f"expected {n}")
    REPORT["service"] = {"block": b, "start": float(f),
                         "loads": [float(a), float(c)], "tank": float(got),
                         "cpu_seconds": t_cpu}


def hier_launches(cfg, n_ticks: int) -> dict:
    """Kernel launches of an n-tick `run_chunk` under hierarchical
    routing: K1 (K1-hier) and K4 every tick; K2 and K3 once per routing
    segment; no K6 (the selects run inside K1-hier)."""
    segs = -(-n_ticks // max(1, cfg.PATHFINDING_COOLDOWN))
    return {"select_rows": 0, "build_sdir": segs, "build_wavefront": segs,
            "prefix_planes": n_ticks, "decide_move": n_ticks,
            "build_sdir_batched": 0, "decide_move_blocks": 0,
            "rain_ticks": n_ticks if cfg.RAIN_ENABLED else 0}


class no_plain_core:
    """Inside the block, any call of the plain decide core
    (`HE.decide_move_core`) raises: on a card path K1 or K1-hier runs
    the tick's decide + move, never the plain version."""

    def __init__(self, HE):
        self.HE = HE

    def __enter__(self):
        self.orig = self.HE.decide_move_core

        def spy(*a, **k):
            raise AssertionError("the plain decide_move_core ran on a card "
                                 "path")
        self.HE.decide_move_core = spy

    def __exit__(self, *exc):
        self.HE.decide_move_core = self.orig


def check_digest(name, digest: dict, leaves: dict):
    """Every leaf's dtype, shape and sha256 against the JAX digest; an
    f32 leaf whose bytes differ must still match its float64 sum, sum of
    magnitudes and maximum within FLOAT_RTOL (`parallel.mesh.
    diff_digests`).  Returns (exact, near)."""
    from trafficsimulation_tpu_torch.parallel import mesh
    got = {k: mesh.leaf_digest(v) for k, v in leaves.items()}
    bad = mesh.diff_digests(digest, got, rtol=FLOAT_RTOL)
    if bad:
        raise AssertionError(f"{name}: leaves differ from the JAX digest: "
                             f"{bad}")
    near = [k for k, d in digest.items()
            if got[k]["sha256"] != d["sha256"]]
    return len(digest) - len(near), near


def phase_hier_digest(HE, tsim, transfer, prng, snapshot, Config):
    """Config #5 cut to 512^2 against JAX's digest: the world as built,
    and after `run_chunk(20)`."""
    with open(snapshot.HIER_DIGEST) as f:
        dig = json.load(f)
    cfg = Config(**dig["base_cfg"])
    timings = {}
    t0 = time.perf_counter()
    cfg3, world = tsim.init_world_hier(cfg, prng.PRNGKey(dig["seed"]),
                                       "cuda", timings)
    world = tsim.inject_vehicles(cfg3, world, dig["n_vehicles"])
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    for k, v in dig["cfg"].items():
        want = (tuple(tuple(p) for p in v) if k == "CAP_OVERRIDES" else v)
        if getattr(cfg3, k) != want:
            raise AssertionError(f"hier config {k}: {getattr(cfg3, k)} "
                                 f"vs JAX's {want}")
    ex0, near0 = check_digest("hier world (512^2) at init", dig["init"],
                              transfer.world_to_numpy(world))
    HE.reset_launches()
    with no_plain_core(HE):
        end, t_run = timed(lambda: tsim.run_chunk(cfg3, world,
                                                  dig["ticks"]))
    launches = dict(HE.launches)
    check_launches("hier path (512^2)", launches,
                   hier_launches(cfg3, dig["ticks"]))
    ex1, near1 = check_digest(f"hier world (512^2) after {dig['ticks']} "
                              "ticks", dig["end"],
                              transfer.world_to_numpy(end))
    log(f"hier 512^2 held to JAX: built in {t_init:.2f} s "
        f"({ {k: round(v, 2) for k, v in timings.items()} }), "
        f"{cfg3.MAX_FIELD_DESTS} dense rows, local stack "
        f"{tuple(world.local_sdir4.shape)}; init {ex0}/{len(dig['init'])} "
        f"leaves bit-equal (f32 within rtol: {near0}); run_chunk("
        f"{dig['ticks']}) in {t_run:.2f} s, {ex1}/{len(dig['end'])} leaves "
        f"bit-equal (f32 within rtol: {near1}); launches {launches}")
    REPORT["hier512"] = {"init_s": t_init, "timings": timings,
                         "run_s": t_run, "launches": launches,
                         "near": near0 + near1}
    del world, end
    torch.cuda.empty_cache()


def config5_kernels(HE, engine, cfg, world, es) -> dict:
    """K2, K3 and K4 on the config #5 world's own inputs against their
    plain versions; medians, device times and bounds."""
    g = world.grid
    H, W = cfg.HEIGHT, cfg.WIDTH
    HW = H * W
    present = (es.pa & 1) == 1
    density = engine.density_map(present, g.is_road,
                                 cfg.VEHICLE_AWARENESS_RANGE)
    soft2, hard = engine.soft_penalties(cfg, es.pa, es.stop_map, density)
    legal4, pen4 = engine.entry_costs(cfg, g.allowed_dirs, g.is_road, soft2,
                                      hard)
    legal4, pen4 = legal4.contiguous(), pen4.contiguous()
    tp2 = int(round(2 * cfg.VEHICLE_TURN_PENALTY))
    K0 = world.cost_field
    D = K0.shape[0]
    D4 = (D + 3) // 4
    occ = present.to(torch.int32)
    from trafficsimulation_tpu_torch.ops import render as R
    k8_args = (g.cell_type, world.stop_map, world.rain_map,
               R.vehicle_classes(world.vehicles, H, W))

    def cumsums():
        return (torch.cumsum(occ, -1, dtype=torch.int32),
                torch.cumsum(occ, -2, dtype=torch.int32))
    cases = {
        "build_sdir": (lambda: (HE.build_sdir(K0, pen4, legal4, tp2),),
                       lambda: (HE.sdir_encode(K0, pen4, legal4, tp2),),
                       D * 4 * HW * 4 + 8 * HW * 4 + D4 * HW * 4,
                       (D * HW * SDIR_ALU_OPS, D * HW * SDIR_OPS),
                       f"K0 [{D}, 4, {H}, {W}]", None),
        "build_wavefront": (
            lambda: (HE.build_wavefront(cfg, g.allowed_dirs, g.is_road,
                                        hard),),
            lambda: (HE.wavefront_core(cfg, g.allowed_dirs, g.is_road,
                                       hard),),
            HW * 7,
            (HW * 32 * cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS,) * 2,
            f"[{H}, {W}]", None),
        "prefix_planes": (lambda: HE.prefix_planes(occ),
                          lambda: HE.prefix_planes_plain(occ), HW * 12,
                          (0, HW * 2), f"[{H}, {W}]", cumsums),
        # K8 on the world's state (on no path): 7 bytes a pixel, as in
        # phase_render
        "render": (lambda: (R.render_planes(*k8_args),),
                   lambda: (R.render_planes_plain(*k8_args),), HW * 7,
                   HW * 15, f"[3, {H}, {W}]", None),
    }
    return {name: measure(f"{name} at config #5", kern, plain, nbytes, ops,
                          shape, lib, reps=10)
            for name, (kern, plain, nbytes, ops, shape, lib)
            in cases.items()}


def phase_config5(HE, engine, tsim, card, prng, Config):
    """BASELINE config #5 at full size on the card: build, 20 ticks with
    the launch counts of the path, then 20 timed ticks and an idle-share
    window."""
    cfg = Config(**CONFIG5)
    timings = {}
    t0 = time.perf_counter()
    cfg3, world = tsim.init_world_hier(cfg, prng.PRNGKey(0), "cuda",
                                       timings)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    world, t_inj = timed(lambda: tsim.inject_vehicles(cfg3, world,
                                                      CONFIG5_VEHICLES))
    CONFIG5_START["world"] = (cfg3, world, t_build)
    n0 = int(world.vehicles.active.sum())
    bs = world.blocks_static
    unroutable = int((bs.valid & (bs.dest < 0)).sum())
    log(f"config #5 built on the card in {t_build:.2f} s (stages "
        f"{ {k: round(v, 2) for k, v in timings.items()} }); "
        f"{cfg3.MAX_FIELD_DESTS} dense rows, local stack "
        f"{tuple(world.local_sdir4.shape)}, {int(world.dests.valid.sum())} "
        f"destinations, {unroutable} unroutable blocks; {n0} vehicles "
        f"injected in {t_inj:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if n0 != CONFIG5_VEHICLES or unroutable:
        raise AssertionError(f"config #5: {n0} vehicles, {unroutable} "
                             "unroutable blocks")
    HE.reset_launches()
    with no_plain_core(HE):
        w20, t20 = timed(lambda: tsim.run_chunk(cfg3, world, N_HIER_TICKS))
        launches = dict(HE.launches)
        check_launches("config #5 path", launches,
                       hier_launches(cfg3, N_HIER_TICKS))
        w40, t_timed = timed(lambda: tsim.run_chunk(cfg3, w20,
                                                    N_HIER_TICKS))
        sps = N_HIER_TICKS / t_timed
        active = int(w40.vehicles.active.sum())
        n_prof = 10
        _, wall = timed(lambda: tsim.run_chunk(cfg3, w40, n_prof))
        busy, per_tick, top = profile_ticks(
            lambda: tsim.run_chunk(cfg3, w40, n_prof), n_prof)
    wall_ms = wall * 1e3 / n_prof
    idle = 1 - busy / wall_ms
    log("config #5 device time per tick by kernel (top 8; name, ms, "
        "launches): " + json.dumps([(k, round(m, 4), round(c, 1))
                                    for k, m, c in top]))
    moved = int((w40.vehicles.pos != world.vehicles.pos).sum())
    if not bool(torch.isfinite(w40.density).all()) or moved == 0:
        raise AssertionError(f"config #5: non-finite density or no vehicle "
                             f"moved ({moved})")
    segs = -(-N_HIER_TICKS // cfg3.PATHFINDING_COOLDOWN)
    log(f"config #5 ({card}): run_chunk({N_HIER_TICKS}) in {t20:.3f} s, "
        f"launches {launches} (per tick: K1-hier "
        f"{launches['decide_move'] / N_HIER_TICKS:g}, K6 "
        f"{launches['select_rows'] / N_HIER_TICKS:g}, K4 "
        f"{launches['prefix_planes'] / N_HIER_TICKS:g}; per routing segment: "
        f"K2 {launches['build_sdir'] / segs:g}, K3 "
        f"{launches['build_wavefront'] / segs:g}); {N_HIER_TICKS} more ticks "
        f"in {t_timed:.3f} s "
        f"= {sps:.2f} steps/s = {sps * cfg3.HEIGHT * cfg3.WIDTH:.4g} "
        f"cell-updates/s; {active} active vehicles, {moved} moved since "
        f"injection; over {n_prof} ticks wall {wall_ms:.3f} ms/tick, device "
        f"busy {busy:.3f} ms/tick in {per_tick:.0f} launches, idle share "
        f"{idle:.3f}")
    es = tsim._enter_engine(cfg3, w40)
    kern = {"decide_move": k1_hier_tick(cfg3, world, HE, tsim)}
    kern.update(config5_k6(cfg3, w20, HE, tsim))
    kern.update(config5_kernels(HE, engine, cfg3, w40, es))
    kern["ordered_add"] = ordered_add_tick(cfg3, w40, HE, tsim,
                                           "config #5")
    # the framebuffer as the JAX bench times it: one warm-up, then the
    # mean of 5 synchronized frames
    sim5 = tsim.TrafficSim.from_world(cfg3, w40)
    fb, _ = timed(sim5.render)
    t0 = time.perf_counter()
    for _ in range(5):
        fb = sim5.render()
        torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) / 5 * 1e3
    if tuple(fb.shape) != (cfg3.HEIGHT, cfg3.WIDTH, 3) or \
            fb.dtype != torch.uint8:
        raise AssertionError(f"config #5 frame {fb.dtype} {tuple(fb.shape)}")
    log(f"config #5 framebuffer ({card}): render_frame at "
        f"{cfg3.HEIGHT}x{cfg3.WIDTH} {render_ms:.3f} ms (mean of 5)")
    del fb, sim5
    REPORT["config5"] = {
        "card": card, "build_s": t_build, "timings": timings,
        "inject_s": t_inj, "dense_rows": cfg3.MAX_FIELD_DESTS,
        "local_words": int(world.local_sdir4.shape[0]),
        "first_ticks_s": t20, "ticks": N_HIER_TICKS, "timed_s": t_timed,
        "steps_per_s": sps,
        "cell_updates_per_s": sps * cfg3.HEIGHT * cfg3.WIDTH,
        "active_vehicles": active, "wall_ms_per_tick": wall_ms,
        "busy_ms_per_tick": busy, "idle_share": idle, "launches": launches,
        "device_launches_per_tick": per_tick, "top_kernels": top,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "render_ms": render_ms, "kernels": kern}
    return launches, kern


def k1_world_inputs(engine, B, H, W, D, r):
    """K1's seeded random arguments after the config for B worlds of
    H x W, each world with its own geometry and stack of D rows (D a
    multiple of 4), drawn from `r` (an Inputs)."""
    D4 = D // 4
    # the stacks of all worlds packed at once: D is a multiple of 4, so
    # word g of the [B * D] rows is word g % D4 of world g // D4
    sdir4 = engine.pack_sdir4(r.rint(0, 256, B * D, H, W).to(
        torch.uint8)).reshape(B, D4, H, W)
    wb = r.rint(0, 16, B, 4, H, W)
    wnd = wb[:, 0] | (wb[:, 1] << 8) | (wb[:, 2] << 16) | (wb[:, 3] << 24)
    del wb
    planes = tuple(r.bits(B, H, W) for _ in range(5)) + (r.unif(B, H, W),)
    masks = (r.bern(0.15, B, H, W), r.bern(0.1, B, H, W),
             r.bern(0.02, B, H, W))
    inter = r.bern(0.1, B, H, W)
    dest = r.rint(-1, D, B, H, W)
    randoms = (r.unif(B, H, W), r.unif(B, H, W), r.rint(1, 6, B, H, W),
               r.bits(B, H, W))
    return (sdir4, wnd, planes, *masks, inter, dest, randoms)


def config4_k1(HE, engine, kcfg, B, H, W, D, r, forms, heavy):
    """K1's forms (`forms`: row name -> form, None for `k1_form`'s
    choice) for B worlds of H x W on seeded random inputs, each world with
    its own geometry, against the plain version."""
    a = k1_world_inputs(engine, B, H, W, D, r)
    k1_bytes, k1_ops = k1_cost(a[2], kcfg)
    shape = f"B = {B}, {H}x{W}, D = {D}"
    out = {}
    for name, form in forms.items():
        out[name] = measure(
            f"{name} (B={B}, {H}x{W})",
            lambda f=form: HE.decide_move_batched(kcfg, *a, form=f),
            lambda: HE.decide_move_core_batched(kcfg, *a),
            k1_bytes, k1_ops, shape, **heavy)
    return out


def config4_kernels(HE, engine, cfg, B) -> dict:
    """K1 (in both forms), K2 and K3's per-world-geometry forms for B
    worlds at config #4's shapes (seeded random inputs, each world with
    its own geometry and key stack) against their plain versions."""
    H, W, D = cfg.HEIGHT, cfg.WIDTH, cfg.MAX_FIELD_DESTS
    HW = H * W
    D4 = (D + 3) // 4
    if D % 4:
        raise AssertionError("config #4's stack packs whole words")
    r = Inputs(4)
    shape = f"B = {B}, {H}x{W}, D = {D}"
    heavy = dict(reps=10, plain_reps=1 if B > 16 else 3)
    kcfg = cfg.replace(VEHICLE_MALFUNCTION_CHANCE=0.01,
                       VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    # the block-per-world form at B = 3 too, where the shape chooses the
    # cooperative form
    out = config4_k1(HE, engine, kcfg, B, H, W, D, r, {
        "decide_move_blocks": "worlds", "decide_move_worlds": "coop"},
        heavy)

    # K2 over B key stacks, each with unreachable rows; the bytes: every
    # world's K0, pen and legal planes in, its packed stack out
    q = r.rint(0, 60000, B, D, 4, H, W)
    q = torch.where(r.bern(0.15, B, D, 4, H, W), 65535, q)
    K0 = engine.costs_u16_to_keys(q)
    del q
    pen4 = torch.where(r.bern(0.1, B, 4, H, W), 1 << 17,
                       r.rint(0, 3000, B, 4, H, W))
    legal4 = r.bern(0.6, B, 4, H, W).to(torch.int32)
    tp2 = int(round(2 * cfg.VEHICLE_TURN_PENALTY))
    sd_bytes = B * (D * 4 * HW * 4 + 2 * 4 * HW * 4 + D4 * HW * 4)
    sd_ops = (D * HW * B * SDIR_ALU_OPS, D * HW * B * SDIR_OPS)
    out["build_sdir_stacks"] = measure(
        f"build_sdir_stacks (B={B})",
        lambda: (HE.build_sdir_stacks(K0, pen4, legal4, tp2),),
        lambda: (HE.sdir_encode_batched(K0, pen4, legal4, tp2),),
        sd_bytes, sd_ops, shape, **heavy)
    del K0, pen4, legal4

    # K3 with allowed and road one plane a world
    allowed = r.rint(0, 16, B, H, W).to(torch.uint8)
    road = r.bern(0.5, B, H, W)
    hard = r.bern(0.1, B, H, W) & road
    k3_bytes = B * HW * (2 + 5)
    k3_ops = (B * HW * 4 * 4 * 2
              * cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS,) * 2
    out["build_wavefront_worlds"] = measure(
        f"build_wavefront_worlds (B={B})",
        lambda: (HE.build_wavefront_batched(cfg, allowed, road, hard),),
        lambda: (HE.wavefront_core_batched(cfg, allowed, road, hard),),
        k3_bytes, k3_ops, shape, **heavy)
    torch.cuda.empty_cache()
    return out


def config4_path_k1(HE, cfg, world, mesh) -> dict:
    """K1 on config #4's own state: its arguments of the next tick of
    `world` (the batch of cities), captured from a one-tick
    `run_chunk_batch`, in the shape's form (the block-per-world form)
    and the cooperative form, each against the plain version."""
    seen = []
    orig = HE.decide_move_batched

    def spy(*a, **k):
        seen.append(a)
        return orig(*a, **k)
    HE.decide_move_batched = spy
    try:
        mesh.run_chunk_batch(cfg, world, 1)
    finally:
        HE.decide_move_batched = orig
    if len(seen) != 1:
        raise AssertionError(f"one tick called K1 {len(seen)} times")
    a = seen[0]
    nbytes, ops = k1_cost(a[3], a[0])
    tick = int(world.tick.reshape(-1)[0]) + 1
    shape = (f"config #4's path, tick {tick}, B = {a[3][0].shape[0]}, "
             f"{int((a[3][0] & 1).sum())} vehicles")
    out = {}
    for name, form in (("decide_move_blocks", None),
                       ("decide_move_worlds", "coop")):
        out[name] = measure(
            f"{name} on config #4's path", lambda f=form: orig(*a, form=f),
            lambda: HE.decide_move_core_batched(*a), nbytes, ops, shape,
            reps=10, plain_reps=1)
    return out


def phase_forms(HE, engine, tsim, mesh, prng, Config) -> dict:
    """Development group `forms`: K1's forms and the pedestrian step
    timed on the imported tree (`--tree`; an older tree without K1's
    `form` argument runs its one form, the cooperative per-world one, and
    one without the cached sidewalk count its step without it).  K1 at
    config #4's 64 x 64 worlds with D = 32, for each B of K1_SWEEP, on
    seeded planes (`k1_world_inputs`, Inputs(4)) and on the path's own
    state, the first B worlds' arguments of tick 51 of config #4's batch
    of cities; the pedestrian step on seeded planes at 256^2 and 1024^2
    (`ped_inputs`, Inputs(11)) and on config #3's inputs of tick 501
    (seed 0, SWEEP_VEHICLES vehicles); every row bit-equal to its plain
    version (`measure`)."""
    import inspect
    from trafficsimulation_tpu_torch import codes as C
    from trafficsimulation_tpu_torch.agents import pedestrians
    has_form = "form" in inspect.signature(HE.decide_move_batched).parameters
    has_side = "n_side" in inspect.signature(HE.step_pedestrians).parameters
    forms = ({"decide_move_blocks": "worlds", "decide_move_worlds": "coop"}
             if has_form else {"decide_move_worlds": None})
    cfg = Config(**CONFIG4)
    kcfg = cfg.replace(VEHICLE_MALFUNCTION_CHANCE=0.01,
                       VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3)
    H, W, D = cfg.HEIGHT, cfg.WIDTH, cfg.MAX_FIELD_DESTS

    def k1_rows(label, kc, a):
        nbytes, ops = k1_cost(a[2], kc)
        B = a[2][0].shape[0]
        shape = (f"{label}, B = {B}, {H}x{W}, {int((a[2][0] & 1).sum())} "
                 "vehicles")
        return {name: measure(
            f"{name} ({label}, B={B})",
            lambda f=form: HE.decide_move_batched(
                kc, *a, **({} if f is None else {"form": f})),
            lambda: HE.decide_move_core_batched(kc, *a), nbytes, ops, shape,
            reps=20, plain_reps=1) for name, form in forms.items()}

    out = {"forms": list(forms), "k1_plan": {}, "k1_seeded": {},
           "k1_path": {}, "ped": {}}
    for B in K1_SWEEP:
        out["k1_plan"][B] = {name: HE.dm_plan(B, H, W, **(
            {} if f is None else {"form": f})) for name, f in forms.items()}
        a = k1_world_inputs(engine, B, H, W, D, Inputs(4))
        out["k1_seeded"][B] = k1_rows("seeded", kcfg, a)
        del a
    world = mesh.init_world_batch(cfg, prng.PRNGKey(0), max(K1_SWEEP))
    world = mesh.run_chunk_batch(cfg, world, CONFIG4_TICKS)
    seen = []
    orig = HE.decide_move_batched

    def spy(*a, **k):
        seen.append(a)
        return orig(*a, **k)
    HE.decide_move_batched = spy
    try:
        mesh.run_chunk_batch(cfg, world, 1)
    finally:
        HE.decide_move_batched = orig
    pcfg, *pargs = seen[0]
    label = f"config #4's path, tick {CONFIG4_TICKS + 1}"
    for B in K1_SWEEP:
        a = tuple(tuple(x[:B] for x in t) if isinstance(t, tuple)
                  else t[:B] for t in pargs)
        out["k1_path"][B] = k1_rows(label, pcfg, a)
    del world, seen, pargs, a
    torch.cuda.empty_cache()

    def ped_row(label, a):
        nbytes, ops = ped_cost(a[1], a[3], 1)
        out["ped"][label] = measure(
            f"step_pedestrians ({label})", lambda: HE.step_pedestrians(*a),
            lambda: pedestrians.step_pedestrians_plain(*a[:6]), nbytes, ops,
            label, plain_reps=3, one_kernel=has_side)

    r = Inputs(11)
    for n in (256, 1024):
        pc = Config(WIDTH=n, HEIGHT=n, PEDESTRIANS_ENABLED=True,
                    PEDESTRIANS_PER_DAY=2_000_000)
        walk, cross, cell, stop, seeds = ped_inputs(r, 1, n, n, 40)
        side = ((cell == C.SIDEWALK).sum(dtype=torch.int32),) if has_side \
            else ()
        ped_row(f"{n}x{n}", (pc, walk[0], cross[0], cell, stop[0], seeds[0],
                             *side))
    base = Config(**CONFIG3)
    world = tsim.init_world(base, prng.PRNGKey(0), "cuda")
    cfg3, world = tsim.measure_and_shrink(base, world)
    world = tsim.inject_vehicles(cfg3, world, SWEEP_VEHICLES)
    with mega_env(False):
        world = tsim.run_chunk(cfg3, world, SWEEP_PED_TICKS)
    a, _ = tick_inputs(cfg3, world, HE, tsim, "step_pedestrians")
    ped_row(f"config #3's path, tick {SWEEP_PED_TICKS + 1}, "
            f"{int(a[1].sum() + a[2].sum())} pedestrians", a)
    REPORT["forms"] = out
    return out


def cap_diagnostics(world) -> dict:
    """The JAX bench's no-silent-caps counters (`bench._cap_diagnostics`)
    over a batch of cities."""
    bs = world.blocks_static
    DF = world.cost_field.shape[-4]
    unroutable = bs.valid & ((bs.dest < 0) | (bs.dest >= DF))
    m = world.metrics
    act = world.vehicles.active
    dv = world.dests.valid
    return {
        "field_rows": int(DF),
        "n_valid_dests_max_per_world": int(
            dv.reshape(-1, dv.shape[-1]).sum(-1).max()),
        "blocks_unroutable_no_field": int(unroutable.sum()),
        "worlds_with_unroutable_blocks": int(
            unroutable.reshape(-1, unroutable.shape[-1]).any(-1).sum()),
        "vehicle_pool": int(act.shape[-1]),
        "pool_peak_active": int(act.sum(-1).max()),
        "errored_dropped_or_stuck": int(m.errored_internal.sum()
                                        + m.errored_through.sum())}


def phase_config4(HE, engine, tsim, mesh, transfer, card, prng, Config):
    """BASELINE config #4 on the card: 1024 cities of 64^2 generated as
    one batch, held to the JAX digest at init and after the first 50
    ticks, the launch counts of the path, then timed chunks and the
    kernels' per-world forms."""
    cfg = Config(**CONFIG4)
    n, HW = CONFIG4_WORLDS, cfg.HEIGHT * cfg.WIDTH
    with open(os.path.join(ROOT, CONFIG4_DIGEST)) as f:
        digest = json.load(f)
    plan = HE.dm_plan(n, cfg.HEIGHT, cfg.WIDTH)
    sms, smem = HE.card_numbers()
    log(f"config #4: K1's form for {n} worlds of {cfg.HEIGHT}x{cfg.WIDTH} "
        f"on {sms} SMs and {smem} bytes of shared memory a block: "
        f"{plan['form']}; plan {plan}; the cooperative form's "
        f"{HE.dm_plan(n, cfg.HEIGHT, cfg.WIDTH, form='coop')}")
    if plan["form"] != "worlds" or plan["blocks_per_sm"] < 2:
        raise AssertionError(f"config #4: K1's plan {plan}, not the "
                             "block-per-world form at >= 2 blocks an SM")
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    worlds, t_gen = timed(lambda: mesh.init_world_batch(
        cfg, prng.PRNGKey(0), n, timings=timings))
    log(f"config #4 ({card}): {n} worlds generated on the card in "
        f"{t_gen:.2f} s, generate_all_sec {timings['generate_all_sec']:.2f} "
        f"(stages {({k: round(v, 3) for k, v in timings.items()})}); "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for b in range(digest["worlds"]):
        exact, near = check_digest(
            f"config #4 world {b} at init", digest["init"][b],
            transfer.world_to_numpy(mesh.world_at(worlds, b)))
    log(f"config #4 worlds 0-{digest['worlds'] - 1} at init equal JAX's "
        f"digest ({exact} leaves each, {len(near)} f32 within rtol)")
    R = max(1, cfg.PATHFINDING_COOLDOWN)
    segs = -(-CONFIG4_TICKS // R)
    need = {"decide_move_blocks": CONFIG4_TICKS, "decide_move": 0,
            "prefix_planes": CONFIG4_TICKS,
            "build_sdir": segs, "build_wavefront": segs,
            "build_sdir_batched": 0, "select_rows": 0, "mega": 0,
            "mega_worlds": 0,
            "rain_ticks": CONFIG4_TICKS if cfg.RAIN_ENABLED else 0}
    HE.reset_launches()
    with no_plain_core(HE):
        w, t_first = timed(lambda: mesh.run_chunk_batch(cfg, worlds,
                                                        CONFIG4_TICKS))
    launches = dict(HE.launches)
    check_launches("config #4 path", launches, need)
    for b in range(digest["worlds"]):
        check_digest(f"config #4 world {b} after {CONFIG4_TICKS} ticks",
                     digest[f"chunk{CONFIG4_TICKS}"][b],
                     transfer.world_to_numpy(mesh.world_at(w, b)))
    active = [int(a) for a in w.vehicles.active.sum(-1)]
    if active[:digest["worlds"]] != digest[f"chunk{CONFIG4_TICKS}_active"]:
        raise AssertionError(f"config #4 active vehicles {active[:4]}")
    keep_ref("config4_per_tick", w, launches, mesh)
    log(f"config #4 worlds 0-{digest['worlds'] - 1} after {CONFIG4_TICKS} "
        f"ticks equal JAX's digest; first chunk {t_first:.3f} s; launches "
        f"{launches} (K1 {launches['decide_move_blocks'] / CONFIG4_TICKS:g} "
        f"a tick for all {n} worlds, one block a world, K2 and K3 "
        f"{launches['build_sdir'] / segs:g} and "
        f"{launches['build_wavefront'] / segs:g} a segment, no per-world "
        f"map); {sum(active)} active vehicles")
    del worlds
    # K1 on the path's own state: its inputs of the next tick, in both
    # forms, against the plain version
    path = config4_path_k1(HE, cfg, w, mesh)
    # the kernels before the long profile below (a profile after a long
    # one may come back empty)
    kern = {f"B={b}": config4_kernels(HE, engine, cfg, b)
            for b in (n, CONFIG4_ODD_B)}
    kern["path"] = path
    rh, rw = CONFIG4_RAGGED
    if HE.k1_form(n, rh, rw, *HE.card_numbers()) != "worlds":
        raise AssertionError(f"K1's form at {n} x {rh}x{rw} is not the "
                             "block-per-world form")
    kern["ragged"] = config4_k1(
        HE, engine, cfg.replace(WIDTH=rw, HEIGHT=rh,
                                VEHICLE_MALFUNCTION_CHANCE=0.01,
                                VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3),
        n, rh, rw, cfg.MAX_FIELD_DESTS, Inputs(5),
        {"decide_move_blocks": None}, dict(reps=10, plain_reps=1))
    torch.cuda.empty_cache()
    times = []
    for _ in range(CONFIG4_REPEATS):
        w, dt = timed(lambda w=w: mesh.run_chunk_batch(cfg, w,
                                                       CONFIG4_TICKS))
        times.append(dt)
    dt = statistics.median(times)
    sps = CONFIG4_TICKS / dt
    cups = n * HW * sps
    busy, per_tick, top = profile_ticks(
        lambda: mesh.run_chunk_batch(cfg, w, CONFIG4_TICKS), CONFIG4_TICKS)
    wall_ms = dt * 1e3 / CONFIG4_TICKS
    idle = 1 - busy / wall_ms
    caps = cap_diagnostics(w)
    log("config #4 device time per tick by kernel (top 8; name, ms, "
        "launches): " + json.dumps([(k, round(m, 4), round(c, 1))
                                    for k, m, c in top]))
    log(f"config #4 ({card}): {CONFIG4_REPEATS} timed chunks of "
        f"{CONFIG4_TICKS} ticks {[round(t, 3) for t in times]} s, median "
        f"{dt:.3f} s = {sps:.2f} steps/s per world = {cups:.4g} "
        f"cell-updates/s ({n} x {HW} cells); wall {wall_ms:.3f} ms/tick, "
        f"device busy {busy:.3f} ms/tick in {per_tick:.1f} launches, idle "
        f"share {idle:.3f}; caps {caps}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not bool(torch.isfinite(w.density).all()):
        raise AssertionError("config #4: non-finite density")
    del w
    torch.cuda.empty_cache()
    REPORT["config4"] = {
        "card": card, "worlds": n, "generate_s": t_gen, "timings": timings,
        "k1_plan": plan, "first_chunk_s": t_first, "launches": launches,
        "chunk_s": times, "steps_per_s_per_world": sps,
        "cell_updates_per_s": cups, "wall_ms_per_tick": wall_ms,
        "busy_ms_per_tick": busy, "idle_share": idle,
        "device_launches_per_tick": per_tick, "top_kernels": top,
        "caps": caps, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "kernels": kern}
    return launches, kern


def ped_cost(walk, cell_type, B: int):
    """(bytes, ops) of one pedestrian tick of B worlds: eight count
    planes in and out, the stop map, ped_block and ped_count per world,
    cell_type once a geometry plane; per cell and world its 14 hashed
    uniforms (7 shifts and xors on the ALU pipe only, 11 ops in all)."""
    HW = walk.shape[-1] * walk.shape[-2]
    nbytes = B * HW * (4 * 4 * 4 + 1 + 1 + 4) + cell_type.numel()
    return nbytes, (B * HW * 14 * 7, B * HW * 14 * 11)


def ped_inputs(r, B, H, W, hi, per_world=False):
    """Random cell codes (sidewalks the most common), stop maps, counts
    of 0..hi and u32 seeds for B worlds on the card."""
    codes = torch.tensor((2, 2, 2, 17, 15, 16, 9, 10, 11, 12, 0, 1),
                         dtype=torch.uint8, device="cuda")
    cell = codes[r.rint(0, 12, *((B,) if per_world else ()), H, W).long()]
    return (r.rint(0, hi, B, 4, H, W), r.rint(0, hi, B, 4, H, W), cell,
            r.bern(0.5, B, H, W),
            r.bits(B, 14).to(torch.int64) & 0xFFFFFFFF)


def phase_pedestrians(HE) -> dict:
    """`step_pedestrians` (no TPU kernel) against its plain version on
    seeded random inputs: one world at 256^2 and 1024^2, a ragged 37 x 300
    grid with counts up to 2000 a cell (every fractional split rounds),
    and B = 3 worlds each with its own cell_type."""
    from trafficsimulation_tpu_torch.agents.pedestrians import \
        step_pedestrians_plain
    from trafficsimulation_tpu_torch.config import Config
    from trafficsimulation_tpu_torch.core.state import sidewalk_count
    r = Inputs(11)
    out = {}
    for label, B, H, W, hi, per_world in (
            ("256x256", 1, 256, 256, 40, False),
            ("1024x1024", 1, 1024, 1024, 40, False),
            ("37x300, counts to 2000", 1, 37, 300, 2000, False),
            ("B = 3 per-world, 256x256", 3, 256, 256, 40, True)):
        cfg = Config(WIDTH=W, HEIGHT=H, PEDESTRIANS_ENABLED=True,
                     PEDESTRIANS_PER_DAY=2_000_000)
        walk, cross, cell, stop, seeds = ped_inputs(r, B, H, W, hi,
                                                    per_world)
        n_side = sidewalk_count(cell)
        nbytes, ops = ped_cost(walk, cell, B)
        if B == 1:
            a = (walk[0], cross[0], cell, stop[0], seeds[0])
            kern = lambda a=a, c=cfg, n=n_side: HE.step_pedestrians(c, *a,
                                                                     n)
            plain = lambda a=a, c=cfg: step_pedestrians_plain(c, *a)
        else:
            a = (walk, cross, cell, stop, seeds)
            kern = lambda a=a, c=cfg, n=n_side: HE.step_pedestrians_batched(
                c, *a, n)
            plain = lambda a=a, c=cfg: tuple(torch.stack(o) for o in zip(*(
                step_pedestrians_plain(c, *(x[b] for x in a))
                for b in range(B))))
        n0 = HE.launches["step_pedestrians"]
        kern()
        if HE.launches["step_pedestrians"] != n0 + 1:
            raise AssertionError("step_pedestrians: not one launch a call")
        out[label] = measure(f"step_pedestrians ({label})", kern, plain,
                             nbytes, ops, label, plain_reps=3)
        del walk, cross, cell, stop, seeds, a
    torch.cuda.empty_cache()
    return out


def config3_world(tsim, prng, Config):
    """(cfg, world): BASELINE config #3 as the bench builds it, from the
    digest's seed, shrunk, with its vehicles injected."""
    with open(os.path.join(ROOT, PED_DIGEST)) as f:
        dig = json.load(f)["config3"]
    base = Config(**CONFIG3)
    world = tsim.init_world(base, prng.PRNGKey(dig["seed"]), "cuda")
    cfg, world = tsim.measure_and_shrink(base, world)
    return cfg, tsim.inject_vehicles(cfg, world, dig["n_vehicles"])


def phase_config3(HE, tsim, transfer, card, prng, Config):
    """BASELINE config #3 on the card: the world generated as the bench
    builds it, held to the JAX digest at init and after 100 and 200 ticks
    (every leaf, the pedestrian planes and ped_map among them), the
    launch counts of the path (one `step_pedestrians` a tick, no plain
    step, no per-world map), then timed chunks of 100 ticks and the
    pedestrian step on its inputs of a tick of that run."""
    from trafficsimulation_tpu_torch import codes as C
    from trafficsimulation_tpu_torch.agents import pedestrians
    with open(os.path.join(ROOT, PED_DIGEST)) as f:
        dig = json.load(f)["config3"]
    n = dig["chunk"]
    (cfg, world), t_gen = timed(lambda: config3_world(tsim, prng, Config))
    CONFIG3_START["world"] = (cfg, world)
    for k, v in dig["cfg"].items():
        want = (tuple(tuple(p) for p in v) if k == "CAP_OVERRIDES" else v)
        if getattr(cfg, k) != want:
            raise AssertionError(f"config #3 {k}: {getattr(cfg, k)} vs "
                                 f"JAX's {want}")
    ex, near = check_digest("config #3 at init", dig["init"],
                            transfer.world_to_numpy(world))
    R = max(1, cfg.PATHFINDING_COOLDOWN)
    need = {"step_pedestrians": n, "decide_move": n, "prefix_planes": n,
            "build_sdir": -(-n // R), "build_wavefront": -(-n // R),
            "build_sdir_batched": 0, "select_rows": 0, "mega": 0,
            "mega_worlds": 0,
            "decide_move_blocks": 0,
            "rain_ticks": n if cfg.RAIN_ENABLED else 0}
    orig_plain = pedestrians.step_pedestrians_plain

    def no_plain(*a, **k):
        raise AssertionError("the plain pedestrian step ran on a card path")
    HE.reset_launches()
    pedestrians.step_pedestrians_plain = no_plain
    try:
        with mega_env(False), no_plain_core(HE):
            w, t_first = timed(lambda: tsim.run_chunk(cfg, world, n))
    finally:
        pedestrians.step_pedestrians_plain = orig_plain
    launches = dict(HE.launches)
    check_launches("config #3 path", launches, need)
    counts = []
    for t in (n, 2 * n):
        if t > n:
            with mega_env(False):
                w = tsim.run_chunk(cfg, w, n)
        check_digest(f"config #3 after {t} ticks", dig[f"tick{t}"],
                     transfer.world_to_numpy(w))
        peds = int(w.peds.walk.sum() + w.peds.cross.sum())
        if peds != dig[f"counts{t}"]["active_pedestrians"]:
            raise AssertionError(f"config #3: {peds} pedestrians at {t}")
        counts.append(peds)
    log(f"config #3 ({card}): generated on the card in {t_gen:.2f} s, "
        f"init {ex}/{len(dig['init'])} leaves bit-equal to JAX's digest "
        f"(f32 within rtol: {near}); after {n} and {2 * n} ticks every leaf "
        f"equals JAX's (pedestrians {counts}); first chunk {t_first:.3f} s, "
        f"launches {launches} (step_pedestrians "
        f"{launches['step_pedestrians'] / n:g} a tick, no plain step, no "
        f"per-world map)")
    times = []
    with mega_env(False):
        for _ in range(CONFIG3_REPEATS):
            w, dt = timed(lambda w=w: tsim.run_chunk(cfg, w, n))
            times.append(dt)
        dt = statistics.median(times)
        busy, per_tick, top = profile_ticks(
            lambda: tsim.run_chunk(cfg, w, N_PROFILE_TICKS), N_PROFILE_TICKS)
    sps = n / dt
    HW = cfg.HEIGHT * cfg.WIDTH
    wall_ms = dt * 1e3 / n
    idle = 1 - busy / wall_ms
    lam = float(pedestrians.spawn_rate(cfg))
    caps = cap_diagnostics(w)
    peds = int(w.peds.walk.sum() + w.peds.cross.sum())
    active = int(w.vehicles.active.sum())
    log("config #3 device time per tick by kernel (top 8; name, ms, "
        "launches): " + json.dumps([(k, round(m, 4), round(c, 1))
                                    for k, m, c in top]))
    log(f"config #3 ({card}): {CONFIG3_REPEATS} timed chunks of {n} ticks "
        f"{[round(t, 3) for t in times]} s, median {dt:.3f} s = {sps:.2f} "
        f"steps/s = {sps * HW:.4g} cell-updates/s; wall {wall_ms:.3f} "
        f"ms/tick, device busy {busy:.3f} ms/tick in {per_tick:.1f} "
        f"launches, idle share {idle:.3f}; active pedestrians {peds}, "
        f"expected spawns a tick {lam:.4f}, active vehicles {active}; "
        f"caps {caps}")
    # the step on its inputs of the tick after the timed chunks (the
    # wrapper given the world's cached sidewalk count, the plain version
    # counting the sidewalks itself)
    (a, _) = tick_inputs(cfg, w, HE, tsim, "step_pedestrians")
    if int(a[6]) != int((a[3] == C.SIDEWALK).sum()):
        raise AssertionError(f"config #3: cached sidewalk count {int(a[6])}")
    nbytes, ops = ped_cost(a[1], a[3], 1)
    kern = measure("step_pedestrians on config #3's path",
                   lambda: HE.step_pedestrians(*a),
                   lambda: pedestrians.step_pedestrians_plain(*a[:6]),
                   nbytes, ops, f"256x256, tick {int(w.tick)}, "
                   f"{int(a[1].sum() + a[2].sum())} pedestrians",
                   plain_reps=5)
    REPORT["config3"] = {
        "card": card, "generate_s": t_gen, "first_chunk_s": t_first,
        "launches": launches, "chunk_s": times, "steps_per_s": sps,
        "cell_updates_per_s": sps * HW, "wall_ms_per_tick": wall_ms,
        "busy_ms_per_tick": busy, "idle_share": idle,
        "device_launches_per_tick": per_tick, "top_kernels": top,
        "active_pedestrians": peds, "expected_ped_spawns_per_tick": lam,
        "active_vehicles": active, "caps": caps, "kernel": kern}
    del world, w
    torch.cuda.empty_cache()
    return launches, kern


def phase_config1(HE, tsim, transfer, card, prng, Config):
    """BASELINE config #1 on the card as the bench runs it: generation
    (seeds 1-3 timed after a warm seed 0), every seed held to the JAX
    digest at init; seed 0 after 200 ticks held to the digest; then 200
    ticks of light cycling timed from there, with the launches and device
    time a tick."""
    with open(os.path.join(ROOT, PED_DIGEST)) as f:
        dig = json.load(f)["config1"]
    cfg = Config(**CONFIG1)
    n = dig["ticks"]
    worlds = [tsim.init_world(cfg, prng.PRNGKey(0), "cuda")]
    t_gen = []
    for s in range(1, len(dig["init"])):
        w, dt = timed(lambda s=s: tsim.init_world(cfg, prng.PRNGKey(s),
                                                  "cuda"))
        worlds.append(w)
        t_gen.append(dt)
    gen_ms = statistics.mean(t_gen) * 1e3
    for s, w in enumerate(worlds):
        check_digest(f"config #1 seed {s} at init", dig["init"][s],
                     transfer.world_to_numpy(w))
    HE.reset_launches()
    with mega_env(False), no_plain_core(HE):
        w, t_first = timed(lambda: tsim.run_chunk(cfg, worlds[0], n))
    launches = dict(HE.launches)
    check_launches("config #1 path", launches, {
        "decide_move": n, "prefix_planes": n, "step_pedestrians": 0,
        "mega": 0,
        "mega_worlds": 0, "rain_ticks": n if cfg.RAIN_ENABLED else 0,
        "decide_move_blocks": 0})
    check_digest(f"config #1 after {n} ticks", dig["end"],
                 transfer.world_to_numpy(w))
    with mega_env(False):
        w2, dt = timed(lambda: tsim.run_chunk(cfg, w, n))
        busy, per_tick, _ = profile_ticks(
            lambda: tsim.run_chunk(cfg, w2, N_PROFILE_TICKS), N_PROFILE_TICKS)
    sps = n / dt
    lights = int(worlds[0].lights_static.valid.sum())
    if lights != dig["lights"]:
        raise AssertionError(f"config #1: {lights} lights")
    idle = 1 - busy / (dt * 1e3 / n)
    log(f"config #1 ({card}): generation {gen_ms:.1f} ms a seed (seeds 1-"
        f"{len(t_gen)}, after a warm seed 0: {[round(t, 3) for t in t_gen]}"
        f" s), seeds 0-{len(t_gen)} equal JAX's digest at init; seed 0 after"
        f" {n} ticks equals JAX's (first chunk {t_first:.3f} s, launches "
        f"{launches}); light cycling {sps:.2f} steps/s over {n} ticks, "
        f"{lights} lights, device busy {busy:.3f} ms/tick in "
        f"{per_tick:.1f} launches, idle share {idle:.3f}")
    REPORT["config1"] = {
        "card": card, "generate_ms": gen_ms, "generate_s": t_gen,
        "first_chunk_s": t_first, "launches": launches,
        "light_cycling_steps_per_sec": sps, "lights": lights,
        "busy_ms_per_tick": busy, "device_launches_per_tick": per_tick,
        "idle_share": idle}
    del worlds, w, w2
    torch.cuda.empty_cache()
    return launches


class mega_env:
    """TSIM_MEGA_FORCE=1 (the megakernel path) or TSIM_NO_MEGAKERNEL=1
    (the per-tick path) inside the block, the environment as it was
    after."""

    KEYS = ("TSIM_MEGA_FORCE", "TSIM_NO_MEGAKERNEL", "TSIM_MEGA_INTERPRET")

    def __init__(self, mega: bool):
        self.mega = mega

    def __enter__(self):
        self.saved = {k: os.environ.pop(k, None) for k in self.KEYS}
        os.environ["TSIM_MEGA_FORCE" if self.mega
                   else "TSIM_NO_MEGAKERNEL"] = "1"

    def __exit__(self, *exc):
        for k in self.KEYS:
            os.environ.pop(k, None)
            if self.saved[k] is not None:
                os.environ[k] = self.saved[k]


def compare_mega(name, got: dict, ref: dict, HE) -> float:
    """K9's outputs against its plain version's: bit-equal but the
    stats rows' f32 duration sums (rtol 1e-5, their order differs);
    returns the max abs error."""
    err = 0.0
    for k in HE.MEGA_OUTPUTS:
        g, r = got[k], ref[k]
        if k == "stats":
            keep = [c for c in range(g.shape[1]) if c not in MEGA_DUR_COLS]
            compare(f"{name} stats", (g[:, keep],), (r[:, keep],))
            if not torch.allclose(g[:, MEGA_DUR_COLS], r[:, MEGA_DUR_COLS],
                                  rtol=1e-5, atol=0.0):
                raise AssertionError(f"{name}: duration sums differ beyond "
                                     f"rtol 1e-5: {g[:, MEGA_DUR_COLS]} vs "
                                     f"{r[:, MEGA_DUR_COLS]}")
        else:
            compare(f"{name} {k}", (g,), (r,))
        err = max(err, max_abs_err(g, r))
    return err


def mega_args(cfg, world, R, engine, megakernel, tsim):
    """K9's inputs for the first R ticks from `world` (its next segment
    as `run_chunk` would launch it)."""
    es = tsim._enter_engine(cfg, world)
    cs = megakernel.build_chunk_static(cfg, world)
    draws, _ = engine.tick_draws(cfg, tsim._key_np(world.key), R)
    args, _ = megakernel.segment_inputs(
        cfg, world, es, cs, engine.routing_planes(cfg, world, es), R,
        torch.from_numpy(draws).cuda())
    return args


def profile_path(fn, n_ticks, kernel_key=None):
    """(device busy ms per tick, device kernels and copies per tick,
    device ms per launch of the kernel whose name holds `kernel_key`) of
    fn() under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / n_ticks
    n = sum(e.count for e in ev) / n_ticks
    k = None
    if kernel_key:
        hits = [e for e in ev if kernel_key in e.key]
        if hits:
            k = sum(e.self_device_time_total for e in hits) / 1e3 \
                / sum(e.count for e in hits)
    return busy, n, k


def k9_code(cfg, world, HE, engine, megakernel, tsim) -> dict:
    """K9's grid, ptxas's registers and shared memory, and its grid
    barriers a tick under every FSM controller (counted by the kernel),
    each controller's segment from the headline world held to the plain
    version; one device kernel a call and no memset (the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from trafficsimulation_tpu_torch.lights import fsm
    from trafficsimulation_tpu_torch.ops import build
    R = cfg.PATHFINDING_COOLDOWN
    grid, cpt = HE.mega_grid(torch.device("cuda"), cfg.HEIGHT, cfg.WIDTH)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import sass_count
    # the single-world kernel (mega_kernel<K9_ONE>) and, beside it, the
    # batched cooperative and block-per-world instantiations
    log_ = build.build_log or ""
    one = "mega_kernelILi0E" if "mega_kernelILi0E" in log_ else "mega_kernel"
    ptxas = sass_count.ptxas_info(log_, one) if log_ else {}
    ptxas_batched = {form: sass_count.ptxas_info(log_, f"mega_kernelILi{i}E")
                     for i, form in ((1, "coop"), (2, "worlds"))
                     if f"mega_kernelILi{i}E" in log_}
    barriers = {}
    for algo in fsm.FSM_ALGOS:
        c = cfg.replace(TRAFFIC_LIGHT_AGENT_ALGORITHM=algo)
        args = mega_args(c, world, R, engine, megakernel, tsim)
        HE.mega_syncs()
        got = HE.mega_segment(c, args)
        n = HE.mega_syncs()
        compare_mega(f"K9 {algo}", got, megakernel.segment_plain(c, args),
                     HE)
        barriers[algo] = (n - 1) / R
    args = mega_args(cfg, world, R, engine, megakernel, tsim)
    HE.mega_segment(cfg, args)
    torch.cuda.synchronize()
    # the profiler here may drop events, never add them: three calls
    # must show nothing but K9's kernel, at most three times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                HE.mega_segment(cfg, args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    if not names or len(names) > 3 or any("mega_kernel" not in n
                                          for n in names):
        raise AssertionError(f"K9 ran {names} in three calls, not one "
                             f"kernel a call")
    G = args["li"].shape[1]
    own = megakernel.light_owners(
        args["lown"], G, args["qrun"].shape[0], args["lstop"].shape[0],
        args["srun"].shape[0], args["srun"], cfg.HEIGHT, cfg.WIDTH, grid)
    log(f"K9's cooperative grid: {grid} blocks of 256 threads, {cpt} tiles "
        f"of 32 x 8 a block, on {n_sm} SMs; ptxas: {ptxas} (the batched "
        f"forms: {ptxas_batched}); grid barriers "
        f"a tick (and one a segment) by controller, each segment equal to "
        f"plain: {barriers}; the profiler sees only {names[0][:40]} "
        f"({len(names)} of 3 calls), no memset; {G} groups, "
        f"{len(own['shared_stop_cells'])} stop "
        f"cells shared by two owners")
    return {"grid": grid, "tiles_a_block": cpt, "ptxas": ptxas,
            "ptxas_batched": ptxas_batched,
            "barriers_a_tick": barriers, "device_kernels": names,
            "shared_stop_cells": len(own["shared_stop_cells"])}


def phase_mega(cfg, world, ref, card, HE, engine, tsim, transfer):
    """The megakernel path: 23 ticks against JAX, K9 against its plain
    version, and both paths timed in this process."""
    from trafficsimulation_tpu_torch.ops import megakernel
    HW = cfg.HEIGHT * cfg.WIDTH
    R = cfg.PATHFINDING_COOLDOWN
    out = {}

    # (b) 23 ticks through run_chunk on the megakernel path, against JAX
    sim = tsim.TrafficSim.from_world(cfg, world)
    with mega_env(True):
        if not megakernel.mega_ok(cfg, world):
            raise AssertionError("the megakernel gate is closed")
        HE.reset_launches()
        _, t_ref = timed(lambda: sim.step(N_REF_TICKS))
        launches = dict(HE.launches)
    n_exact = compare_leaves("megakernel path end state vs JAX", ref["end"],
                             transfer.world_to_numpy(sim.world))
    segs = -(-N_REF_TICKS // R)
    check_launches("megakernel path", launches, {
        "mega": segs, "build_sdir": segs, "build_wavefront": segs,
        "rain_ticks": segs, "decide_move": 0, "prefix_planes": 0,
        "ordered_add": 0, "build_sdir_batched": 0, "select_rows": 0,
        "decide_move_blocks": 0})
    log(f"megakernel path: step({N_REF_TICKS}) in {t_ref:.2f} s equals "
        f"JAX's end state ({n_exact} integer/bool leaves exact, "
        f"{len(ref['end']) - n_exact} f32 within rtol {FLOAT_RTOL}); "
        f"launches {launches}")
    w23 = sim.world

    # (a) K9 against its plain version: 5 ticks from tick 0, 3 from 23
    for name, w, r in (("R=5", world, R), ("R=3", w23, 3)):
        args = mega_args(cfg, w, r, engine, megakernel, tsim)
        got = HE.mega_segment(cfg, args)
        torch.cuda.synchronize()
        plain = megakernel.segment_plain(cfg, args)
        err = compare_mega(f"K9 {name}", got, plain, HE)
        compare_mega(f"K9 {name} rerun", HE.mega_segment(cfg, args), got, HE)
        ms = median_ms(lambda: HE.mega_segment(cfg, args), reps=10)
        dms = device_ms(lambda: HE.mega_segment(cfg, args), reps=5)
        plain_ms = median_ms(lambda: megakernel.segment_plain(cfg, args),
                             reps=3, warmup=1)
        # what this data needs (mega_cost); at least one operation per
        # cell, tick and phase (decide, 2 per sub-round, finish, the
        # service and spawn stages)
        nbytes = mega_cost(args, got)
        ops = (r * HW * (2 * cfg.VEHICLE_MAX_SPEED + 4),) * 2
        bms, by = bound(nbytes, ops, "mega")
        out[name] = {"max_abs_err": err, "ms": ms, "device_ms": dms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": None, "bytes": nbytes, "ops": ops,
                     "shape": f"{cfg.HEIGHT}x{cfg.WIDTH}, D4 = "
                              f"{args['sdir4'].shape[0]}, R = {r}"}
        log(f"kernel mega (K9, {name}): equal to plain (max abs err "
            f"{err:g}, the duration sums), a rerun bit-equal; median "
            f"{ms:.4f} ms (device {fmt_ms(dms)}), plain {plain_ms:.2f} ms, "
            f"bound {bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB)")
        del got, plain, args
    torch.cuda.empty_cache()
    code = k9_code(cfg, world, HE, engine, megakernel, tsim)
    out["R=5"]["code"] = code

    # (c) both paths from tick 23, 200 ticks each, in this process
    timing = {}
    ends = {}
    for path, mega in (("mega", True), ("per_tick", False)):
        s = tsim.TrafficSim.from_world(cfg, w23)
        with mega_env(mega):
            HE.reset_launches()
            _, dt_run = timed(lambda: s.step(N_BENCH_TICKS))
            k9 = HE.launches["mega"]
            ends[path] = transfer.world_to_numpy(s.world)
            _, wall = timed(lambda: s.step(N_PROFILE_TICKS))
            busy, per_tick, k9_dev = profile_path(
                lambda: s.step(N_PROFILE_TICKS), N_PROFILE_TICKS,
                "mega_kernel" if mega else None)
        sps = N_BENCH_TICKS / dt_run
        wall_ms = wall * 1e3 / N_PROFILE_TICKS
        timing[path] = {
            "steps_per_s": sps, "cell_updates_per_s": sps * HW,
            "wall_ms_per_tick": dt_run * 1e3 / N_BENCH_TICKS,
            "profile_wall_ms_per_tick": wall_ms,
            "busy_ms_per_tick": busy, "idle_share": 1 - busy / wall_ms,
            "launches_per_tick": per_tick,
            "launches_per_segment": per_tick * R,
            "k9_launches": k9, "k9_device_ms_per_call": k9_dev}
        log(f"{path} path ({card}): {N_BENCH_TICKS} ticks in {dt_run:.3f} s "
            f"= {sps:.2f} steps/s = {sps * HW:.4g} cell-updates/s, "
            f"{dt_run * 1e3 / N_BENCH_TICKS:.3f} ms/tick; over "
            f"{N_PROFILE_TICKS} ticks wall {wall_ms:.3f} ms/tick, device "
            f"busy {busy:.3f} ms/tick, idle share {1 - busy / wall_ms:.3f}, "
            f"{per_tick:.1f} device launches per tick = "
            f"{per_tick * R:.0f} per segment"
            + (f"; K9 {k9} launches, {fmt_ms(k9_dev)} device per call"
               if mega else ""))
        del s
    compare_leaves(f"megakernel vs per-tick path at tick "
                   f"{N_REF_TICKS + N_BENCH_TICKS}", ends["per_tick"],
                   ends["mega"])
    log(f"both paths agree at tick {N_REF_TICKS + N_BENCH_TICKS}; the "
        f"megakernel path's steps/s / the per-tick path's: "
        f"{timing['mega']['steps_per_s'] / timing['per_tick']['steps_per_s']:.2f}")
    REPORT["mega"] = {"card": card, "ref_seconds": t_ref,
                      "launches": launches, "kernel": out,
                      "grid_blocks": code["grid"], "timing": timing}
    return launches, out


def capture_mega(HE, run):
    """(inputs, B, batched names) of the first batched K9 call that
    `run()` makes (`HE.mega_segment_batched`, which then runs as
    usual)."""
    seen = []
    orig = HE.mega_segment_batched

    def spy(cfg, a, B, batched, form=None):
        seen.append((a, B, frozenset(batched)))
        return orig(cfg, a, B, batched, form)
    HE.mega_segment_batched = spy
    try:
        with mega_env(True):
            run()
    finally:
        HE.mega_segment_batched = orig
    if not seen:
        raise AssertionError("no batched K9 call")
    return seen[0]


# K9's state planes (read at every cell), its tables of the light groups,
# runs and ticks (read whole), and the block planes beside b_mask (read at
# a block's cells)
MEGA_STATE = ("pa", "pb", "pc", "pd", "pe", "pl", "food", "waste", "frem",
              "wrem")
MEGA_TABLES = ("qrun", "srun", "l_group", "l_axis", "gg_valid", "nbr",
               "ticks", "elapsed", "force", "li", "lf", "lstop", "lown")
MEGA_BLOCK = ("b_ok", "b_bid", "b_svcdest", "b_needs", "b_prod", "b_inner",
              "b_fcap", "b_wcap")


def mega_cost(a: dict, got: dict, batched=()) -> int:
    """The bytes a K9 call (one world, or a batch whose inputs `batched`
    names carry a leading world dim) must move on this data, counted as
    k1_cost counts K1's: the state planes in and every output written
    once at every cell of every world; the tables whole, b_mask and the
    scheduled-spawn plane at every cell and tick, and the scheduled
    vehicle where one is due; the block planes at the block cells; and a
    tick's vehicles (the fewer of the segment's first and last tick) each
    reading one packed stack word, wnd, the rain mask and the geometry
    (intersection and dest_id) every tick.  A table the batch shares
    counts once: its block cells once, and at a tick the cells where any
    world holds a vehicle.  The tables only an arriving vehicle reads
    (g_destkind1, g_nexit, g_exitcell) are left out."""
    H, W = a["pa"].shape[-2:]
    R = a["ticks"].shape[-2]

    def nb(n):
        return a[n].numel() * a[n].element_size()
    ends = [((p & 1) == 1).reshape(-1, H, W) for p in (a["pa"], got["pa"])]
    veh = min(int(p.sum()) for p in ends)
    cells = min(int(p.any(0).sum()) for p in ends)

    def per_tick(n):
        return veh if n in batched else cells
    nbytes = sum(nb(n) for n in MEGA_STATE + MEGA_TABLES
                 + ("b_mask", "spawn_pe"))
    nbytes += int((a["spawn_pe"] >= 0).sum()) * 4           # spawn_pa
    nbytes += int((a["b_mask"] != 0).sum()) * 4 * len(MEGA_BLOCK)
    nbytes += R * (veh * 4 + per_tick("wnd") * 4 + per_tick("rain")
                   + per_tick("inter") + per_tick("g_destid") * 4)
    return nbytes + sum(t.numel() * t.element_size() for t in got.values())


def mega_batch_call(name, cfg, a, B, batched, worlds, HE, megakernel,
                    reps=10) -> dict:
    """One batched K9 call against the plain batched version on the
    worlds `worlds` (each on its own inputs; bit-equal but the f32
    duration sums, `compare_mega`; the plain version's time is its run
    over those worlds), a rerun bit-equal, its median, device time and
    device kernels a call (the profiler: one), its plan and its
    bound."""
    H, W = a["pa"].shape[-2:]
    R = a["ticks"].shape[-2]
    got = HE.mega_segment_batched(cfg, a, B, batched)
    torch.cuda.synchronize()
    idx = torch.tensor(list(worlds), device=a["pa"].device)
    sub = {k: v[idx] if k in batched else v for k, v in a.items()}
    ref, plain_s = timed(lambda: megakernel.segment_plain_batched(
        cfg, sub, len(worlds), batched))
    err = 0.0
    for i, b in enumerate(worlds):
        err = max(err, compare_mega(
            f"{name} world {b}", {k: v[b] for k, v in got.items()},
            {k: v[i] for k, v in ref.items()}, HE))
    del ref, sub
    again = HE.mega_segment_batched(cfg, a, B, batched)
    for k in HE.MEGA_OUTPUTS:
        compare(f"{name} rerun {k}", (again[k],), (got[k],))
    del again
    ms = median_ms(lambda: HE.mega_segment_batched(cfg, a, B, batched),
                   reps=reps)
    dms, nk = device_profile(
        lambda: HE.mega_segment_batched(cfg, a, B, batched), reps=5)
    if nk is not None and nk != 1:
        raise AssertionError(f"{name}: {nk} device kernels a call, not one")
    plain_ms = plain_s * 1e3
    plan = HE.mega_plan(B, H, W)
    nbytes = mega_cost(a, got, batched)
    ops = (B * R * H * W * (2 * cfg.VEHICLE_MAX_SPEED + 4),) * 2
    bms, by = bound(nbytes, ops, "mega")
    log(f"kernel {name}: {len(worlds)} worlds equal to plain (max abs err "
        f"{err:g}), a rerun bit-equal; median {ms:.4f} ms (device "
        f"{fmt_ms(dms)} in {nk} kernels a call), plain {plain_ms:.1f} ms "
        f"over the {len(worlds)} worlds, bound {bms:.4f} ms ({by}, "
        f"{nbytes / 1e6:.1f} MB); plan {plan}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dms,
            "kernels_per_call": nk, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "bytes": nbytes, "ops": ops,
            "plan": plan, "worlds_checked": list(worlds),
            "plain_worlds": len(worlds),
            "shape": f"B = {B}, {H}x{W}, D4 = {a['sdir4'].shape[-3]}, "
                     f"R = {R}"}


def mega_groups_call(cfg, a, batched, HE, megakernel, B=35) -> dict:
    """K9's cooperative form over more worlds of 256^2 than one resident
    grid holds: B worlds on the inputs of a B = 16 call (world b on world
    b mod 16's), so that the launch walks world groups of several blocks
    a world, the last group short by padding worlds; the first and last
    world of each group equal to the plain version on its inputs."""
    H, W = a["pa"].shape[-2:]
    plan = HE.mega_plan(B, H, W)
    wpg = plan["worlds_per_group"]
    if plan["form"] != "coop" or plan["groups"] < 2 or B % wpg == 0 \
            or plan["blocks_per_world"] < 2:
        raise AssertionError(f"B={B}: plan {plan}, not short world groups "
                             "of several blocks a world")
    idx = torch.arange(B, device=a["pa"].device) % a["pa"].shape[0]
    big = {k: v[idx] if k in batched else v for k, v in a.items()}
    got = HE.mega_segment_batched(cfg, big, B, batched)
    torch.cuda.synchronize()
    check = sorted({w for g in range(plan["groups"])
                    for w in (g * wpg, min((g + 1) * wpg, B) - 1)})
    sub = {k: v[idx[check]] if k in batched else v for k, v in a.items()}
    ref = megakernel.segment_plain_batched(cfg, sub, len(check), batched)
    err = 0.0
    for i, b in enumerate(check):
        err = max(err, compare_mega(
            f"K9 B={B} world {b}", {k: v[b] for k, v in got.items()},
            {k: v[i] for k, v in ref.items()}, HE))
    log(f"K9's cooperative form over {plan['groups']} world groups of "
        f"{wpg} (B = {B}, {H}x{W}, {plan['blocks_per_world']} blocks a "
        f"world, {plan['groups'] * wpg - B} padding): worlds {check} equal "
        f"to plain (max abs err {err:g}); plan {plan}")
    return {"plan": plan, "worlds_checked": check, "max_abs_err": err}


def batch_paths(run, n_ticks, HE, R, kernel_key, n_profile=None):
    """Both paths of a batch runner in this process: `run(n, mega)` runs
    n ticks (TSIM_MEGA_FORCE or TSIM_NO_MEGAKERNEL) from the same state;
    per path the wall ms a tick over n_ticks, steps/s, device-busy ms and
    device launches a tick over n_profile ticks (the profiler), the idle
    share, launches a segment and the wrapper's K9 launches."""
    n_profile = n_profile or n_ticks
    out = {}
    for path, mega in (("mega", True), ("per_tick", False)):
        with mega_env(mega):
            run(R, mega)                  # warm: the first segment's set-up
            HE.reset_launches()
            _, dt = timed(lambda: run(n_ticks, mega))
            k9 = HE.launches["mega"] + HE.launches.get("mega_worlds", 0)
            busy, per_tick, k9_dev = profile_path(
                lambda: run(n_profile, mega), n_profile,
                kernel_key if mega else None)
        wall = dt * 1e3 / n_ticks
        out[path] = {"steps_per_s": n_ticks / dt, "wall_ms_per_tick": wall,
                     "busy_ms_per_tick": busy, "idle_share": 1 - busy / wall,
                     "launches_per_tick": per_tick,
                     "launches_per_segment": per_tick * R,
                     "k9_launches": k9, "k9_device_ms_per_call": k9_dev}
    return out


def k8_cases(render) -> dict:
    """K8 on seeded planes: [3, 1024, 1024], [3, 256, 256], the ragged 37 x
    300 and a misaligned view (every input one byte past a 16-byte
    boundary), each bit-equal to the plain version (`measure`), with the
    path the wrapper takes (an older tree has one path)."""
    out = {}
    r = Inputs(8)
    for label, (H, W), off in (("1024x1024", (1024, 1024), 0),
                               ("256x256", (256, 256), 0),
                               ("37x300", (37, 300), 0),
                               ("misaligned 256x256", (256, 256), 1)):
        def plane(t):
            buf = torch.empty(H * W + off, dtype=t.dtype, device="cuda")
            v = buf[off:].view(H, W)
            v.copy_(t)
            return v
        args = (plane(r.rint(0, 20, H, W).to(torch.uint8)),
                plane(r.bern(0.3, H, W)), plane(r.bern(0.3, H, W)),
                plane(r.rint(0, 7, H, W).to(torch.uint8)))
        path = (render.render_path(*args)
                if hasattr(render, "render_path") else "one")
        m = measure(f"render (K8, {label}, {path} path)",
                    lambda: (render.render_planes(*args),),
                    lambda: (render.render_planes_plain(*args),), 7 * H * W,
                    15 * H * W, f"[3, {H}, {W}]{' misaligned' if off else ''}")
        m["path"] = path
        m["bound_share"] = (m["bound_ms"] / m["device_ms"]
                            if m["device_ms"] else None)
        out[label] = m
    return out


def phase_mega_batch(cfg, world, ref, card, HE, engine, tsim, transfer, mesh,
                     prng, Config):
    """The batched megakernel: the B = 16 shared-geometry batch and config
    #4's 1024 cities on the megakernel path (one K9 launch a segment for
    the batch), held to JAX and to single-world runs; one batched K9 call
    of each against the plain version; both paths of both batches timed
    in this process; K8 on seeded planes.  On an older tree (`--tree`,
    whose K9 maps the worlds one launch each) only the paths' times, K9's
    launches a segment and K8."""
    from trafficsimulation_tpu_torch.ops import megakernel
    from trafficsimulation_tpu_torch.ops import render
    new = hasattr(HE, "mega_segment_batched")
    R = cfg.PATHFINDING_COOLDOWN
    segs = -(-N_REF_TICKS // R)
    out = {"k8": k8_cases(render)}

    # (1) B = 16 rollouts of the headline city, 23 ticks on the megakernel
    # path
    keys = batch_keys(world.key, prng)
    batch = mesh.tile_dynamic(world, keys)
    with mega_env(True):
        HE.reset_launches()
        b23, t_ref = timed(lambda: mesh.run_batch_shared(cfg, batch,
                                                         N_REF_TICKS))
        launches = dict(HE.launches)
    need = {"mega": segs if new else segs * BATCH, "build_sdir_batched": segs,
            "build_wavefront": segs, "rain_ticks": segs, "decide_move": 0,
            "prefix_planes": 0, "ordered_add": 0, "build_sdir": 0,
            "decide_move_blocks": 0}
    if new:
        need["mega_worlds"] = 0
    check_launches("B=16 megakernel path", launches, need)
    compare_leaves("B=16 megakernel path world 0 vs JAX", ref["end"],
                   transfer.world_to_numpy(mesh.world_at(b23, 0)))
    if new:
        for b in (1, BATCH - 1):
            w = world.replace(key=torch.from_numpy(
                keys[b].view(np.int32).copy()).cuda())
            with mega_env(True):
                single = tsim.run_chunk(cfg, w, N_REF_TICKS)
            compare_leaves(f"B=16 megakernel path world {b} vs its single "
                           "run", transfer.world_to_numpy(single),
                           transfer.world_to_numpy(mesh.world_at(b23, b)))
    if new:
        keep_ref("b16_mega", b23, launches, mesh)
    log(f"B=16 megakernel path: run_batch_shared({N_REF_TICKS}) in "
        f"{t_ref:.2f} s; world 0 equals JAX's end state"
        + (", worlds 1 and 15 their single runs" if new else "")
        + f"; launches {launches}")
    out["b16_launches"] = launches

    if new:
        # (2) one batched K9 call from tick 23 against the plain version
        a, B, batched = capture_mega(
            HE, lambda: mesh.run_batch_shared(cfg, b23, R))
        if B != BATCH or {"qrun", "lown"} & batched:
            raise AssertionError(f"B=16: {B} worlds, batched {batched}")
        out["b16_kernel"] = mega_batch_call(
            "mega (batched K9, B=16 from tick 23)", cfg, a, B, batched,
            range(BATCH), HE, megakernel)
        out["b16_groups"] = mega_groups_call(cfg, a, batched, HE,
                                             megakernel)
        del a
        torch.cuda.empty_cache()

    # (4) both paths of the B = 16 batch from tick 23
    state = {"b": b23}

    def run16(n, mega):
        state["b"] = mesh.run_batch_shared(cfg, state["b"], n)
    out["b16_paths"] = batch_paths(run16, MEGA_BATCH_TICKS, HE, R,
                                   "mega_kernel", N_PROFILE_TICKS)
    del state, b23, batch
    torch.cuda.empty_cache()

    # (3) config #4 on the megakernel path
    c4 = Config(**CONFIG4)
    n4 = CONFIG4_WORLDS
    with open(os.path.join(ROOT, CONFIG4_DIGEST)) as f:
        digest = json.load(f)
    worlds = mesh.init_world_batch(c4, prng.PRNGKey(0), n4)
    quirk = {b: megakernel.quirks(c4, mesh.world_at(worlds, b))
             for b in range(digest["worlds"])} if new else {}
    ticks4 = CONFIG4_TICKS if new else MEGA_OLD_CONFIG4_TICKS
    with mega_env(True):
        HE.reset_launches()
        try:
            w4, t4 = timed(lambda: mesh.run_chunk_batch(c4, worlds, ticks4))
        except RuntimeError as e:
            if new:
                raise
            # an older tree whose chunk tables do not vmap over per-world
            # geometry: no config #4 on its megakernel path
            log(f"config #4 megakernel path: this tree cannot run it ({e})")
            REPORT["mega_batch"] = {"card": card, **out,
                                    "config4_error": str(e)[:300]}
            return launches, None, out
        l4 = dict(HE.launches)
    segs4 = -(-ticks4 // R)
    need = {"decide_move_blocks": 0, "decide_move": 0, "prefix_planes": 0,
            "build_sdir": segs4, "build_wavefront": segs4,
            "build_sdir_batched": 0}
    if new:
        need.update(mega=0, mega_worlds=segs4)
    else:
        need.update(mega=segs4 * n4)
    check_launches("config #4 megakernel path", l4, need)
    if new:
        for b in range(digest["worlds"]):
            if quirk[b]:
                log(f"config #4 world {b} reaches K9's JAX quirks {quirk[b]}:"
                    " held to the plain version only")
                continue
            check_digest(f"config #4 megakernel path world {b} after "
                         f"{ticks4} ticks", digest[f"chunk{ticks4}"][b],
                         transfer.world_to_numpy(mesh.world_at(w4, b)))
        plan4 = HE.mega_plan(n4, c4.HEIGHT, c4.WIDTH)
        if plan4["form"] != "worlds":
            raise AssertionError(f"config #4: K9's plan {plan4}")
        keep_ref("config4_mega", w4, l4, mesh, quirks=quirk)
    log(f"config #4 megakernel path: {ticks4} ticks of {n4} worlds in "
        f"{t4:.2f} s; launches {l4}"
        + (f"; worlds 0-{digest['worlds'] - 1} equal JAX's digest but "
           f"{[b for b in quirk if quirk[b]]} (quirks); plan {plan4}"
           if new else ""))
    out["config4_launches"] = l4
    del worlds
    if new:
        a, B, batched = capture_mega(
            HE, lambda: mesh.run_chunk_batch(c4, w4, R))
        if B != n4 or "qrun" not in batched:
            raise AssertionError(f"config #4: {B} worlds, batched {batched}")
        check = sorted(set(range(4)) | set(range(0, n4, 64)))
        out["config4_kernel"] = mega_batch_call(
            "mega_worlds (batched K9, config #4, tick "
            f"{ticks4 + R})", c4, a, B, batched, check, HE, megakernel)
        del a
        torch.cuda.empty_cache()
    state = {"w": w4}

    def run4(n, mega):
        state["w"] = mesh.run_chunk_batch(c4, state["w"], n)
    out["config4_paths"] = batch_paths(
        run4, ticks4, HE, R, "mega_kernel",
        N_PROFILE_TICKS if new else MEGA_OLD_CONFIG4_TICKS)
    del state, w4
    torch.cuda.empty_cache()
    for name, n, p in (("B=16", BATCH, out["b16_paths"]),
                       ("config #4", n4, out["config4_paths"])):
        for path, t in p.items():
            log(f"{name} {path} path ({card}): {t['steps_per_s']:.2f} steps/s "
                f"({n} worlds), wall {t['wall_ms_per_tick']:.3f} ms/tick, "
                f"device busy {t['busy_ms_per_tick']:.3f} ms/tick, idle "
                f"share {t['idle_share']:.3f}, "
                f"{t['launches_per_segment']:.0f} launches a segment"
                + (f", K9 {t['k9_launches']} launches, "
                   f"{fmt_ms(t['k9_device_ms_per_call'])} device a call"
                   if path == "mega" else ""))
    REPORT["mega_batch"] = {"card": card, **out}
    return launches, l4, out


def tick_inputs(cfg, world, HE, tsim, name: str):
    """The positional and keyword arguments of the wrapper `HE.<name>` on
    the first tick of `world` on the per-tick path, captured from a
    one-tick `run_chunk` (the wrapper must be called once in that
    tick)."""
    return tick_inputs_of(cfg, world, HE, tsim, (name,))[name]


def tick_inputs_of(cfg, world, HE, tsim, names: tuple) -> dict:
    """`tick_inputs` of each wrapper of `names`, from one one-tick run."""
    seen = {n: [] for n in names}
    orig = {n: getattr(HE, n) for n in names}

    def spy(n):
        def f(*a, **k):
            seen[n].append((a, k))
            return orig[n](*a, **k)
        return f
    for n in names:
        setattr(HE, n, spy(n))
    try:
        with mega_env(False):
            tsim.run_chunk(cfg, world, 1)
    finally:
        for n in names:
            setattr(HE, n, orig[n])
    calls = {n: len(v) for n, v in seen.items()}
    if any(c != 1 for c in calls.values()):
        raise AssertionError(f"one tick called the wrappers {calls} times")
    return {n: v[0] for n, v in seen.items()}


def ordered_add_tick(cfg, world, HE, tsim, label: str) -> dict:
    """The service FSM's ordered add on its inputs of the first tick of
    `world` (both tanks of every block, one update per destination)
    against its plain version, and the PyTorch calls that could compute
    it (`ordered_add_library`); `library_ms` is the fastest of those that
    give the same bits, None when neither does."""
    (b, i, v), _ = tick_inputs(cfg, world, HE, tsim, "ordered_add")
    R, T = b.shape
    n = i.shape[1]
    adds = int(((i >= 0) & (i < T)).sum())
    nonzero = int((((i >= 0) & (i < T)) & (v != 0)).sum())
    # base read and out written f32 [R, T]; idx i64 and vals f32 [R, n];
    # one add per update in range
    m = measure(f"ordered_add at {label}",
                lambda: (HE.ordered_add(b, i, v),),
                lambda: (HE.ordered_add_plain(b, i, v),),
                R * T * 4 * 2 + R * n * 12, adds,
                f"[{R}, {T}] += [{R}, {n}] ({label})", lib=None)
    lib = ordered_add_library(b, i, v, HE.ordered_add_plain(b, i, v), HE)
    same = [x["ms"] for x in lib.values() if x["same_function"]]
    m.update(library_ms=min(same) if same else None, library=lib,
             nonzero_updates=nonzero)
    log(f"ordered_add at {label}: {nonzero} nonzero of {adds} updates; "
        f"library calls {json.dumps(lib)}")
    return m


def rain_tick_path(cfg, world, HE, tsim) -> dict:
    """`rain_ticks` at the shape the per-tick path launches it with (one
    world, one tick, the world's clouds), on its inputs of the first tick
    of `world`, against its plain version."""
    from trafficsimulation_tpu_torch.agents import rain
    a, _ = tick_inputs(cfg, world, HE, tsim, "rain_ticks")
    clouds, active, cooldown, spawn, want_cd, cool = a
    R, n = clouds.shape[1], spawn.shape[1]
    out = HE.rain_ticks(*a)
    nbytes = sum(t.numel() * t.element_size() for t in
                 (clouds, active, cooldown, spawn, want_cd, *out))
    m = measure(
        "rain_ticks on the path", lambda: HE.rain_ticks(*a),
        lambda: rain.cloud_ticks_plain(*a), nbytes, R * n * 40,
        f"1 world, {n} tick, {R} clouds ({int(active.sum())} active)")
    # the wrapper's floor: one launch with no work, in the same phase
    m["empty_launch_ms"] = launch_floor_ms(HE)
    log(f"rain_ticks on the path: wrapper {m['ms']:.4f} ms, one launch "
        f"with no work {m['empty_launch_ms']:.4f} ms")
    return m


def k1_hier_tick(cfg, world, HE, tsim) -> dict:
    """K1-hier on its inputs of the first tick of the config #5 world,
    captured from a one-tick `run_chunk`, against its plain version (the
    plain decide core with `hier_select`, two K6 launches per select)."""
    from trafficsimulation_tpu_torch.ops import hier
    (kcfg, *a), kw = tick_inputs(cfg, world, HE, tsim, "decide_move")
    local4, consts = kw["hier"]
    sdir4, wnd, planes, stop, rain, ped, inter, dest_id, randoms = a
    H, W = cfg.HEIGHT, cfg.WIDTH
    present = (planes[0] & 1) == 1
    p, _ = hier.hier_rows(kcfg, (planes[0] >> 18) & ((1 << 14) - 1))
    n_veh = int(present.sum())
    n_win = int((present & (p >= 0)).sum())
    # K1's bytes and operations (k1_cost), its one stack word per vehicle
    # now a word of the dense stack per vehicle and one of the windowed
    # stack per vehicle whose cell lies in its destination's window
    nbytes, ops = k1_cost(planes, kcfg, shared_geometry=True,
                          stack_words=n_veh + n_win)

    def plain():
        return HE.decide_move_core(
            kcfg, sdir4, wnd, *planes, stop, rain, ped, inter, dest_id,
            *randoms,
            select=lambda d: hier.hier_select(kcfg, sdir4, local4, d))
    m = measure("decide_move (K1-hier) at config #5",
                lambda: HE.decide_move(kcfg, *a, hier=(local4, consts)),
                plain, nbytes, ops,
                f"{H}x{W}, dense D4 = {sdir4.shape[0]}, windowed D4 = "
                f"{local4.shape[0]}, {n_veh} vehicles ({n_win} in their "
                f"destination's window)", reps=10)
    m.update(vehicles=n_veh, in_window=n_win)
    return m


def config5_k6(cfg, world, HE, tsim) -> dict:
    """K6 on config #5's own state: the rows `hier_rows` gives for the
    dest field of K1-hier's planes on the tick after `world` (captured
    from a one-tick `run_chunk`), the windowed stack with p and the dense
    stack with r.  The empty cells' dest field is 0, so their gathers
    name one plane and share sectors, which the uniform draw of
    phase_select_rows hides."""
    from trafficsimulation_tpu_torch.ops import hier
    (kcfg, *a), kw = tick_inputs(cfg, world, HE, tsim, "decide_move")
    local4, _ = kw["hier"]
    sdir4, planes = a[0], a[2]
    H, W = cfg.HEIGHT, cfg.WIDTH
    p, r = hier.hier_rows(kcfg, (planes[0] >> 18) & ((1 << 14) - 1))
    n_veh = int((planes[0] & 1).sum())
    out = {}
    for key, stack, rows, label in (
            ("select_rows", local4, p, "windowed stack, hier_rows' p"),
            ("select_rows_dense", sdir4, r, "dense stack, hier_rows' r")):
        out[key] = k6_row(
            f"select_rows at config #5 ({label})", HE, stack, rows,
            f"{H}x{W}, {label}, D4 = {stack.shape[0]}, {n_veh} vehicles, "
            f"{int((rows >= 0).sum())} rows in range")
    return out


def phase_tiled(cfg, world, HE, tsim):
    """K7 on the headline's first-tick inputs at the tilings TILES:
    bit-equal to its plain version and to K1, one launch per call."""
    (kcfg, *a), kw = tick_inputs(cfg, world, HE, tsim, "decide_move")
    if kw.get("hier") is not None:
        raise AssertionError("the headline tick ran K1-hier")
    H, W = cfg.HEIGHT, cfg.WIDTH
    P = HE.TILE_HALO
    k1 = HE.decide_move(kcfg, *a)
    present = int((a[2][0] & 1).sum())
    k1_bytes, k1_ops = k1_cost(a[2], kcfg, shared_geometry=True)
    k1m = measure("decide_move at the headline's first tick",
                  lambda: HE.decide_move(kcfg, *a),
                  lambda: HE.decide_move_core(kcfg, a[0], a[1], *a[2],
                                              *a[3:8], *a[8]),
                  k1_bytes, k1_ops,
                  f"{H}x{W}, D4 = {a[0].shape[0]}, {present} vehicles")
    k1_ms = k1m["ms"]
    out = {}
    for th, tw in TILES:
        # the kernel's plan against k7_plan's (an older tree has neither)
        plan = HE.tiled_plan(H, W, th, tw) if hasattr(HE, "tiled_plan") \
            else None
        log(f"decide_move_tiled {th}x{tw}: plan {plan}")
        n0 = HE.launches["decide_move_tiled"]
        got = HE.decide_move_tiled(kcfg, *a, th, tw)
        if HE.launches["decide_move_tiled"] != n0 + 1:
            raise AssertionError("decide_move_tiled: not one launch")
        compare(f"decide_move_tiled {th}x{tw} vs K1", got, k1)
        del got
        # the bound is the function's (K1's bytes and operations) at
        # every tiling; the window's halo re-reads are this design's
        # traffic, reported beside it
        ratio = (th + 2 * P) * (tw + 2 * P) / (th * tw)
        out[f"{th}x{tw}"] = m = measure(
            f"decide_move_tiled {th}x{tw}",
            lambda: HE.decide_move_tiled(kcfg, *a, th, tw),
            lambda: HE.decide_move_tiled_plain(kcfg, *a, th, tw),
            k1_bytes, k1_ops,
            f"{H}x{W}, D4 = {a[0].shape[0]}, tiles {th}x{tw}, "
            f"{(H // th) * (W // tw)} windows", reps=10)
        m["window_ratio"] = ratio
        m["window_bytes"] = k1_bytes * ratio
        m["plan"] = plan
    log(f"K7 equals K1 on the headline's first tick ({present} vehicles) "
        f"at tiles {TILES}; K1 on the same inputs {k1_ms:.4f} ms")
    REPORT["tiled"] = {"k1_ms": k1_ms, "k1": k1m, **out}
    return out


def phase_render(cfg, world, HE, tsim, snapshot):
    """The port's frame of its 23-tick headline end state against JAX's
    digest, and K8 on that state against its plain version."""
    import hashlib
    from trafficsimulation_tpu_torch.ops import render as R
    sim = tsim.TrafficSim.from_world(cfg, world)
    with mega_env(False):
        sim.step(N_REF_TICKS)
    frame, t_frame = timed(sim.render)
    with open(snapshot.HEADLINE_FRAME) as f:
        want = json.load(f)
    if frame.device.type != "cuda" or list(frame.shape) != want["shape"] \
            or frame.dtype != torch.uint8:
        raise AssertionError(f"frame {frame.dtype} {tuple(frame.shape)} on "
                             f"{frame.device}")
    sha = hashlib.sha256(frame.cpu().numpy().tobytes()).hexdigest()
    if sha != want["sha256"]:
        sums = frame.reshape(-1, 3).long().sum(0).tolist()
        raise AssertionError(f"headline frame sha256 {sha} is not JAX's "
                             f"{want['sha256']} (channel sums {sums} vs "
                             f"{want['channel_sums']})")
    frame_ms = median_ms(sim.render, reps=10)
    w = sim.world
    H, W = cfg.HEIGHT, cfg.WIDTH
    vst = R.vehicle_classes(w.vehicles, H, W)
    args = (w.grid.cell_type, w.stop_map, w.rain_map, vst)
    # 4 bytes read and 3 written a pixel; per channel a palette select,
    # the two stop recolors, the rain mix and the vehicle overlay
    k8 = measure("render (K8)", lambda: (R.render_planes(*args),),
                 lambda: (R.render_planes_plain(*args),), 7 * H * W,
                 15 * H * W, f"[3, {H}, {W}]")
    log(f"render: the port's frame of its {N_REF_TICKS}-tick end state "
        f"equals JAX's (sha256 {sha}; {int(w.rain_map.sum())} rain cells, "
        f"{int((w.veh_map >= 0).sum())} vehicles); render_frame "
        f"{frame_ms:.4f} ms at {H}x{W} (first call {t_frame * 1e3:.1f} ms)")
    REPORT["render"] = {"frame_sha256": sha, "frame_ms": frame_ms,
                        "k8_256": k8}
    return k8


def phase_bridge(cfg, world, HE, tsim, card):
    """The host bridge over the headline world on the card: forced
    lights through the overrides, the stepping loop's chunk, spawns, the
    /state and /metrics dicts and the frame."""
    from trafficsimulation_tpu_torch import codes as C
    from trafficsimulation_tpu_torch.bridge.server import BridgeState
    sim = tsim.TrafficSim.from_world(cfg, world)
    bridge = BridgeState(sim)
    ls = world.lights_static
    groups = sorted(set(ls.group[ls.valid & (ls.axis == 0)].tolist()))
    g = groups[0]
    ids = bridge.axis_lights(g, 0)
    if len(ids) == 0 or not set(ids) <= set(bridge.group_lights(g)):
        raise AssertionError(f"group {g}: axis lights {ids}")
    bridge.force_lights(ids, stop=True)
    bridge.flush_into_world()
    lf = sim.world.overrides.light_force
    idx = torch.as_tensor(ids, device=lf.device)
    if lf.device.type != "cuda" or not bool((lf[idx] == 1).all()):
        raise AssertionError("bridge: the flushed overrides are not on the "
                             "card")
    ticks = 20        # the bridge loop's ticks_per_frame
    n_chunks = 3
    with mega_env(False):
        sim.step(1)
        stop = sim.world.lights.light_stop
        if not bool(stop[idx].all()):
            raise AssertionError("bridge: forced axis lights not stopped")
        if bool((sim.world.overrides.light_force != -1).any()):
            raise AssertionError("bridge: overrides not cleared")
        grp = torch.as_tensor(bridge.group_lights(g), device=lf.device)
        bridge.force_lights(bridge.group_lights(g), stop=False)
        bridge.flush_into_world()
        sim.step(1)
        if bool(sim.world.lights.light_stop[grp].any()):
            raise AssertionError("bridge: forced go left a light stopped")

        def chunk():
            # the body of `launch`'s stepping loop (no overrides pending)
            bridge.flush_into_world()
            sim.step(ticks)
            return sim.stats()
        HE.reset_launches()
        t_chunks = [timed(chunk)[1] for _ in range(n_chunks)]
    launches = dict(HE.launches)
    # each step call rebuilds the routing planes at its start, then once
    # per PATHFINDING_COOLDOWN ticks
    segs = n_chunks * -(-ticks // cfg.PATHFINDING_COOLDOWN)
    check_launches("bridge loop", launches, {
        "decide_move": n_chunks * ticks, "prefix_planes": n_chunks * ticks,
        "rain_ticks": n_chunks * ticks, "build_sdir": segs,
        "build_wavefront": segs, "select_rows": 0, "mega": 0, "mega_worlds": 0,
        "decide_move_blocks": 0})
    t_chunk = statistics.median(t_chunks)
    launches = {k: v // n_chunks for k, v in launches.items()}
    # spawns: a vehicle on a free road cell bound for destination 0, a
    # food service vehicle on a free highway entrance (the bridge's
    # /create_service_vehicle), else on another free road cell
    vm = sim.world.veh_map.reshape(-1)
    road = torch.nonzero(world.grid.is_road.reshape(-1) & (vm < 0))
    start = int(road[len(road) // 2])
    n0 = sim.num_active_vehicles()
    if not sim.spawn_vehicle(start, 0):
        raise AssertionError("bridge: spawn refused")
    hw = [int(p) for p in world.dests.hw_pos[world.dests.hw_valid].tolist()
          if int(sim.world.veh_map.reshape(-1)[p]) < 0]
    hw.append(int(road[len(road) // 3]))
    if not sim.spawn_vehicle(hw[0], -1, kind=2):
        raise AssertionError("bridge: service spawn refused")
    if sim.num_active_vehicles() != n0 + 2:
        raise AssertionError("bridge: spawns not in the pool")
    state = bridge.state()
    metrics = sim.stats()
    n_ticks = 2 + n_chunks * ticks
    if state["tick"] != n_ticks or metrics["tick"] != n_ticks or \
            state["active_vehicles"] != n0 + 2:
        raise AssertionError(f"bridge: /state {state}")
    json.dumps(metrics)
    frame, t_frame = timed(sim.render)
    f = frame.reshape(-1, 3)
    if tuple(f[start].tolist()) != tuple(C.COLOR_VEHICLE.tolist()) or \
            tuple(f[hw[0]].tolist()) != tuple(
                C.COLOR_SERVICE_VEHICLE.tolist()):
        raise AssertionError("bridge: the frame does not show the spawns")
    log(f"bridge ({card}): axis lights {ids.tolist()} of group {g} forced, "
        f"flushed and stopped on the next tick, the group forced to go; "
        f"the loop's chunk (flush, step({ticks}), stats) in "
        f"{[round(t * 1e3, 3) for t in t_chunks]} ms (median "
        f"{t_chunk * 1e3:.3f} ms) with launches per chunk {launches}; "
        f"spawned at "
        f"{start} and a food vehicle at {hw[0]}; /state {state}; /metrics "
        f"{len(metrics)} keys; frame {tuple(frame.shape)} in "
        f"{t_frame * 1e3:.2f} ms")
    REPORT["bridge"] = {"chunk_s": t_chunk, "chunks_s": t_chunks,
                        "ticks": ticks,
                        "launches": launches, "state": state,
                        "frame_ms": t_frame * 1e3}
    return launches


# the RL light controllers at the headline (`data/rl_digest.json`,
# `tools/make_torch_rl_digest.py`: the sha256 of JAX's initial parameters
# among its leaves)
RL_FAMILIES = ("NEIGHBOR_RL_BATCHED", "RL_A2C_BATCHED", "GAT_DQN_BATCHED")
RL_DIGEST = os.path.join("trafficsimulation_tpu_torch", "data",
                         "rl_digest.json")
RL_NEAR = ("rl.roll_v",)      # A2C's value outputs: the nets' f32 order
RL_NET_RTOL = 1e-5
RL_TRAIN_TICKS = 64
RL_CHUNK = 50
RL_REPEATS = 2            # timed chunks: 2 keep the script under ~950 s
RL_DEVICE = "cuda"
RL_START = {}           # family -> (cfg, world) as phase_rl built them
# the RL families in the world batches (group `rl_batch`)
RL_BATCH_TICKS = 50
RL_BATCH_CHUNK = 25
RL_BATCH_REPEATS = 2      # timed chunks: 2 keep the script under ~950 s
RL_BATCH_WORLDS = (0, BATCH - 1)    # held to their single-world runs
RL_CONFIG4_WORLDS = 4               # config #4 worlds held to theirs
RL_MAX_SKIPPED = 4      # worlds with a near tie passed over, at most
# a float leaf of a batch world against its single-world run: |a - b| <=
# RL_BATCH_RTOL * max|single| + RL_BATCH_ATOL (the batched and the single
# products may take other cuBLAS algorithms; Adam turns a gradient near 0
# into a step of up to lr either way)
RL_BATCH_RTOL, RL_BATCH_ATOL = 1e-3, 1e-5
# ... and a trained float past that: Adam turns a gradient near 0, whose
# sign the summation order decides, into a step of up to lr either way,
# so after tens of updates elementwise bounds do not hold; the two runs
# must agree within 5% of how far training moved the leaf (L2).  On the
# H100: 0.52% the largest reading of two clean runs (REINFORCE world 15,
# its elements past the elementwise bound with sqrt(nu) 10^3-10^5 below
# their leaf's median), 292-373% for the controls that the gates must
# reject (`rl_controls`)
RL_TRAINED = ("rl.params.", "rl.target_params.", "rl.opt_state.0.mu.",
              "rl.opt_state.0.nu.", "rl.roll_v")
RL_TRAINED_FRAC = 0.05


def rl_hold_off(cfg):
    """The digest's config: training held off for the 23 ticks."""
    return cfg.replace(SRL_UPDATE_EVERY=10 ** 6,
                       GAT_BATCH_SIZE=cfg.GAT_MEMORY_CAPACITY + 1)


def rl_world(tsim, prng, Config, snapshot, algo: str, dig: dict):
    """The headline world generated on the card with the RL controller
    `algo` as a user builds it (`init_world`, `measure_and_shrink`,
    `inject_vehicles`), its shrunk config held to the digest's."""
    base = Config(**snapshot.HEADLINE_CFG,
                  TRAFFIC_LIGHT_AGENT_ALGORITHM=algo)
    world = tsim.init_world(base, prng.PRNGKey(dig["seed"]), "cuda")
    cfg, world = tsim.measure_and_shrink(base, world)
    world = tsim.inject_vehicles(cfg, world, dig["n_vehicles"])
    for k, v in dig["cfg"].items():
        want = (tuple(tuple(p) for p in v) if k == "CAP_OVERRIDES" else v)
        if getattr(cfg, k) != want:
            raise AssertionError(f"{algo}: shrunk {k} {getattr(cfg, k)} vs "
                                 f"JAX's {want}")
    return cfg, world


def rl_digest_check(name, digest: dict, leaves: dict):
    """Every leaf against the JAX digest (`check_digest`); A2C's value
    outputs within the nets' tolerance."""
    leaves = {k: v for k, v in leaves.items() if k != "cost_field"}
    near = {k: digest[k] for k in RL_NEAR if k in digest}
    for k, d in near.items():
        v = np.asarray(leaves.pop(k)).astype(np.float64)
        got = (v.sum(), np.abs(v).sum(), v.max())
        if not np.allclose(got, (d["sum"], d["abs_sum"], d["max"]),
                           rtol=RL_NET_RTOL, atol=0.0):
            raise AssertionError(f"{name}: {k} sums {got} vs JAX's "
                                 f"{(d['sum'], d['abs_sum'], d['max'])}")
    ex, f32 = check_digest(name, {k: d for k, d in digest.items()
                                  if k not in near}, leaves)
    return ex, f32 + [f"{k} (rtol {RL_NET_RTOL})" for k in near]


def rl_profile(fn, n_ticks, top: int = 8):
    """`profile_ticks` of fn() and, from the same trace, the `top` host
    ops by self CPU ms a tick: (busy, launches, top kernels, top host
    ops as (name, ms a tick, calls a tick))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    ev = [e for e in ka if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    ev.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / n_ticks
    launches = sum(e.count for e in ev) / n_ticks
    host = sorted((e for e in ka if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    return busy, launches, [
        (e.key[:60], e.self_device_time_total / 1e3 / n_ticks,
         e.count / n_ticks) for e in ev[:top]], [
        (e.key[:60], e.self_cpu_time_total / 1e3 / n_ticks,
         e.count / n_ticks) for e in host[:top]]


def rl_update_profile(cfg, ts, rl_mod, B=None, calls: int = 10):
    """(device ms, device kernels) of one training update of a train
    state on its own buffers (the replay batch from its filled rows),
    under torch.profiler, a mean over `calls` calls after 2 warm-ups.
    `B`: the state is a batch's (every leaf with a leading world dim),
    whose first B worlds update under vmap, as in the batch runners."""
    net = rl_mod.net_of(cfg)
    algo = cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM
    update = {"NEIGHBOR_RL_BATCHED": rl_mod._srl_train,
              "RL_A2C_BATCHED": rl_mod._a2c_update,
              "GAT_DQN_BATCHED": rl_mod._gat_train}[algo]
    lead = () if B is None else (B,)
    dev = ts.opt_state.count.device
    counts = np.asarray(ts.opt_state.count.cpu()).reshape(-1)[
        :B or 1] + 1
    bc = rl_mod._bias_corrections(counts.reshape(lead))
    tk = {"train": torch.ones(lead, dtype=torch.bool, device=dev),
          "sync": torch.ones(lead, dtype=torch.bool, device=dev),
          "bc1": torch.from_numpy(bc["bc1"]).to(dev),
          "bc2": torch.from_numpy(bc["bc2"]).to(dev)}
    if algo not in rl_mod.A2C_ALGOS:
        n = (cfg.SRL_BATCH_SIZE if algo in rl_mod.SRL_ALGOS
             else cfg.GAT_BATCH_SIZE)
        tk["bidx"] = torch.randint(0, max(int(ts.filled.min()), 1),
                                   lead + (n,), device=dev)

    def one(tree, t):
        out = update(cfg, net, rl_mod.untree(ts, tree), rl_mod.RLTick(
            train_any=True, train_all=True, **t))
        return rl_mod.tree(out)
    if B is None:
        fn = lambda: one(rl_mod.tree(ts), tk)  # noqa: E731
    else:
        part = rl_mod.tree(ts)
        part = torch.utils._pytree.tree_map(lambda t: t[:B], part)
        vm = torch.func.vmap(one)
        fn = lambda: vm(part, tk)  # noqa: E731
    for _ in range(2):
        fn()
    busy, kernels, _ = profile_path(lambda: [fn() for _ in range(calls)],
                                    calls)
    return busy, kernels


def phase_rl(HE, tsim, transfer, card, prng, Config, snapshot, utils):
    """The RL controllers at the headline on the card: each family's
    world generated as a user builds it, its initial parameters (drawn
    on the card) equal to flax's sha256s, held to JAX's digest at init
    and after 23
    ticks with training held off (one K1 and one K4 launch a tick, one K2
    and one K3 a segment, no plain decide core, no megakernel, every
    leaf on the card); then 64 ticks at the Config's defaults (training
    on): the parameters moved, Adam's count equals the host's mirror of
    the updates, nothing is NaN, and the arrows of the grid are JAX's
    (`utils.assert_flow_mask` on sampled road cells); then timed chunks
    (steps/s, launches and device busy ms a tick, idle share), one
    training update profiled, and QUEUE_ACTUATED on the same world in
    this call beside them."""
    from trafficsimulation_tpu_torch.rl import controllers as rl_mod
    with open(os.path.join(ROOT, RL_DIGEST)) as f:
        dig = json.load(f)
    head = dig["headline256"]
    n = dig["ticks"]
    R = None
    out, launches_all = {}, {}
    for algo in RL_FAMILIES:
        cfg, world = rl_world(tsim, prng, Config, snapshot, algo, head)
        RL_START[algo] = (cfg, world)
        R = max(1, cfg.PATHFINDING_COOLDOWN)
        rec = head[algo]
        w = world
        cfg_h = rl_hold_off(cfg)
        drawn = {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
                 for k, v in world.rl.params.items()}
        if drawn != rec["params_sha256"]:
            raise AssertionError(f"{algo}: the initial parameters drawn "
                                 "on the card are not flax's: "
                                 f"{sorted(k for k in drawn if drawn[k] != rec['params_sha256'].get(k))}")
        ex0, _ = rl_digest_check(f"{algo} at init", rec["init"],
                                 transfer.world_to_numpy(w))
        HE.reset_launches()
        with mega_env(False), no_plain_core(HE):
            end, t_ref = timed(lambda: tsim.run_chunk(cfg_h, w, n))
        launches = dict(HE.launches)
        check_launches(f"{algo} path", launches, {
            "decide_move": n, "prefix_planes": n, "build_sdir": -(-n // R),
            "build_wavefront": -(-n // R), "build_sdir_batched": 0,
            "select_rows": 0, "mega": 0,
            "mega_worlds": 0, "step_pedestrians": 0,
            "decide_move_blocks": 0,
            "rain_ticks": n if cfg.RAIN_ENABLED else 0})
        cpu = [k for k, t in transfer.world_leaves(end).items()
               if t.device.type != RL_DEVICE]
        if cpu:
            raise AssertionError(f"{algo}: leaves off the card: {cpu[:5]}")
        ex, near = rl_digest_check(f"{algo} after {n} ticks",
                                   rec[f"tick{n}"],
                                   transfer.world_to_numpy(end))
        launches_all[algo] = launches
        log(f"rl {algo}: generated on the card, its initial parameters "
            f"drawn there equal to flax's (the digest's "
            f"{len(drawn)} sha256s); init {ex0}/{len(rec['init'])} leaves "
            f"bit-equal to "
            f"JAX's digest; after {n} ticks ({t_ref:.2f} s) every leaf "
            f"equals JAX's ({ex} bit-equal, f32 within rtol: {near}); "
            f"launches {launches}")

        # training at the Config's defaults from the same start
        _, plan, _ = tsim._chain(cfg, world, RL_TRAIN_TICKS)
        mirror = int(plan.counts[-1])
        p0 = {k: v.clone() for k, v in world.rl.params.items()}
        with mega_env(False), no_plain_core(HE):
            trained, t_train = timed(lambda: tsim.run_chunk(
                cfg, world, RL_TRAIN_TICKS))
        count = int(trained.rl.opt_state.count)
        if count != mirror or count == 0:
            raise AssertionError(f"{algo}: Adam count {count}, host mirror "
                                 f"{mirror}")
        moved = sum(int(not torch.equal(p0[k], v))
                    for k, v in trained.rl.params.items())
        if moved == 0:
            raise AssertionError(f"{algo}: no parameter moved")
        bad = [k for k, t in transfer.world_leaves(trained).items()
               if t.is_floating_point() and not bool(torch.isfinite(t).all())]
        if bad:
            raise AssertionError(f"{algo}: non-finite leaves {bad[:5]}")
        allowed = trained.grid.allowed_dirs.cpu()
        ref_dirs = world.grid.allowed_dirs.cpu().numpy()
        ys, xs = np.nonzero(world.grid.is_road.cpu().numpy())
        pick = np.random.default_rng(0).choice(len(ys), 32, replace=False)
        for i in pick:
            x, y = int(xs[i]), int(ys[i])
            for bit, d in enumerate("NESW"):
                utils.assert_flow_mask(allowed, x, y, d,
                                       bool(ref_dirs[y, x] >> bit & 1))
        # one tick through `TrafficSim.step(1)` (`step_world`)
        one = tsim.TrafficSim.from_world(cfg, trained)
        one.step(1)
        if int(one.world.tick) != int(trained.tick) + 1:
            raise AssertionError(f"{algo}: step(1) did not advance")
        upd_ms, upd_kernels = rl_update_profile(cfg, trained.rl, rl_mod)
        log(f"rl {algo}: {RL_TRAIN_TICKS} ticks at the defaults in "
            f"{t_train:.2f} s, Adam count {count} = the host's mirror, "
            f"{moved}/{len(p0)} parameter tensors moved, no NaN, the grid's "
            f"arrows hold; one update: {upd_ms:.3f} device ms in "
            f"{upd_kernels:.0f} device kernels")
        out[algo] = {"groups": int(world.groups_static.valid.sum()),
                     "ref_s": t_ref, "launches": launches,
                     "train_ticks": RL_TRAIN_TICKS, "train_s": t_train,
                     "adam_count": count, "moved": moved,
                     "update_device_ms": upd_ms,
                     "update_kernels": upd_kernels, "world": trained,
                     "cfg": cfg}
        del end, w
    # the two unbatched names run the same controllers (the JAX dispatch)
    for twin, algo in (("NEIGHBOR_RL", RL_FAMILIES[0]),
                       ("GAT_DQN", RL_FAMILIES[2])):
        cfg = out[algo]["cfg"].replace(TRAFFIC_LIGHT_AGENT_ALGORITHM=twin)
        sim = tsim.TrafficSim.from_world(cfg, out[algo]["world"])
        c0 = int(sim.world.rl.opt_state.count)
        sim.step(3)
        sim.step(1)
        c1 = int(sim.world.rl.opt_state.count)
        if c1 <= c0:
            raise AssertionError(f"{twin}: no update in 4 ticks ({c0})")
        out[twin] = {"updates_in_4_ticks": c1 - c0}
    log("rl: NEIGHBOR_RL and GAT_DQN train through TrafficSim.step(3) and "
        f"step(1) on the card: {out['NEIGHBOR_RL']['updates_in_4_ticks']} "
        f"and {out['GAT_DQN']['updates_in_4_ticks']} updates in 4 ticks")
    # timed chunks of every family and of QUEUE_ACTUATED, in this call
    fsm_cfg = out[RL_FAMILIES[0]]["cfg"].replace(
        TRAFFIC_LIGHT_AGENT_ALGORITHM="QUEUE_ACTUATED")
    fsm_world = out[RL_FAMILIES[0]]["world"].replace(rl=None)
    runs = [(a, out[a]["cfg"], out[a]["world"]) for a in RL_FAMILIES]
    runs.append(("QUEUE_ACTUATED", fsm_cfg, fsm_world))
    HW = fsm_cfg.HEIGHT * fsm_cfg.WIDTH
    for name, cfg, w in runs:
        times = []
        with mega_env(False):
            for _ in range(RL_REPEATS):
                w, dt = timed(lambda w=w: tsim.run_chunk(cfg, w, RL_CHUNK))
                times.append(dt)
            busy, per_tick, top, host = rl_profile(
                lambda: tsim.run_chunk(cfg, w, N_PROFILE_TICKS),
                N_PROFILE_TICKS)
        dt = statistics.median(times)
        wall_ms = dt * 1e3 / RL_CHUNK
        rec = out.setdefault(name, {})
        rec.update(chunk_s=times, steps_per_s=RL_CHUNK / dt,
                   cell_updates_per_s=HW * RL_CHUNK / dt,
                   wall_ms_per_tick=wall_ms, busy_ms_per_tick=busy,
                   device_launches_per_tick=per_tick,
                   idle_share=1 - busy / wall_ms, top_kernels=top,
                   top_host_ops=host)
        log(f"rl timing ({card}) {name}: {RL_REPEATS} chunks of {RL_CHUNK} "
            f"ticks {[round(t, 3) for t in times]} s, median "
            f"{RL_CHUNK / dt:.2f} steps/s; wall {wall_ms:.3f} ms/tick, "
            f"device busy {busy:.3f} ms/tick in {per_tick:.1f} launches, "
            f"idle share {1 - busy / wall_ms:.3f}; top kernels "
            + json.dumps([(k, round(m, 4), round(c, 1)) for k, m, c in top])
            + "; top host ops under the profiler (self CPU ms, calls a tick) "
            + json.dumps([(k, round(m, 3), round(c, 1)) for k, m, c in host]))
    for rec in out.values():
        rec.pop("world", None)
        rec.pop("cfg", None)
    REPORT["rl"] = {"card": card, **out}
    torch.cuda.empty_cache()
    return launches_all["RL_A2C_BATCHED"]



def rl_spied(cfg, world, n_worlds: int, fn):
    """(fn(), near ties a world [n_worlds]) with `rl/ties.TieSpy` in the
    controllers; `world`: the world or batch that fn advances from (its
    plan)."""
    from trafficsimulation_tpu_torch import sim as tsim
    from trafficsimulation_tpu_torch.rl import ties
    with ties.spying(n_worlds) as spy:
        out = fn()
    return out, spy.ties(cfg, tsim._chain(cfg, world, len(spy.gaps))[1])


def rl_lr(cfg, rl_mod) -> float:
    return (rl_mod.GAT_LR if cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM
            in rl_mod.GAT_ALGOS else cfg.SRL_LEARNING_RATE)


def rl_past_bound(k, diff, lim, single: dict, lr: float, top: int = 5):
    """Of a parameter leaf past the elementwise bound: how many elements,
    and of the worst `top` the difference in units of the learning rate
    with Adam's |mu| and sqrt(nu) there in the single run, beside the
    leaf's median sqrt(nu) and that of the elements past the bound.  A
    gradient near 0, whose sign the summation order decides, shows as a
    small sqrt(nu) where Adam still steps by up to lr."""
    rest = k[len("rl.params."):]
    mu = np.abs(single["rl.opt_state.0.mu." + rest]).reshape(-1)
    snu = np.sqrt(single["rl.opt_state.0.nu." + rest]).reshape(-1)
    dd = diff.reshape(-1)
    idx = np.nonzero(dd > lim)[0]
    worst = idx[np.argsort(-dd[idx])][:top]
    return {"n": int(idx.size), "of": int(dd.size),
            "median_sqrt_nu_leaf": float(np.median(snu)),
            "median_sqrt_nu_past": float(np.median(snu[idx])),
            "worst_lr_mu_sqrtnu": [(float(dd[i] / lr), float(mu[i]),
                                    float(snu[i])) for i in worst]}


def rl_compare(name, single: dict, got: dict, start: dict, lr: float,
               control: bool = False) -> dict:
    """A batch world's leaves against its single-world run, both from the
    leaves `start` and both free of near ties (`rl_vs_single`): integers
    exact; floats within RL_BATCH_RTOL / RL_BATCH_ATOL elementwise or,
    for a trained float (RL_TRAINED: parameters, Adam moments, value
    outputs) past that, its difference within RL_TRAINED_FRAC of how far
    training moved the leaf (L2: ||got - single|| <= RL_TRAINED_FRAC *
    ||single - start||).  Returns the largest elementwise error, the
    largest such fraction over the trained leaves and the parameter
    leaves past the elementwise bound (`rl_past_bound`); raises on a
    failed gate, or, for a `control` run that the gates must reject,
    lists the rejections instead."""
    bad, err, frac, past = [], 0.0, 0.0, {}
    for k, a in single.items():
        b = got[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append((k, "shape/dtype"))
        elif np.issubdtype(a.dtype, np.floating):
            if not (np.isfinite(a).all() and np.isfinite(b).all()):
                bad.append((k, "non-finite"))
                continue
            a64 = a.astype(np.float64)
            diff = np.abs(a64 - b)
            d = float(diff.max()) if a.size else 0.0
            err = max(err, d)
            lim = RL_BATCH_RTOL * float(np.abs(a).max() if a.size else 0) \
                + RL_BATCH_ATOL
            f = None
            if k.startswith(RL_TRAINED):
                f = float(np.linalg.norm(diff)) / max(
                    float(np.linalg.norm(a64 - start[k])), 1e-30)
                frac = max(frac, f)
            if d <= lim:
                continue
            if k.startswith("rl.params."):
                past[k] = rl_past_bound(k, diff, lim, single, lr)
            if f is None or f > RL_TRAINED_FRAC:
                bad.append((k, d, lim, f))
        elif not np.array_equal(a, b):
            bad.append((k, "integer leaf differs"))
    out = {"max_abs_float_err": err, "trained_frac": frac,
           "past_bound": past}
    if control:
        return {"max_abs_float_err": err, "trained_frac": frac,
                "rejects": [str(x)[:120] for x in bad[:4]],
                "float_gate_rejects": any(len(x) == 4 for x in bad)}
    if bad:
        raise AssertionError(f"{name}: {bad[:8]}")
    return out


def rl_vs_single(name, want, n_worlds: int, batch_ties, single_of, got_of,
                 lr: float):
    """Each world of `want` held to its single-world run (`rl_compare`).
    A near tie may flip an action and part the two runs, so a world with
    one in the batch run or in its single run is not compared but
    logged, and the next world of the batch outside `want` takes its
    place (at most RL_MAX_SKIPPED).  `single_of(b)`: (the single run's
    leaves, the start's, its near ties); `got_of(b)`: the batch world's
    leaves.  Returns ({world: readings}, {skipped: [batch ties, single
    ties]}, {world: (single, start)})."""
    spare = [b for b in range(n_worlds) if b not in want]
    cmp, skipped, singles = {}, {}, {}
    for b in want:
        while True:
            t1 = None
            if int(batch_ties[b]) == 0:
                single, start, t1 = single_of(b)
                if t1 == 0:
                    break
            skipped[b] = [int(batch_ties[b]), t1]
            if len(skipped) > RL_MAX_SKIPPED or not spare:
                raise AssertionError(f"{name}: near ties in {skipped}")
            b = spare.pop(0)
        cmp[b] = rl_compare(f"{name} world {b} vs its single run", single,
                            got_of(b), start, lr)
        singles[b] = (single, start)
    return cmp, skipped, singles


def rl_controls(rl_mod, mesh, transfer, cfg, batch, singles: dict,
                lr: float) -> dict:
    """Runs of the B = 16 batch that the gates must reject, each held to
    the single runs as the batch was: `tf32`, the nets' products in TF32
    (torch.backends.cuda.matmul.allow_tf32); `bidx_rolled`, each world
    training on the replay rows that the next world's indices pick (the
    plan's `bidx` rolled by one world).  Their readings set where
    RL_TRAINED_FRAC lies."""
    out = {}
    plan_ticks = rl_mod.plan_ticks
    mm = torch.backends.cuda.matmul

    def rolled(*a, **kw):
        plan = plan_ticks(*a, **kw)
        return plan.of(dict(plan.tensors,
                            bidx=plan.tensors["bidx"].roll(1, 0)))
    for name in ("tf32", "bidx_rolled"):
        tf32 = mm.allow_tf32
        try:
            if name == "tf32":
                mm.allow_tf32 = True
            else:
                rl_mod.plan_ticks = rolled
            with mega_env(False):
                end = mesh.run_batch_shared(cfg, batch, RL_BATCH_TICKS)
        finally:
            mm.allow_tf32 = tf32
            rl_mod.plan_ticks = plan_ticks
        out[name] = {b: rl_compare(
            f"control {name} world {b}", single, transfer.world_to_numpy(
                mesh.world_at(end, b).replace(cost_field=None)), start, lr,
            control=True) for b, (single, start) in singles.items()}
        passed = [b for b, r in out[name].items() if not r["rejects"]]
        if passed:
            raise AssertionError(f"control {name}: worlds {passed} pass the "
                                 f"gates: {out[name]}")
    return out


def phase_rl_batch(HE, tsim, transfer, mesh, card, prng, Config, snapshot):
    """The RL families in the world batches on the card: for each family
    at full width, B = 16 rollouts of its headline world (world 0 with
    the world's key): 23 ticks with training held off, world 0 held to
    the one-world digest; then RL_BATCH_TICKS ticks at the Config's
    defaults, worlds 0 and 15 held to their single-world runs (near ties
    counted), every world's Adam count equal to the host's mirror and
    >= 1, parameters moved, no float leaf non-finite; the launches of
    both runs; one training update's device kernels at B = 4 and 16;
    timed chunks beside QUEUE_ACTUATED at B = 16.  Then config #4 with
    REINFORCE: 1024 cities, one chunk of 50 ticks with per-world train
    ticks, worlds 0-3 held to their single-world runs, one K1 launch a
    tick and one K2 a segment, steps/s beside the FSM config #4."""
    from trafficsimulation_tpu_torch.rl import controllers as rl_mod
    with open(os.path.join(ROOT, RL_DIGEST)) as f:
        dig = json.load(f)
    head, n = dig["headline256"], dig["ticks"]
    out, launches_all = {}, {}
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    import warnings
    warnings.filterwarnings("error", message=".*performance drop.*")
    for algo in RL_FAMILIES:
        if algo not in RL_START:
            RL_START[algo] = rl_world(tsim, prng, Config, snapshot, algo,
                                      head)
        cfg, world = RL_START[algo]
        R = max(1, cfg.PATHFINDING_COOLDOWN)
        keys = batch_keys(world.key, prng)
        cfg_h = rl_hold_off(cfg)
        HE.reset_launches()
        with mega_env(False), no_plain_core(HE):
            end, t_ref = timed(lambda: mesh.run_batch_shared(
                cfg_h, mesh.tile_dynamic(world, keys), n))
        launches = dict(HE.launches)
        need = {"decide_move": n, "prefix_planes": n,
                "build_sdir_batched": -(-n // R),
                "build_wavefront": -(-n // R), "build_sdir": 0,
                "select_rows": 0, "mega": 0, "mega_worlds": 0,
                "decide_move_blocks": 0,
                "rain_ticks": n if cfg.RAIN_ENABLED else 0}
        check_launches(f"{algo} B={BATCH} path", launches, need)
        ex, near = rl_digest_check(
            f"{algo} B={BATCH} world 0 after {n} ticks",
            head[algo][f"tick{n}"],
            transfer.world_to_numpy(mesh.world_at(end, 0)))
        log(f"rl_batch {algo}: B={BATCH} for {n} ticks with training held "
            f"off ({t_ref:.2f} s): world 0 equals the one-world digest "
            f"({ex} leaves bit-equal, f32 within rtol: {near}); launches "
            f"{launches}")
        del end
        # training on, at the Config's defaults
        batch = mesh.tile_dynamic(world, keys)
        _, plan, _ = tsim._chain(cfg, batch, RL_BATCH_TICKS)
        mirror = plan.counts[:, -1]
        HE.reset_launches()
        with mega_env(False), no_plain_core(HE):
            (trained, ties), t_train = timed(lambda: rl_spied(
                cfg, batch, BATCH, lambda: mesh.run_batch_shared(
                    cfg, batch, RL_BATCH_TICKS)))
        l_train = dict(HE.launches)
        need_t = dict(need, decide_move=RL_BATCH_TICKS,
                      prefix_planes=RL_BATCH_TICKS,
                      build_sdir_batched=-(-RL_BATCH_TICKS // R),
                      build_wavefront=-(-RL_BATCH_TICKS // R),
                      rain_ticks=RL_BATCH_TICKS if cfg.RAIN_ENABLED else 0)
        check_launches(f"{algo} B={BATCH} training path", l_train, need_t)
        counts = trained.rl.opt_state.count.cpu().numpy()
        if not (np.array_equal(counts, mirror) and counts.min() >= 1):
            raise AssertionError(f"{algo}: Adam counts {counts} vs the "
                                 f"host's mirror {mirror}")
        moved = sum(int(not torch.equal(world.rl.params[k], v[b]))
                    for k, v in trained.rl.params.items() for b in range(
                        BATCH))
        if moved == 0:
            raise AssertionError(f"{algo}: no parameter moved")
        bad = [k for k, t in transfer.world_leaves(trained).items()
               if t.is_floating_point() and not bool(torch.isfinite(t).all())]
        if bad:
            raise AssertionError(f"{algo}: non-finite leaves {bad[:5]}")
        # the key stack is geometry, the same in every run: left out
        start = transfer.world_to_numpy(world.replace(cost_field=None))

        def single_of(b):
            w = world.replace(key=torch.from_numpy(
                keys[b].view(np.int32).copy()).cuda())
            with mega_env(False):
                single, t1 = rl_spied(cfg, w, 1, lambda: tsim.run_chunk(
                    cfg, w, RL_BATCH_TICKS))
            return (transfer.world_to_numpy(single.replace(cost_field=None)),
                    start, int(t1[0]))
        lr = rl_lr(cfg, rl_mod)
        cmp, skipped, singles = rl_vs_single(
            f"{algo} B={BATCH}", RL_BATCH_WORLDS, BATCH, ties, single_of,
            lambda b: transfer.world_to_numpy(mesh.world_at(
                trained, b).replace(cost_field=None)), lr)
        controls = (rl_controls(rl_mod, mesh, transfer, cfg, batch, singles,
                                lr) if algo in rl_mod.SRL_ALGOS else {})
        upd = {f"B={b}": rl_update_profile(cfg, trained.rl, rl_mod, b)
               for b in (4, BATCH)}
        # a mean over profiled calls, which the profiler may short by a
        # kernel now and then; an op looped over the worlds would add at
        # least BATCH - 4 kernels from B = 4 to B = BATCH
        if abs(upd["B=4"][1] - upd[f"B={BATCH}"][1]) >= BATCH - 4:
            raise AssertionError(f"{algo}: an update launches "
                                 f"{upd['B=4'][1]} device kernels at B = 4, "
                                 f"{upd[f'B={BATCH}'][1]} at {BATCH}")
        log(f"rl_batch {algo}: B={BATCH} for {RL_BATCH_TICKS} ticks at the "
            f"defaults ({t_train:.2f} s; launches {l_train}): Adam counts "
            f"{counts.tolist()} = the host's mirror, {moved} parameter "
            f"tensors of {BATCH} worlds moved, no NaN; worlds "
            f"{list(cmp)} against their single runs {json.dumps(cmp)} "
            f"(near ties a world in the batch run: {ties.tolist()}; passed "
            f"over for a near tie [batch, single]: {json.dumps(skipped)}); "
            + (f"controls the gates reject: {json.dumps(controls)}; "
               if controls else "")
            + f"one update (device ms, kernels): {json.dumps(upd)}")
        launches_all[algo] = l_train
        out[algo] = {"ref_s": t_ref, "launches_ref": launches,
                     "train_s": t_train, "launches": l_train,
                     "adam_counts": counts.tolist(), "moved": moved,
                     "vs_single": cmp, "ties": ties.tolist(),
                     "skipped_for_ties": skipped, "controls": controls,
                     "update": upd, "batch": trained, "cfg": cfg}
        del batch
        torch.cuda.empty_cache()
    # timed chunks of the three families and of QUEUE_ACTUATED at B = 16
    cfg0, w0 = RL_START[RL_FAMILIES[0]]
    fsm_cfg = cfg0.replace(TRAFFIC_LIGHT_AGENT_ALGORITHM="QUEUE_ACTUATED")
    runs = [(a, out[a]["cfg"], out[a]["batch"]) for a in RL_FAMILIES]
    runs.append(("QUEUE_ACTUATED", fsm_cfg, mesh.tile_dynamic(
        w0.replace(rl=None), batch_keys(w0.key, prng))))
    HW = cfg0.HEIGHT * cfg0.WIDTH
    for name, cfg, b in runs:
        times = []
        with mega_env(False):
            for _ in range(RL_BATCH_REPEATS):
                b, dt = timed(lambda b=b: mesh.run_batch_shared(
                    cfg, b, RL_BATCH_CHUNK))
                times.append(dt)
            busy, per_tick, top, host = rl_profile(
                lambda: mesh.run_batch_shared(cfg, b, RL_BATCH_CHUNK),
                RL_BATCH_CHUNK)
        dt = statistics.median(times)
        wall_ms = dt * 1e3 / RL_BATCH_CHUNK
        rec = out.setdefault(name, {})
        rec.update(chunk_s=times, steps_per_s_per_world=RL_BATCH_CHUNK / dt,
                   cell_updates_per_s=BATCH * HW * RL_BATCH_CHUNK / dt,
                   wall_ms_per_tick=wall_ms, busy_ms_per_tick=busy,
                   device_launches_per_tick=per_tick,
                   idle_share=1 - busy / wall_ms, top_kernels=top,
                   top_host_ops=host)
        log(f"rl_batch timing ({card}) {name}, B={BATCH}: "
            f"{RL_BATCH_REPEATS} chunks of {RL_BATCH_CHUNK} ticks "
            f"{[round(t, 3) for t in times]} s, median "
            f"{RL_BATCH_CHUNK / dt:.2f} steps/s per world; wall "
            f"{wall_ms:.3f} ms/tick, device busy {busy:.3f} ms/tick in "
            f"{per_tick:.1f} launches, idle share {1 - busy / wall_ms:.3f}; "
            "top kernels " + json.dumps(
                [(k, round(m, 4), round(c, 1)) for k, m, c in top])
            + "; top host ops under the profiler (self CPU ms, calls a tick) "
            + json.dumps([(k, round(m, 3), round(c, 1)) for k, m, c in host]))
        del b
    for a in RL_FAMILIES:
        out[a].pop("batch")
        out[a].pop("cfg")
    RL_START.clear()
    torch.cuda.empty_cache()
    out["config4"] = rl_config4(HE, tsim, transfer, mesh, card, prng,
                                Config, rl_mod)
    launches_all["config4"] = out["config4"]["launches"]
    REPORT["rl_batch"] = {"card": card, **out}
    torch.cuda.empty_cache()
    return launches_all["RL_A2C_BATCHED"]


def rl_config4(HE, tsim, transfer, mesh, card, prng, Config, rl_mod):
    """Config #4 with REINFORCE (see `phase_rl_batch`)."""
    cfg = Config(**CONFIG4, TRAFFIC_LIGHT_AGENT_ALGORITHM="NEIGHBOR_RL_BATCHED")
    nw, T = CONFIG4_WORLDS, CONFIG4_TICKS
    worlds, t_gen = timed(lambda: mesh.init_world_batch(
        cfg, prng.PRNGKey(0), nw))
    groups = worlds.groups_static.valid.sum(-1).cpu().numpy()
    _, plan, _ = tsim._chain(cfg, worlds, T)
    mixed = int((plan.train_any & ~plan.train_all).sum())
    mirror = plan.counts[:, -1]
    if mixed < 1:
        raise AssertionError("config #4 RL: no tick with some worlds "
                             "training and others not")
    R = max(1, cfg.PATHFINDING_COOLDOWN)
    HE.reset_launches()
    with mega_env(False), no_plain_core(HE):
        (end, ties), t_first = timed(lambda: rl_spied(
            cfg, worlds, nw, lambda: mesh.run_chunk_batch(cfg, worlds, T)))
    launches = dict(HE.launches)
    check_launches("config #4 RL path", launches, {
        "decide_move_blocks": T, "decide_move": 0, "prefix_planes": T,
        "build_sdir": -(-T // R), "build_wavefront": -(-T // R),
        "build_sdir_batched": 0, "select_rows": 0, "mega": 0,
        "mega_worlds": 0, "rain_ticks": T if cfg.RAIN_ENABLED else 0})
    counts = end.rl.opt_state.count.cpu().numpy()
    if not (np.array_equal(counts, mirror) and counts.min() >= 1):
        raise AssertionError(f"config #4 RL: Adam counts vs the mirror "
                             f"differ in {int((counts != mirror).sum())} "
                             f"worlds, min {counts.min()}")
    keys = prng.split(prng.PRNGKey(0), nw)

    def single_of(b):
        w = tsim.init_world(cfg, keys[b], "cuda")
        start = transfer.world_to_numpy(w)
        compare_leaves(f"config #4 RL world {b} at init", start,
                       transfer.world_to_numpy(mesh.world_at(worlds, b)))
        with mega_env(False):
            single, t1 = rl_spied(cfg, w, 1, lambda: tsim.run_chunk(
                cfg, w, T))
        return transfer.world_to_numpy(single), start, int(t1[0])
    cmp, skipped, _ = rl_vs_single(
        "config #4 RL", range(RL_CONFIG4_WORLDS), nw, ties, single_of,
        lambda b: transfer.world_to_numpy(mesh.world_at(end, b)),
        rl_lr(cfg, rl_mod))
    fsm_cfg = cfg.replace(TRAFFIC_LIGHT_AGENT_ALGORITHM="QUEUE_ACTUATED")
    timing = {}
    for name, c, w in (("NEIGHBOR_RL_BATCHED", cfg, end),
                       ("QUEUE_ACTUATED", fsm_cfg, end.replace(rl=None))):
        times = []
        with mega_env(False):
            for _ in range(2):
                w, dt = timed(lambda w=w: mesh.run_chunk_batch(c, w, T))
                times.append(dt)
        timing[name] = {"chunk_s": times,
                        "steps_per_s_per_world": T / min(times)}
    log(f"rl_batch config #4 ({card}): {nw} cities with REINFORCE "
        f"generated in {t_gen:.2f} s (light groups {int(groups.min())}-"
        f"{int(groups.max())}); {mixed} of {T} ticks with some worlds "
        f"training and others not; first chunk {t_first:.2f} s, launches "
        f"{launches} (K1 {launches['decide_move_blocks'] / T:g} a tick, K2 "
        f"{launches['build_sdir'] / -(-T // R):g} a segment for the batch); "
        f"Adam counts {int(counts.min())}-{int(counts.max())} = the host's "
        f"mirror; worlds {list(cmp)} against their single runs "
        f"{json.dumps(cmp)} (near ties in the batch run: {int(ties.sum())} "
        f"in {int((ties > 0).sum())} worlds; passed over for a near tie "
        f"[batch, single]: {json.dumps(skipped)}); 2 chunks of {T} ticks each (steps/s per "
        "world, best): " + json.dumps(
            {k: round(v["steps_per_s_per_world"], 2)
             for k, v in timing.items()}))
    return {"generate_s": t_gen, "groups": [int(groups.min()),
                                            int(groups.max())],
            "mixed_ticks": mixed, "first_chunk_s": t_first,
            "launches": launches, "vs_single": cmp,
            "ties": int(ties.sum()), "skipped_for_ties": skipped,
            "timing": timing}


# ---- the sharded world batches (groups `mesh` and `mesh_scaling`) ---------

MESH_RANKS = 4              # ranks sharing the one card over gloo
MESH_RL_RANKS = 2           # the A2C shared batch of 4: 2 ranks x 2
MESH_SCALING = (1, 2, 4)    # ranks of the timing group's spawns
MESH_SCALING_TICKS = 50
MESH_SCALING_PROFILE = 25
RL_BATCH_DIGEST = os.path.join("trafficsimulation_tpu_torch", "data",
                               "rl_batch_digest.json")
MESH_DIGEST = os.path.join("trafficsimulation_tpu_torch", "data",
                           "mesh_digest.json")
# the trained floats' tolerance of tests/test_torch_rl_batch.py: rtol, and
# an absolute one times the leaf's largest magnitude (at most 1)
RL_TRAINED_RTOL, RL_TRAINED_ATOL = 1e-4, 1e-5
# the single-process runs the sharded ones are held to: name -> per-world
# digests of the end state, fleet metrics, launches, forms (`keep_ref`)
REF = {}


def keep_ref(name, end, launches, mesh, quirks=None):
    """Hash a single-process run's end state world by world (with its
    fleet metrics, launches and kernel forms) for the `mesh` group."""
    from trafficsimulation_tpu_torch.parallel import ranks
    t0 = time.perf_counter()
    REF[name] = {"digests": mesh.world_digests(end),
                 "fleet": {k: int(v) for k, v in
                           mesh.fleet_metrics(end).items()},
                 "launches": dict(launches), "forms": ranks.forms(launches),
                 "quirks": quirks or {}}
    log(f"{name}: the end state's {len(REF[name]['digests'])} worlds "
        f"hashed for the sharded runs in {time.perf_counter() - t0:.2f} s")


def mesh_refs(cfg, world, keys, HE, mesh, prng, Config):
    """The single-process runs of the `mesh` group that the groups run
    before it did not leave (`--only mesh`): B = 16 of the headline for
    N_REF_TICKS and config #4 for CONFIG4_TICKS, on both paths."""
    from trafficsimulation_tpu_torch.ops import megakernel
    for mega in (False, True):
        name = "b16_mega" if mega else "b16_per_tick"
        if name not in REF:
            with mega_env(mega):
                HE.reset_launches()
                end = mesh.run_batch_shared(
                    cfg, mesh.tile_dynamic(world, keys), N_REF_TICKS)
                keep_ref(name, end, HE.launches, mesh)
            del end
    if {"config4_per_tick", "config4_mega"} <= set(REF):
        return
    c4 = Config(**CONFIG4)
    worlds = mesh.init_world_batch(c4, prng.PRNGKey(0), CONFIG4_WORLDS)
    quirk = {b: megakernel.quirks(c4, mesh.world_at(worlds, b))
             for b in range(4)}
    for mega in (False, True):
        name = "config4_mega" if mega else "config4_per_tick"
        if name not in REF:
            with mega_env(mega):
                HE.reset_launches()
                end = mesh.run_chunk_batch(c4, worlds, CONFIG4_TICKS)
                keep_ref(name, end, HE.launches, mesh,
                         quirks=quirk if mega else None)
            del end
    del worlds
    torch.cuda.empty_cache()


def mesh_same(name, want: list, got: list, mesh):
    """Every world's digest of a sharded run against the single-process
    run's: every leaf, f32 too, by sha256."""
    if len(want) != len(got):
        raise AssertionError(f"{name}: {len(got)} worlds, not {len(want)}")
    bad = {b: d[:6] for b, (w, g) in enumerate(zip(want, got))
           if (d := mesh.diff_digests(w, g))}
    if bad:
        raise AssertionError(f"{name}: worlds differ from the single-process "
                             f"run (world: [(leaf, reason)]): "
                             f"{dict(list(bad.items())[:4])} ({len(bad)} "
                             "worlds)")


def mesh_vs_jax(name, want: dict, got: dict, mesh, trained=None,
                skip=("cost_field",)):
    """One world's digest against a JAX digest `want` (leaf -> digest):
    sha256, f32 leaves within FLOAT_RTOL of their sums, and the leaves
    `trained(leaf)` returns an array for element by element within the
    RL tolerance (`got` carries them whole)."""
    bad = []
    for k, d in want.items():
        if k in skip:
            continue
        if k not in got:
            bad.append((k, "missing"))
            continue
        ref = trained(k) if trained else None
        if ref is None:
            bad += mesh.diff_digests({k: d}, {k: got[k]}, rtol=FLOAT_RTOL)
            continue
        scale = min(1.0, float(np.abs(ref).max(initial=0.0)))
        if not np.allclose(got[k]["array"], ref, rtol=RL_TRAINED_RTOL,
                           atol=RL_TRAINED_ATOL * scale):
            bad.append((k, "trained floats past the tolerance"))
    if bad:
        raise AssertionError(f"{name}: leaves differ from JAX's: {bad[:8]}")


def mesh_launches(name, per_rank: list, need: dict):
    """Each rank's launches: K1 and K9 summed over their two forms (a
    rank takes the form its own shape picks)."""
    for r, la in enumerate(per_rank):
        got = dict(la, k1=la["decide_move"] + la["decide_move_blocks"],
                   k9=la["mega"] + la["mega_worlds"])
        check_launches(f"{name}, rank {r}", got, need)


def phase_mesh(cfg, world, keys, ref, card, HE, mesh, prng, Config):
    """The sharded world batches on the card (see the module docstring,
    group `mesh`)."""
    from trafficsimulation_tpu_torch import dryrun
    from trafficsimulation_tpu_torch.parallel import launch, ranks
    t_start = time.perf_counter()
    mesh_refs(cfg, world, keys, HE, mesh, prng, Config)
    t_refs = time.perf_counter() - t_start
    torch.cuda.empty_cache()
    with open(os.path.join(ROOT, RL_BATCH_DIGEST)) as f:
        rl_dig = json.load(f)
    with open(os.path.join(ROOT, MESH_DIGEST)) as f:
        mesh_dig = json.load(f)
    with open(os.path.join(ROOT, CONFIG4_DIGEST)) as f:
        c4_dig = json.load(f)
    z_rl = np.load(os.path.join(ROOT, RL_BATCH_DIGEST.replace(
        "digest.json", "trained.npz")))
    z_mesh = np.load(os.path.join(ROOT, MESH_DIGEST.replace(
        "digest.json", "trained.npz")))
    rec = rl_dig["shared"]["RL_A2C_BATCHED"]
    n_rl = rl_dig["ticks"]
    jobs = [
        dict(kind="rollouts", cfg=cfg, keys=keys, ticks=N_REF_TICKS,
             world="headline", paths=(False, True)),
        dict(kind="cities", cfg=Config(**CONFIG4), key=prng.PRNGKey(0),
             n_worlds=CONFIG4_WORLDS, ticks=CONFIG4_TICKS,
             paths=(False, True)),
        # the dry run's rank body (`dryrun.dryrun_rank`, what
        # `dryrun_multichip` spawns), in this spawn: a spawn of its own
        # would start four more processes (~17 s)
        dict(kind="dryrun", n_worlds=mesh_dig["dryrun_worlds"], ticks=1),
        dict(kind="rollouts", ranks=MESH_RL_RANKS, cfg=Config(**rec["cfg"]),
             keys=prng.split(prng.PRNGKey(0), rl_dig["shared_b"]),
             ticks=n_rl, whole=dryrun.TRAINED)]
    t0, wall0 = time.perf_counter(), time.time()
    out = launch.spawn(ranks.run_jobs, MESH_RANKS, "gloo", args=(jobs,))
    t_spawn = time.perf_counter() - t0
    head, c4, dr, rl = ([o[j] for o in out] for j in range(4))
    timing = {
        "ready_s": [round(o[0]["started_at"] - wall0, 2) for o in out],
        "job_s": {name: [round(r["job_s"], 2) for r in res if r]
                  for name, res in (("headline", head), ("config4", c4),
                                    ("dryrun", dr), ("rl", rl))},
        "build_s": {name: [round(r["build_s"], 2) for r in res if r]
                    for name, res in (("headline", head), ("config4", c4),
                                      ("rl", rl))},
        "digest_s": {f"{name} {p}": round(res[0][p]["digest_s"], 2)
                     for name, res in (("headline", head), ("config4", c4))
                     for p in ("per_tick", "mega")}}
    log(f"mesh: {MESH_RANKS} ranks spawned and done in {t_spawn:.2f} s; "
        f"seconds after the spawn each rank began (process start, CUDA, "
        f"imports): {timing['ready_s']}; per job and rank {timing['job_s']}"
        f"; building its slice {timing['build_s']}; rank 0 hashing and "
        f"gathering {timing['digest_s']}")
    segs = -(-N_REF_TICKS // cfg.PATHFINDING_COOLDOWN)
    segs4 = -(-CONFIG4_TICKS // cfg.PATHFINDING_COOLDOWN)
    rep = {"ranks": MESH_RANKS, "backend": "gloo", "card": card,
           "spawn_s": t_spawn, "refs_s": t_refs, "timing": timing}

    # the headline's 16 rollouts, 4 a rank, on both paths
    jax_end = {k: mesh.leaf_digest(v) for k, v in ref["end"].items()}
    for path, need in (
            ("per_tick", {"k1": N_REF_TICKS, "build_sdir_batched": segs,
                          "build_wavefront": segs, "prefix_planes":
                          N_REF_TICKS, "k9": 0, "build_sdir": 0,
                          "select_rows": 0, "rain_ticks": N_REF_TICKS}),
            ("mega", {"k9": segs, "build_sdir_batched": segs,
                      "build_wavefront": segs, "k1": 0, "prefix_planes": 0,
                      "ordered_add": 0, "build_sdir": 0})):
        single = REF[f"b16_{path}"]
        got = head[0][path]["digests"]
        mesh_same(f"headline B={BATCH}, {path} path, {MESH_RANKS} ranks",
                  single["digests"], got, mesh)
        mesh_vs_jax(f"headline world 0, {path} path, sharded", jax_end,
                    got[0], mesh, skip=())
        mesh_launches(f"headline {path} path", [h[path]["launches"]
                                                for h in head], need)
        fleet = [h[path]["fleet"] for h in head]
        if any(f != single["fleet"] for f in fleet):
            raise AssertionError(f"headline {path}: fleet metrics {fleet} "
                                 f"vs the single process's "
                                 f"{single['fleet']}")
        forms = [h[path]["forms"] for h in head]
        log(f"mesh: headline B={BATCH} as {MESH_RANKS} ranks x "
            f"{BATCH // MESH_RANKS} ({path} path): every world equals the "
            f"single-process run bit for bit (every leaf), world 0 JAX's "
            f"end state; fleet {fleet[0]} "
            f"equal; rank 0's launches {head[0][path]['launches']}"
            f"; forms per rank {forms}, single process {single['forms']}; "
            f"seconds per rank {[round(h[path]['seconds'], 2) for h in head]}")
        rep[f"headline_{path}"] = {
            "forms": forms, "single_forms": single["forms"],
            "launches": [h[path]["launches"] for h in head],
            "seconds": [h[path]["seconds"] for h in head], "fleet": fleet[0]}

    # config #4: 1024 cities, 256 a rank, on both paths
    for path, need in (
            ("per_tick", {"k1": CONFIG4_TICKS, "prefix_planes":
                          CONFIG4_TICKS, "build_sdir": segs4,
                          "build_wavefront": segs4, "k9": 0,
                          "build_sdir_batched": 0, "select_rows": 0}),
            ("mega", {"k9": segs4, "build_sdir": segs4,
                      "build_wavefront": segs4, "k1": 0, "prefix_planes": 0,
                      "build_sdir_batched": 0})):
        single = REF[f"config4_{path}"]
        got = c4[0][path]["digests"]
        mesh_same(f"config #4, {path} path, {MESH_RANKS} ranks",
                  single["digests"], got, mesh)
        for b in range(c4_dig["worlds"]):
            if single["quirks"].get(b):
                continue
            mesh_vs_jax(f"config #4 world {b}, {path} path, sharded",
                        c4_dig[f"chunk{CONFIG4_TICKS}"][b], got[b], mesh,
                        skip=())
        mesh_launches(f"config #4 {path} path",
                      [r[path]["launches"] for r in c4], need)
        fleet = [r[path]["fleet"] for r in c4]
        if any(f != single["fleet"] for f in fleet):
            raise AssertionError(f"config #4 {path}: fleet metrics {fleet} "
                                 f"vs the single process's "
                                 f"{single['fleet']}")
        forms = [r[path]["forms"] for r in c4]
        log(f"mesh: config #4 ({CONFIG4_WORLDS} cities) as {MESH_RANKS} "
            f"ranks x {CONFIG4_WORLDS // MESH_RANKS} ({path} path): every "
            f"world equals the single-process run bit for bit, worlds 0-3 "
            f"JAX's digest (but quirk worlds "
            f"{[b for b, q in single['quirks'].items() if q]}); fleet "
            f"{fleet[0]} equal; K1 / K9 forms per rank {forms}, single "
            f"process {single['forms']}; seconds per rank "
            f"{[round(r[path]['seconds'], 2) for r in c4]}")
        rep[f"config4_{path}"] = {
            "forms": forms, "single_forms": single["forms"],
            "launches": [r[path]["launches"] for r in c4],
            "seconds": [r[path]["seconds"] for r in c4], "fleet": fleet[0]}

    # RL: the A2C crossroad shared batch of 4 as 2 ranks x 2
    got = rl[0]["per_tick"]["digests"]
    for b in range(rl_dig["shared_b"]):
        mesh_vs_jax(f"A2C shared batch world {b}, {MESH_RL_RANKS} ranks",
                    rec[f"tick{n_rl}"][b], got[b], mesh,
                    trained=lambda k, b=b: z_rl[
                        f"shared|RL_A2C_BATCHED|tick{n_rl}|{b}|{k}"]
                    if k.startswith(dryrun.TRAINED) else None)
    if rl[MESH_RL_RANKS:] != [None] * (MESH_RANKS - MESH_RL_RANKS):
        raise AssertionError("ranks outside the RL job's mesh ran it")
    log(f"mesh: the A2C crossroad shared batch of {rl_dig['shared_b']} as "
        f"{MESH_RL_RANKS} ranks x {rl_dig['shared_b'] // MESH_RL_RANKS}, "
        f"{n_rl} ticks: integer leaves JAX's digest, trained floats within "
        f"rtol {RL_TRAINED_RTOL} / atol {RL_TRAINED_ATOL} x max")

    # the dry run: 8 crossroads training A2C, 2 a rank
    totals = [r["total"] for r in dr]
    if totals != [mesh_dig["dryrun_total"]] * MESH_RANKS:
        raise AssertionError(f"dry run totals {totals} vs JAX's "
                             f"{mesh_dig['dryrun_total']}")
    for b, g in enumerate(dr[0]["digests"][0]):
        mesh_vs_jax(f"dry run world {b}", mesh_dig["dryrun_tick1"][b], g,
                    mesh, trained=lambda k, b=b: z_mesh[
                        f"dryrun_tick1|{b}|{k}"]
                    if k.startswith(dryrun.TRAINED) else None, skip=())
    log(f"mesh: the dry run (dryrun_rank) as {MESH_RANKS} ranks x "
        f"{mesh_dig['dryrun_worlds'] // MESH_RANKS}: the A2C update moved "
        f"the parameters on every rank, the all-reduced total {totals[0]} "
        f"is JAX's, its {mesh_dig['dryrun_worlds']} worlds after one tick "
        f"JAX's mesh digest; launches per rank "
        f"{[r['launches'] for r in dr][:1]}")
    rep.update(dryrun_launches=[r["launches"] for r in dr],
               phase_s=time.perf_counter() - t_start)
    REPORT["mesh"] = rep
    return {"mesh": head[0]["per_tick"]["launches"],
            "mesh_mega": head[0]["mega"]["launches"]}


def phase_mesh_scaling(cfg, keys, card):
    """Development timing, no gate: the headline's B = 16 rollouts split
    over 1, 2 and 4 ranks on the one card (gloo), both paths; the
    aggregate steps/s (worlds x ticks over the slowest rank's wall) and
    each rank's device idle share."""
    from trafficsimulation_tpu_torch.parallel import launch, ranks
    rep = {"card": card, "ticks": MESH_SCALING_TICKS}
    for n in MESH_SCALING:
        out = launch.spawn(ranks.run_jobs, n, "gloo", args=([dict(
            kind="scaling", cfg=cfg, keys=keys, ticks=MESH_SCALING_TICKS,
            profile=MESH_SCALING_PROFILE)],))
        res = [o[0] for o in out]
        for path in ("mega", "per_tick"):
            wall = max(r[path]["wall_s"] for r in res)
            agg = BATCH * MESH_SCALING_TICKS / wall
            idle = [round(r[path]["idle_share"], 3) for r in res]
            busy = [round(r[path]["busy_ms_per_tick"], 3) for r in res]
            log(f"mesh_scaling ({card}): {n} rank(s) x {BATCH // n} worlds, "
                f"{path} path: {agg:.2f} world-steps/s ({MESH_SCALING_TICKS}"
                f" ticks in {wall:.3f} s on the slowest rank), device busy "
                f"ms a tick per rank {busy}, idle share per rank {idle}")
            rep[f"{n}_{path}"] = {"world_steps_per_s": agg, "wall_s": wall,
                                  "busy_ms_per_tick": busy, "idle": idle}
    REPORT["mesh_scaling"] = rep

SPATIAL_RANKS = 4           # ranks sharing the one card over gloo
SPATIAL_SPLITS = (2, 4)     # the headline split over 2, then 4 of them
SPATIAL_SCALING = (1, 2, 4)
SPATIAL_SCALING_TICKS = 25
SPATIAL_SCALING_PROFILE = 10
SPATIAL_DIGEST = os.path.join("trafficsimulation_tpu_torch", "data",
                              "spatial_digest.json")
# the slab windows whose kernels are held to their plain versions:
# (ranks, rank): an edge and an inner rank of 4, the first of 2
SPATIAL_WINDOWS = ((4, 0), (4, 1), (2, 0))


def spatial_kernels(cfg, world, HE, tsim, spatial) -> dict:
    """K1-K4 at the shapes a split headline gives them: the first tick's
    inputs of the unsharded run cut to a rank's windows (the split's own
    first-tick inputs there: every input is exact on its window) for the
    ranks of SPATIAL_WINDOWS; K1 and K2 on the decide window, K3 on the
    route window, K4 on the own rows.  Each against its plain version."""
    ins = tick_inputs_of(cfg, world, HE, tsim, (
        "decide_move", "build_sdir", "build_wavefront", "prefix_planes"))
    (kcfg, *a), kw = ins["decide_move"]
    if kw.get("hier") is not None:
        raise AssertionError("the headline tick ran K1-hier")
    (K0, pen4, legal4, tp2), _ = ins["build_sdir"]
    (wcfg, allowed, road, hard), _ = ins["build_wavefront"]
    (occ,), _ = ins["prefix_planes"]
    H, W, D = cfg.HEIGHT, cfg.WIDTH, K0.shape[0]
    P, Q = spatial.halo_widths(cfg)
    out = {}
    for n, r in SPATIAL_WINDOWS:
        slab = spatial.Slab(H=H, W=W, rank=r, size=n, P=P, Q=Q)
        (d0, d1), (r0, r1), (o0, o1) = slab.dec, slab.route, slab.own

        def cut(x, lo, hi):
            return x[..., lo:hi, :].contiguous()
        sd = cut(a[0], d0, d1)
        wnd = cut(a[1], d0, d1)
        planes = tuple(cut(p, d0, d1) for p in a[2])
        masks = tuple(cut(m, d0, d1) for m in a[3:6])
        inter, dest = cut(a[6], d0, d1), cut(a[7], d0, d1)
        rnd = tuple(cut(x, d0, d1) for x in a[8])
        hd, hr, ho = d1 - d0, r1 - r0, o1 - o0
        tag = f"rank {r} of {n}"
        present = int((planes[0] & 1).sum())
        kb, ko = k1_cost(planes, kcfg, shared_geometry=True)
        k1 = measure(
            f"decide_move on the decide window of {tag}",
            lambda: HE.decide_move(kcfg, sd, wnd, planes, *masks, inter,
                                   dest, rnd),
            lambda: HE.decide_move_core(kcfg, sd, wnd, *planes, *masks,
                                        inter, dest, *rnd),
            kb, ko, f"{hd}x{W} (rows {d0}-{d1} of {H}), D4 = "
            f"{sd.shape[0]}, {present} vehicles", reps=10)
        k0, p4, l4 = cut(K0, d0, d1), cut(pen4, d0, d1), cut(legal4, d0, d1)
        D4 = (D + 3) // 4
        k2 = measure(
            f"build_sdir on the decide window of {tag}",
            lambda: (HE.build_sdir(k0, p4, l4, tp2),),
            lambda: (HE.sdir_encode(k0, p4, l4, tp2),),
            D * 4 * hd * W * 4 + 2 * 4 * hd * W * 4 + D4 * hd * W * 4,
            (D * hd * W * SDIR_ALU_OPS, D * hd * W * SDIR_OPS),
            f"{hd}x{W}, D = {D}", reps=10, plain_reps=2)
        del k0
        al, rd, hh = (cut(x, r0, r1) for x in (allowed, road, hard))
        k3 = measure(
            f"build_wavefront on the route window of {tag}",
            lambda: (HE.build_wavefront(wcfg, al, rd, hh),),
            lambda: (HE.wavefront_core(wcfg, al, rd, hh),),
            hr * W * 7, (hr * W * 4 * 4 * 2
                         * cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS,) * 2,
            f"{hr}x{W} (rows {r0}-{r1})", reps=10)
        oc = cut(occ, o0, o1)
        k4 = measure(
            f"prefix_planes on the own rows of {tag}",
            lambda: HE.prefix_planes(oc), lambda: HE.prefix_planes_plain(oc),
            ho * W * 12, (0, ho * W * 2), f"{ho}x{W} (rows {o0}-{o1})",
            lib=lambda: (torch.cumsum(oc, -1, dtype=torch.int32),
                         torch.cumsum(oc, -2, dtype=torch.int32)))
        out[f"{n}:{r}"] = {"decide_move": k1, "build_sdir": k2,
                           "build_wavefront": k3, "prefix_planes": k4}
    torch.cuda.empty_cache()
    return out


def phase_spatial(cfg, world, card, HE, tsim, transfer, mesh, Config):
    """One world split over ranks by rows on the card (see the module
    docstring, group `spatial`)."""
    from trafficsimulation_tpu_torch.dryrun import TRAINED, dryrun_cfg
    from trafficsimulation_tpu_torch.parallel import launch, ranks, spatial
    t_start = time.perf_counter()
    with mega_env(False):
        end = tsim.run_chunk(cfg, world, N_REF_TICKS)
    want = {k: mesh.leaf_digest(v) for k, v in
            transfer.world_to_numpy(end).items()}
    del end
    with open(os.path.join(ROOT, SPATIAL_DIGEST)) as f:
        dig = json.load(f)
    z = np.load(os.path.join(ROOT, SPATIAL_DIGEST.replace(
        "digest.json", "trained.npz")))
    torch.cuda.empty_cache()
    jobs = [dict(kind="spatial", cfg=cfg, ticks=N_REF_TICKS,
                 world="headline", splits=SPATIAL_SPLITS, mega_env=True),
            dict(kind="spatial", cfg=dryrun_cfg(), ticks=dig["ticks"],
                 splits=(SPATIAL_RANKS,))]
    t0 = time.perf_counter()
    out = launch.spawn(ranks.run_jobs, SPATIAL_RANKS, "gloo", args=(jobs,))
    t_spawn = time.perf_counter() - t0
    P, Q = spatial.halo_widths(cfg)
    H, W = cfg.HEIGHT, cfg.WIDTH
    segs = -(-N_REF_TICKS // cfg.PATHFINDING_COOLDOWN)
    need = {"k1": N_REF_TICKS, "prefix_planes": N_REF_TICKS,
            "build_sdir": segs, "build_wavefront": segs, "k9": 0,
            "build_sdir_batched": 0, "select_rows": 0,
            "rain_ticks": N_REF_TICKS}
    rep = {"ranks": SPATIAL_RANKS, "backend": "gloo", "card": card,
           "spawn_s": t_spawn, "halo": [P, Q]}
    for n in SPATIAL_SPLITS:
        res = [o[0][str(n)] for o in out[:n]]
        got = res[0]["digests"]
        bad = mesh.diff_digests(want, {k: {x: v[x] for x in v if x !=
                                           "array"} for k, v in got.items()})
        if bad:
            raise AssertionError(f"spatial: the headline split over {n} "
                                 f"ranks differs from the one-process run: "
                                 f"{bad[:8]}")
        mesh_launches(f"spatial headline over {n} ranks",
                      [x["launches"] for x in res], need)
        rows = []
        for x in res:
            r = x["rank"]
            d0, d1 = x["dec"]
            lim = (H // n + (P if r in (0, n - 1) else 2 * P)) / H
            share = x["cost_field_bytes"] / (x["cost_field_shape"][0] * 4
                                             * H * W * 4)
            if share > lim + 1e-12 or x["cost_field_shape"][2] != d1 - d0:
                raise AssertionError(f"spatial: rank {r} of {n} holds "
                                     f"{share:.4%} of the key stack "
                                     f"(limit {lim:.4%})")
            rows.append({
                "rank": r, "own": x["own"], "dec": x["dec"],
                "route": x["route"], "cost_field_bytes":
                x["cost_field_bytes"], "cost_field_share": share,
                "peak_allocated_bytes": x["peak_bytes"],
                "collectives_per_tick": x["stats"]["all_reduce"]
                / N_REF_TICKS,
                "collective_bytes_per_tick": x["stats"]["bytes"]
                / N_REF_TICKS,
                "collective_host_ms_per_tick": x["stats"]["host_s"] * 1e3
                / N_REF_TICKS,
                "largest_collective_bytes": x["stats"]["largest"],
                "seconds": x["seconds"], "shard_s": x["shard_s"],
                "gather_s": x["gather_s"], "launches": x["launches"]})
            log(f"spatial ({card}): headline over {n} ranks, rank {r}: "
                f"rows {x['own']}, decide window {x['dec']}, route window "
                f"{x['route']}; key stack {x['cost_field_bytes']} bytes "
                f"({share:.4%} of the whole, limit {lim:.4%}); peak "
                f"allocated {x['peak_bytes']} bytes; "
                f"{rows[-1]['collectives_per_tick']:.3f} all-reduces a tick "
                f"({rows[-1]['collective_bytes_per_tick']:.0f} bytes, "
                f"{rows[-1]['collective_host_ms_per_tick']:.3f} host ms); "
                f"{N_REF_TICKS} ticks in {x['seconds']:.3f} s; launches "
                f"{ {k: v for k, v in x['launches'].items() if v} }")
        log(f"spatial: the headline split over {n} ranks (TSIM_MEGA_FORCE "
            f"set, no K9 launch) equals the one-process {N_REF_TICKS}-tick "
            f"end state on all {len(want)} leaves by sha256, f32 included")
        rep[f"headline_{n}"] = rows

    # the dry run's crossroad over 4 ranks against JAX's digest
    got = out[0][1][str(SPATIAL_RANKS)]["digests"]
    bad = []
    for k, d in dig["digest"].items():
        if k.startswith(TRAINED):
            ref = z[k]
            scale = min(1.0, float(np.abs(ref).max(initial=0.0)))
            if not np.allclose(got[k]["array"], ref, rtol=RL_TRAINED_RTOL,
                               atol=RL_TRAINED_ATOL * scale):
                bad.append((k, "trained floats past the tolerance"))
        elif got[k]["sha256"] != d["sha256"]:
            bad.append((k, "sha256"))
    if bad or set(got) != set(dig["digest"]):
        raise AssertionError(f"spatial: the crossroad over {SPATIAL_RANKS} "
                             f"ranks differs from JAX's: {bad[:8]}")
    log(f"spatial: the dry run's crossroad split over {SPATIAL_RANKS} ranks "
        f"for {dig['ticks']} ticks equals JAX's spatial_chunk_fn on "
        f"{dig['devices']} devices (integers by sha256, trained floats "
        f"within rtol {RL_TRAINED_RTOL})")
    rep["kernels"] = spatial_kernels(cfg, world, HE, tsim, spatial)
    rep["phase_s"] = time.perf_counter() - t_start
    REPORT["spatial"] = rep
    return out[0][0][str(SPATIAL_RANKS)]["launches"], rep["kernels"]


SPATIAL_HIER_TICKS = 10      # two routing segments of config #5
SPATIAL_PEDS_TICKS = 23
# the windows whose K1-hier and pedestrian step are held to their plain
# versions: an edge and an inner rank of 4
SPATIAL_EDGE_INNER = ((4, 0), (4, 1))
CONFIG5_START = {}    # "world": (cfg, world, build seconds), phase_config5's
CONFIG3_START = {}    # "world": (cfg, world), phase_config3's


def split_need(cfg, ticks: int, peds: bool = False) -> dict:
    """Each rank's launches over `ticks` ticks of a split world: K1 (or
    K1-hier) and K4 a tick, K2 and K3 a routing segment, no K9, K5 or K6;
    rain a tick where it is on, the pedestrian step a tick with them."""
    segs = -(-ticks // max(1, cfg.PATHFINDING_COOLDOWN))
    return {"k1": ticks, "prefix_planes": ticks, "build_sdir": segs,
            "build_wavefront": segs, "k9": 0, "build_sdir_batched": 0,
            "select_rows": 0, "rain_ticks": ticks if cfg.RAIN_ENABLED else 0,
            "step_pedestrians": ticks if peds else 0}


def split_runs(label, cfg, path, ticks, want, need, card, mesh,
               crossings) -> tuple:
    """The world `ranks.save_world` wrote to `path`, split over 2 and 4
    of SPATIAL_RANKS ranks sharing the card (gloo) for `ticks` ticks:
    every leaf of the gathered world against the one-process digests
    `want`, each rank's launches against `need`; per rank its rows, the
    bytes of its key stack and windowed stack beside the whole world's
    and the window's limit, peak memory and collectives.  Returns (rank
    0's launches of the 4-rank run, the report)."""
    from trafficsimulation_tpu_torch.parallel import launch, ranks, spatial
    t0 = time.perf_counter()
    out = launch.spawn(ranks.run_jobs, SPATIAL_RANKS, "gloo", args=([dict(
        kind="spatial", cfg=cfg, ticks=ticks, world="file", path=path,
        splits=SPATIAL_SPLITS, mega_env=True)],))
    rep = {"spawn_s": time.perf_counter() - t0, "ticks": ticks,
           "crossings": crossings}
    P, _ = spatial.halo_widths(cfg)
    H, W = cfg.HEIGHT, cfg.WIDTH
    for n in SPATIAL_SPLITS:
        res = [o[0][str(n)] for o in out[:n]]
        got = res[0]["digests"]
        bad = mesh.diff_digests(want, {k: {x: v[x] for x in v if x !=
                                           "array"} for k, v in got.items()})
        if bad:
            raise AssertionError(f"{label}: the split over {n} ranks differs "
                                 f"from the one-process run: {bad[:8]}")
        mesh_launches(f"{label} over {n} ranks",
                      [x["launches"] for x in res], need)
        rows = []
        for x in res:
            r = x["rank"]
            d0, d1 = x["dec"]
            lim = (H // n + (P if r in (0, n - 1) else 2 * P)) / H
            stacks = {}
            for k in ("cost_field", "local_sdir4"):
                shape = x[f"{k}_shape"]
                if shape is None:
                    continue
                whole = int(np.prod(shape[:-2])) * H * W * 4
                share = x[f"{k}_bytes"] / whole
                if share > lim + 1e-12 or shape[-2] != d1 - d0:
                    raise AssertionError(f"{label}: rank {r} of {n} holds "
                                         f"{share:.4%} of {k} (limit "
                                         f"{lim:.4%})")
                stacks[k] = {"bytes": x[f"{k}_bytes"], "whole_bytes": whole,
                             "share": share, "limit": lim,
                             "shape": list(shape)}
            per_tick = x["stats"]["all_reduce"] / ticks
            rows.append({
                "rank": r, "own": x["own"], "dec": x["dec"],
                "route": x["route"], "stacks": stacks,
                "peak_allocated_bytes": x["peak_bytes"],
                "collectives_per_tick": per_tick,
                "collective_bytes_per_tick": x["stats"]["bytes"] / ticks,
                "collective_host_ms_per_tick": x["stats"]["host_s"] * 1e3
                / ticks,
                "seconds": x["seconds"], "shard_s": x["shard_s"],
                "gather_s": x["gather_s"], "launches": x["launches"]})
            log(f"{label} ({card}): over {n} ranks, rank {r}: rows "
                f"{x['own']}, decide window {x['dec']}; "
                + "; ".join(f"{k} {v['bytes']} bytes of the whole "
                            f"{v['whole_bytes']} ({v['share']:.4%}, limit "
                            f"{v['limit']:.4%})" for k, v in stacks.items())
                + f"; peak allocated {x['peak_bytes']} bytes; "
                f"{per_tick:.3f} all-reduces a tick "
                f"({rows[-1]['collective_bytes_per_tick']:.0f} bytes, "
                f"{rows[-1]['collective_host_ms_per_tick']:.3f} host ms); "
                f"{ticks} ticks in {x['seconds']:.3f} s (shard "
                f"{x['shard_s']:.3f} s, gather {x['gather_s']:.3f} s); "
                f"launches { {k: v for k, v in x['launches'].items() if v} }")
        log(f"{label}: split over {n} ranks (TSIM_MEGA_FORCE set) equals the "
            f"one-process {ticks}-tick end state on all {len(want)} leaves "
            f"by sha256, f32 included")
        rep[str(n)] = rows
    return out[0][0][str(SPATIAL_RANKS)]["launches"], rep


def chunk_digests(world, transfer, mesh) -> dict:
    return {k: mesh.leaf_digest(v) for k, v in
            transfer.world_to_numpy(world).items()}


def vehicle_crossings(cfg, world, ticks, tsim) -> tuple:
    """(the end state of `ticks` ticks in chunks of one routing segment,
    which are the segments of one chunk; per split size the vehicles
    whose row changed owner between two segments)."""
    R = max(1, cfg.PATHFINDING_COOLDOWN)
    seen, w = [world.vehicles], world
    with mega_env(False):
        for t in range(0, ticks, R):
            w = tsim.run_chunk(cfg, w, min(R, ticks - t))
            seen.append(w.vehicles)
    out = {}
    for n in SPATIAL_SPLITS:
        rows = cfg.HEIGHT // n
        out[str(n)] = sum(int((a.active & b.active & (
            torch.div(a.pos, cfg.WIDTH * rows, rounding_mode="floor")
            != torch.div(b.pos, cfg.WIDTH * rows, rounding_mode="floor")))
            .sum()) for a, b in zip(seen, seen[1:]))
    return w, out


def window_tag(n, r, lo, hi, H):
    return f"rank {r} of {n} (rows {lo}-{hi} of {H})"


def spatial_hier_kernels(cfg, world, HE, tsim, spatial) -> dict:
    """K1-hier on config #5's first-tick inputs cut to the decide windows
    of SPATIAL_EDGE_INNER, with each window's first world row, against
    its plain version (the decide core with `hier_select(row0)`)."""
    from trafficsimulation_tpu_torch.ops import hier
    (kcfg, *a), kw = tick_inputs(cfg, world, HE, tsim, "decide_move")
    local4, consts = kw["hier"]
    if kw.get("row0", 0) != 0:
        raise AssertionError("the one-process tick ran K1-hier with a row0")
    H, W = cfg.HEIGHT, cfg.WIDTH
    P, Q = spatial.halo_widths(cfg)
    out = {}
    for n, r in SPATIAL_EDGE_INNER:
        d0, d1 = spatial.Slab(H=H, W=W, rank=r, size=n, P=P, Q=Q).dec

        def cut(x):
            return x[..., d0:d1, :].contiguous()
        sd, wnd, l4 = cut(a[0]), cut(a[1]), cut(local4)
        planes = tuple(cut(p) for p in a[2])
        masks = tuple(cut(m) for m in a[3:6])
        inter, dest = cut(a[6]), cut(a[7])
        rnd = tuple(cut(x) for x in a[8])
        present = (planes[0] & 1) == 1
        p, _ = hier.hier_rows(kcfg, (planes[0] >> 18) & ((1 << 14) - 1), d0)
        n_veh = int(present.sum())
        n_win = int((present & (p >= 0)).sum())
        nbytes, ops = k1_cost(planes, kcfg, shared_geometry=True,
                              stack_words=n_veh + n_win)

        def plain(sd=sd, wnd=wnd, planes=planes, masks=masks, inter=inter,
                  dest=dest, rnd=rnd, l4=l4, d0=d0):
            return HE.decide_move_core(
                kcfg, sd, wnd, *planes, *masks, inter, dest, *rnd,
                select=lambda d: hier.hier_select(kcfg, sd, l4, d, d0))
        tile = "inside a tile" if d0 % kcfg.HIER_TILE else "on a tile edge"
        m = measure(
            f"decide_move (K1-hier) on the decide window of "
            f"{window_tag(n, r, d0, d1, H)}",
            lambda sd=sd, wnd=wnd, planes=planes, masks=masks, inter=inter,
            dest=dest, rnd=rnd, l4=l4, d0=d0: HE.decide_move(
                kcfg, sd, wnd, planes, *masks, inter, dest, rnd,
                hier=(l4, consts), row0=d0),
            plain, nbytes, ops,
            f"{d1 - d0}x{W} (rows {d0}-{d1}, first row {tile}), dense D4 = "
            f"{sd.shape[0]}, windowed D4 = {l4.shape[0]}, {n_veh} vehicles "
            f"({n_win} in their destination's window)", reps=10)
        m.update(vehicles=n_veh, in_window=n_win, row0=d0)
        out[f"{n}:{r}"] = m
    torch.cuda.empty_cache()
    return out


def spatial_ped_kernels(cfg, world, HE, tsim, spatial) -> dict:
    """The pedestrian step on config #3's inputs of the tick after the
    reference run, cut to the pedestrian windows (the decide window
    widened by `engine.PED_REACH`) of SPATIAL_EDGE_INNER, with each
    window's first world row, against its plain version."""
    from trafficsimulation_tpu_torch.agents import pedestrians
    from trafficsimulation_tpu_torch.ops import engine
    a, _ = tick_inputs(cfg, world, HE, tsim, "step_pedestrians")
    pcfg, walk, cross, cell, stop, seeds, n_side = a
    H, W = cfg.HEIGHT, cfg.WIDTH
    P, Q = spatial.halo_widths(cfg)
    out = {}
    for n, r in SPATIAL_EDGE_INNER:
        lo, hi = spatial.Slab(H=H, W=W, rank=r, size=n, P=P, Q=Q).window(
            P + engine.PED_REACH)

        def cut(x):
            return x[..., lo:hi, :].contiguous()
        wk, cr, ct, st = cut(walk), cut(cross), cut(cell), cut(stop)
        nbytes, ops = ped_cost(wk, ct, 1)
        out[f"{n}:{r}"] = measure(
            f"step_pedestrians on the pedestrian window of "
            f"{window_tag(n, r, lo, hi, H)}",
            lambda wk=wk, cr=cr, ct=ct, st=st, lo=lo: HE.step_pedestrians(
                pcfg, wk, cr, ct, st, seeds, n_side, row0=lo),
            lambda wk=wk, cr=cr, ct=ct, st=st, lo=lo:
            pedestrians.step_pedestrians_plain(
                pcfg, wk, cr, ct, st, seeds, n_side, row0=lo),
            nbytes, ops, f"{hi - lo}x{W} (rows {lo}-{hi}), tick "
            f"{int(world.tick)}, {int(wk.sum() + cr.sum())} pedestrians",
            plain_reps=5)
        out[f"{n}:{r}"]["row0"] = lo
    torch.cuda.empty_cache()
    return out


def phase_spatial_hier(card, HE, tsim, transfer, mesh, prng, Config):
    """Config #5 at full size split over ranks by rows (group
    `spatial_hier`, see the module docstring)."""
    import tempfile
    from trafficsimulation_tpu_torch.parallel import ranks, spatial
    t_start = time.perf_counter()
    if "world" in CONFIG5_START:
        cfg, world, t_build = CONFIG5_START.pop("world")
    else:
        world, t_build = timed(lambda: tsim.init_world_hier(
            Config(**CONFIG5), prng.PRNGKey(0), "cuda"))
        cfg, world = world
        world = tsim.inject_vehicles(cfg, world, CONFIG5_VEHICLES)
    end, crossings = vehicle_crossings(cfg, world, SPATIAL_HIER_TICKS, tsim)
    if not all(c > 0 for c in crossings.values()):
        raise AssertionError(f"spatial_hier: no vehicle crossed a slab "
                             f"edge: {crossings}")
    want = chunk_digests(end, transfer, mesh)
    del end
    log(f"spatial_hier: config #5's one-process {SPATIAL_HIER_TICKS} ticks; "
        f"vehicles whose row changed owner between routing segments, by "
        f"ranks: {crossings}")
    kern = spatial_hier_kernels(cfg, world, HE, tsim, spatial)
    with tempfile.TemporaryDirectory(prefix="tsim_split_") as tmp:
        path = os.path.join(tmp, "config5.pt")
        _, t_save = timed(lambda: ranks.save_world(world, path))
        del world
        torch.cuda.empty_cache()
        launches, rep = split_runs(
            "spatial_hier (config #5)", cfg, path, SPATIAL_HIER_TICKS, want,
            split_need(cfg, SPATIAL_HIER_TICKS), card, mesh, crossings)
    rep.update(card=card, kernels=kern, build_s=t_build, save_s=t_save,
               phase_s=time.perf_counter() - t_start)
    log(f"spatial_hier ({card}): world built in {t_build:.2f} s in this "
        f"process, written in {t_save:.2f} s for rank 0; spawn, shard, run "
        f"and gather over 2 and 4 ranks {rep['spawn_s']:.2f} s; group "
        f"{rep['phase_s']:.2f} s")
    REPORT["spatial_hier"] = rep
    return launches, kern


def phase_spatial_peds(card, HE, tsim, transfer, mesh, prng, Config):
    """Config #3 split over ranks by rows (group `spatial_peds`, see the
    module docstring)."""
    import tempfile
    from trafficsimulation_tpu_torch.agents import pedestrians
    from trafficsimulation_tpu_torch.parallel import ranks, spatial
    t_start = time.perf_counter()
    if "world" in CONFIG3_START:
        cfg, world = CONFIG3_START.pop("world")
    else:
        cfg, world = config3_world(tsim, prng, Config)
    ticks = SPATIAL_PEDS_TICKS
    flows = []
    step = HE.step_pedestrians

    def spy(c, walk, cross, cell, stop, seeds, n_side, row0=0):
        flows.append(pedestrians.step_pedestrians_plain(
            c, walk, cross, cell, stop, seeds, n_side, row0, flux=True)[4])
        return step(c, walk, cross, cell, stop, seeds, n_side, row0)
    HE.step_pedestrians = spy
    try:
        with mega_env(False):
            end = tsim.run_chunk(cfg, world, ticks)
    finally:
        HE.step_pedestrians = step
    crossed = {}
    for n in SPATIAL_SPLITS:
        h = cfg.HEIGHT // n
        crossed[str(n)] = sum(int(f[0, b * h - 1].sum() + f[2, b * h].sum())
                              for f in flows for b in range(1, n))
    if len(flows) != ticks or not all(c > 0 for c in crossed.values()):
        raise AssertionError(f"spatial_peds: {len(flows)} pedestrian steps, "
                             f"walkers across slab edges {crossed}")
    want = chunk_digests(end, transfer, mesh)
    peds = int(end.peds.walk.sum() + end.peds.cross.sum())
    log(f"spatial_peds: config #3's one-process {ticks} ticks, {peds} "
        f"pedestrians; walkers and crossers that stepped across a slab "
        f"edge, by ranks: {crossed}")
    kern = spatial_ped_kernels(cfg, end, HE, tsim, spatial)
    del end
    with tempfile.TemporaryDirectory(prefix="tsim_split_") as tmp:
        path = os.path.join(tmp, "config3.pt")
        ranks.save_world(world, path)
        del world
        torch.cuda.empty_cache()
        launches, rep = split_runs(
            "spatial_peds (config #3)", cfg, path, ticks, want,
            split_need(cfg, ticks, peds=True), card, mesh, crossed)
    rep.update(card=card, kernels=kern, pedestrians=peds,
               phase_s=time.perf_counter() - t_start)
    log(f"spatial_peds ({card}): group {rep['phase_s']:.2f} s")
    REPORT["spatial_peds"] = rep
    return launches, kern


def phase_spatial_scaling(cfg, card):
    """Development timing, no gate: the headline world split over 1, 2
    and 4 ranks on the one card (gloo), the per-tick path."""
    from trafficsimulation_tpu_torch.parallel import launch, ranks
    out = launch.spawn(ranks.run_jobs, max(SPATIAL_SCALING), "gloo",
                       args=([dict(kind="spatial_scaling", cfg=cfg,
                                   ticks=SPATIAL_SCALING_TICKS,
                                   profile=SPATIAL_SCALING_PROFILE,
                                   splits=SPATIAL_SCALING)],))
    rep = {"card": card, "ticks": SPATIAL_SCALING_TICKS}
    for n in SPATIAL_SCALING:
        res = [o[0][str(n)] for o in out[:n]]
        wall = max(r["wall_s"] for r in res)
        rate = SPATIAL_SCALING_TICKS / wall
        cols = {k: [round(r[k], 4) for r in res] for k in (
            "busy_ms_per_tick", "idle_share", "collectives_per_tick",
            "collective_host_ms_per_tick", "collective_bytes_per_tick")}
        log(f"spatial_scaling ({card}): the headline over {n} rank(s): "
            f"{rate:.2f} world-steps/s ({SPATIAL_SCALING_TICKS} ticks in "
            f"{wall:.3f} s on the slowest rank); per rank {cols}")
        rep[str(n)] = dict(world_steps_per_s=rate, wall_s=wall, **cols)
    REPORT["spatial_scaling"] = rep


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the build log and report")
    ap.add_argument("--only", nargs="+", choices=PHASES + DEV_PHASES,
                    help="run only these groups of phases (development; "
                    "no contract line is printed)")
    ap.add_argument("--tree", default=ROOT,
                    help="import the port from this source tree, e.g. an "
                    "unpacked older commit to time beside this one "
                    "(development; with --only and groups of "
                    "TREE_PHASES)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    if tree != ROOT and not set(args.only or PHASES) <= set(TREE_PHASES):
        ap.error(f"--tree takes --only with groups of {TREE_PHASES}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    import importlib
    import pkgutil
    import trafficsimulation_tpu_torch as pkg
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(info.name)
    from trafficsimulation_tpu_torch import prng, snapshot
    from trafficsimulation_tpu_torch import sim as tsim
    from trafficsimulation_tpu_torch.config import Config
    from trafficsimulation_tpu_torch.core import transfer
    from trafficsimulation_tpu_torch.ops import build, engine
    from trafficsimulation_tpu_torch.ops import hopper_engine as HE
    from trafficsimulation_tpu_torch.parallel import mesh
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "trafficsimulation_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded {loaded[:5]}")
    run = set(args.only or PHASES)

    t_start = time.perf_counter()
    card = card_line()
    global PEAK_ALU
    PEAK_ALU, sms, mhz = alu_rate()
    log(f"ALU rate for the integer kernels' bounds: {sms} SMs x "
        f"{ALU_LANES} lanes x {mhz:g} MHz = {PEAK_ALU / 1e12:.2f} T/s, "
        f"{2 * PEAK_ALU / 1e12:.2f} T/s with the FMA pipe's IMAD (FP32 "
        f"{PEAK_F32 / 1e12:g} T/s, bytes {PEAK_BYTES / 1e12:g} TB/s)")
    REPORT["peaks"] = {"alu": PEAK_ALU, "f32": PEAK_F32,
                       "bytes": PEAK_BYTES, "sms": sms, "max_sm_mhz": mhz}
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, numpy {np.__version__}, python "
        f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.load()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds if build.build_seconds else 0:.1f} s)")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_nvcc.log"), "w") as f:
            f.write(build.build_log)

    def stamp(name):
        REPORT.setdefault("phase_end_s", {})[name] = \
            time.perf_counter() - t_start
        log(f"[{time.perf_counter() - t_start:.1f} s] {name} done")

    if "kernels" in run:
        cfg0 = snapshot.config_from_json(
            str(np.load(snapshot.HEADLINE)["meta.cfg_json"]))
        single = phase_kernels(cfg0, HE, engine, 0)
        batched = phase_kernels(cfg0, HE, engine, BATCH)
        batched["build_sdir_batched"]["code"] = k5_code(
            build, args.out, batched["build_sdir_batched"]["ops"][1]
            // SDIR_OPS)
        phase_batch_one(cfg0, HE, engine)
        k6 = phase_select_rows(HE)
        k_rain = phase_rain_ticks(HE)
        k_ped = phase_pedestrians(HE)
        floor = launch_floor_ms(HE)
        log(f"one launch with no work: {floor:.4f} ms")
        REPORT["launch_floor_ms"] = floor
        stamp("kernels")
    if "ordered_add" in run:
        phase_ordered_add(HE)
    if run & {"ordered_add", "headline", "mega", "mega_batch", "tiled",
              "render", "bridge", "mesh", "mesh_scaling", "spatial",
              "spatial_scaling"}:
        cfg, world, ref = phase_generation(snapshot, tsim, transfer, prng,
                                           Config)
        mesh_keys = batch_keys(world.key, prng)
        stamp("generation")
    if "mesh_scaling" in run:
        phase_mesh_scaling(cfg, mesh_keys, card)
        stamp("mesh_scaling")
    if "spatial_scaling" in run:
        phase_spatial_scaling(cfg, card)
        stamp("spatial_scaling")
    if "ordered_add" in run:
        k_add = ordered_add_tick(cfg, world, HE, tsim, "the headline")
        REPORT["ordered_add"] = k_add
        k_rain_path = rain_tick_path(cfg, world, HE, tsim)
        REPORT["rain_ticks_path"] = k_rain_path
        stamp("ordered_add")
    if "tiled" in run:
        k7 = phase_tiled(cfg, world, HE, tsim)
        torch.cuda.empty_cache()
        stamp("tiled")
    if "render" in run:
        k8 = phase_render(cfg, world, HE, tsim, snapshot)
        torch.cuda.empty_cache()
        stamp("render")
    if "bridge" in run:
        l_bridge = phase_bridge(cfg, world, HE, tsim, card)
        stamp("bridge")
    if "mega" in run:
        l_mega, k9 = phase_mega(cfg, world, ref, card, HE, engine, tsim,
                                transfer)
        torch.cuda.empty_cache()
        stamp("mega")
    if "mega_batch" in run:
        l_mb, l_c4m, k_mb = phase_mega_batch(cfg, world, ref, card, HE,
                                             engine, tsim, transfer, mesh,
                                             prng, Config)
        torch.cuda.empty_cache()
        stamp("mega_batch")
    if "headline" in run:
        sim, l_single = phase_headline(HE, tsim, transfer, cfg, world, ref)
        batch, l_batch = phase_batch(cfg, world, ref, HE, mesh, tsim,
                                     transfer, prng)
        phase_throughput(cfg, sim, batch, card, HE, mesh, transfer)
        phase_service(cfg, world, HE, mesh, tsim, transfer,
                      batch_keys(world.key, prng))
        del sim, batch
        if not run & {"mesh", "spatial"}:
            del world
        torch.cuda.empty_cache()
        stamp("headline")
    if "hier_digest" in run:
        phase_hier_digest(HE, tsim, transfer, prng, snapshot, Config)
        stamp("hier_digest")
    if "config4" in run:
        l_c4, k_c4 = phase_config4(HE, engine, tsim, mesh, transfer, card,
                                   prng, Config)
        stamp("config4")
    if "config5" in run:
        l_c5, k_c5 = phase_config5(HE, engine, tsim, card, prng, Config)
        stamp("config5")
    if "config3" in run:
        l_c3, k_c3 = phase_config3(HE, tsim, transfer, card, prng, Config)
        stamp("config3")
    if "config1" in run:
        l_c1 = phase_config1(HE, tsim, transfer, card, prng, Config)
        stamp("config1")
    if "forms" in run:
        phase_forms(HE, engine, tsim, mesh, prng, Config)
        stamp("forms")
    if "select_rows" in run:
        phase_select_rows(HE)
        stamp("select_rows")
    if "rl" in run:
        from trafficsimulation_tpu_torch import utils
        l_rl = phase_rl(HE, tsim, transfer, card, prng, Config, snapshot,
                        utils)
        stamp("rl")
    if "rl_batch" in run:
        l_rlb = phase_rl_batch(HE, tsim, transfer, mesh, card, prng, Config,
                               snapshot)
        stamp("rl_batch")
    if "mesh" in run:
        l_mesh = phase_mesh(cfg, world, mesh_keys, ref, card, HE, mesh, prng,
                            Config)
        torch.cuda.empty_cache()
        stamp("mesh")
    if "spatial" in run:
        l_spatial, k_spatial = phase_spatial(cfg, world, card, HE, tsim,
                                             transfer, mesh, Config)
        stamp("spatial")
    if run & {"mesh", "spatial"}:
        del world
        torch.cuda.empty_cache()
    if "spatial_hier" in run:
        l_sh, k_sh = phase_spatial_hier(card, HE, tsim, transfer, mesh, prng,
                                        Config)
        stamp("spatial_hier")
    if "spatial_peds" in run:
        l_sp, k_sp = phase_spatial_peds(card, HE, tsim, transfer, mesh, prng,
                                        Config)
        stamp("spatial_peds")
    CONFIG5_START.clear()
    CONFIG3_START.clear()
    REPORT["seconds"] = time.perf_counter() - t_start
    log(f"chip_smoke phases took {REPORT['seconds']:.1f} s")
    if run != set(PHASES):
        if args.out:
            with open(os.path.join(args.out, "chip_smoke_report.json"),
                      "w") as f:
                json.dump(REPORT, f, indent=1)
        log(f"partial run ({sorted(run)}): no contract line")
        return 0

    launch_paths = {"single": l_single, "batched": l_batch,
                    "config5": l_c5, "mega": l_mega, "bridge": l_bridge,
                    "config4": l_c4, "config3": l_c3, "config1": l_c1,
                    "rl": l_rl, "mega_batch": l_mb, "config4_mega": l_c4m,
                    "rl_batch": l_rlb}
    summary = {"kernels": []}
    for k in KERNELS:
        path = SUMMARY_PATH.get(k, "batched")
        ctr = COUNTER.get(k, k)
        if path == "config4":
            m = k_c4[f"B={CONFIG4_WORLDS}"][k]
        elif k == "select_rows":
            m = k6["local"]
        elif k == "mega":
            m = k9["R=5"]
        elif k == "mega_batch":
            m = k_mb["b16_kernel"]
        elif k == "mega_worlds":
            m = k_mb["config4_kernel"]
        elif k == "decide_move_tiled":
            m = k7[f"{TILES[0][0]}x{TILES[0][1]}"]
        elif k == "render":
            m = k_c5["render"]
        elif k == "ordered_add":
            m = k_add
        elif k == "rain_ticks":
            m = k_rain_path
        elif k == "step_pedestrians":
            m = k_c3
        else:
            m = single[k] if path == "single" else batched[k]
        entry = {"name": k, "route": "cuda", "source": KERNELS[k][0],
                 "replaces": KERNELS[k][1],
                 "launches": launch_paths[path][ctr],
                 "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                 "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                 "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                 "device_ms": m["device_ms"],
                 "kernels_per_call": m.get("kernels_per_call"),
                 "path": path,
                 "batch": {"batched": BATCH, "config4": CONFIG4_WORLDS,
                           "mega_batch": BATCH,
                           "config4_mega": CONFIG4_WORLDS}.get(path, 1),
                 "shape": m.get("shape", f"{cfg0.HEIGHT}x{cfg0.WIDTH}, "
                                f"D = {cfg0.MAX_FIELD_DESTS}"),
                 "launches_single_path": l_single[ctr],
                 "launches_batched_path": l_batch[ctr],
                 "launches_config5_path": l_c5[ctr],
                 "launches_mega_path": l_mega[ctr],
                 "launches_bridge_path": l_bridge[ctr],
                 "launches_config4_path": l_c4[ctr],
                 "launches_config3_path": l_c3[ctr],
                 "launches_config1_path": l_c1[ctr],
                 "launches_rl_path": l_rl[ctr],
                 "launches_rl_batch_path": l_rlb[ctr],
                 "launches_mega_batch_path": l_mb[ctr],
                 "launches_config4_mega_path": l_c4m[ctr],
                 # rank 0 of the 4 that share the card (group `mesh`):
                 # the headline's rollouts, 4 of its 16
                 "launches_mesh_path": l_mesh["mesh"][ctr],
                 "launches_mesh_mega_path": l_mesh["mesh_mega"][ctr],
                 # rank 0 of the headline split over 4 ranks by rows
                 # (group `spatial`), of config #5's and config #3's
                 # (`spatial_hier`, `spatial_peds`)
                 "launches_spatial_path": l_spatial[ctr],
                 "launches_spatial_hier_path": l_sh[ctr],
                 "launches_spatial_peds_path": l_sp[ctr],
                 "on_path": k not in OFF_PATH}
        if path == "config4":
            entry["odd_batch"] = {x: k_c4[f"B={CONFIG4_ODD_B}"][k][x]
                                  for x in SUB_KEYS}
            for part in ("path", "ragged"):
                if k in k_c4[part]:
                    entry[f"config4_{part}"] = {x: k_c4[part][k][x]
                                                for x in SUB_KEYS}
        if k in single and path == "batched":
            entry["single_world"] = {x: single[k][x] for x in SUB_KEYS}
        if k == "select_rows":
            entry["bound_ms_words"] = m["bound_ms_words"]
            entry["dense_stack"] = {x: k6["dense"][x] for x in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "bound_ms_words", "shape")}
            entry["config5_dense"] = {x: k_c5["select_rows_dense"][x]
                                      for x in SUB_KEYS}
        if k == "mega":
            entry["partial_segment"] = {x: k9["R=3"][x] for x in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "shape")}
            entry["code"] = {x: k9["R=5"]["code"][x] for x in (
                "grid", "ptxas", "ptxas_batched", "barriers_a_tick")}
        if k == "decide_move_tiled":
            t1 = f"{TILES[1][0]}x{TILES[1][1]}"
            entry["tiles_" + t1] = {x: k7[t1][x] for x in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "shape")}
        if k == "decide_move":
            entry["headline_first_tick"] = {x: REPORT["tiled"]["k1"].get(x)
                                            for x in SUB_KEYS}
        if k in ("decide_move", "build_sdir", "build_wavefront",
                 "prefix_planes"):
            entry["spatial"] = {w: {x: v[k][x] for x in SUB_KEYS}
                                for w, v in k_spatial.items()}
        if k == "decide_move":
            entry["spatial_hier"] = {w: {x: v[x] for x in SUB_KEYS}
                                     for w, v in k_sh.items()}
        if k == "step_pedestrians":
            entry["spatial"] = {w: {x: v[x] for x in SUB_KEYS}
                                for w, v in k_sp.items()}
        if k == "build_sdir_batched":
            entry["code"] = {x: m["code"][x] for x in (
                "ptxas", "per_key_world", "alu_per_key_world")}
        if k == "rain_ticks":
            entry["empty_launch_ms"] = m["empty_launch_ms"]
        if k == "ordered_add":
            entry["library"] = k_add["library"]
        if k == "rain_ticks":
            entry["batch_200_ticks"] = {x: k_rain.get(x) for x in SUB_KEYS}
        if k == "step_pedestrians":
            entry["random_inputs"] = {
                label: {x: v[x] for x in SUB_KEYS}
                for label, v in k_ped.items()}
        if k == "render":
            entry["headline_256"] = {x: k8[x] for x in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "shape")}
            entry["seeded"] = {label: {x: v[x] for x in SUB_KEYS + (
                "path", "bound_share")} for label, v in k_mb["k8"].items()}
        if k in ("mega_batch", "mega_worlds"):
            entry["plan"] = m["plan"]
            entry["paths"] = k_mb["b16_paths" if k == "mega_batch"
                                  else "config4_paths"]
        if k in k_c5 and k != "render":
            entry["config5"] = {x: k_c5[k][x] for x in SUB_KEYS}
            if k == "ordered_add":
                entry["config5"]["library"] = k_c5[k]["library"]
        summary["kernels"].append(entry)
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
