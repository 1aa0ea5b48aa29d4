"""The benchmark's plain reference: the plain path of
`trafficsimulation_tpu_torch` at commit 20130c3, frozen, cut to what the
benchmark's cells run, one world at a time.

It holds generation, `measure_and_shrink`, `inject_vehicles`, the tick
(routing, the FSM light controllers, decide + move, post-move: arrivals,
the service FSM, demand, rain, blocks) and the megakernel's segment with
K9's JAX quirks, each kernel replaced by its plain PyTorch version
(`ops/plain.py`).  Later changes to the port do not reach it.  It
imports nothing of the port, of `jax` or of `trafficsimulation_tpu`,
registers no operator, and its relative imports stay inside this copy.
`tsim_bench/tests/test_bench_witness.py` holds it to the JAX package
itself on the CPU, at config #4's city size, so that what it computes is
JAX's semantics and not only the port's.

What the copy left out: the kernels and their wrappers, launch counters
and batching rules (`ops/hopper_engine.py` became `ops/plain.py`); the
world batches (`parallel/`), the RL controllers (`rl/`), hierarchical
routing (`gen/hier.py`, `ops/hier.py`), pedestrians, sub-block road
carving, the split world and the host wrapper `TrafficSim`.  A
configuration that needs one of them raises (`sim._covered`).  Each file
names its source in its first line.
"""
