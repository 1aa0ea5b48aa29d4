"""PyTorch + CUDA port of trafficsimulation_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays as the reference.  It
keeps its own copies of the JAX package's `Config` (`config.py`) and
cell codes (`codes.py`) and mirrors the JAX package's module tree.  The
TPU kernels on its path are hand-written CUDA kernels here
(`ops/hopper_engine.py`, sources in `csrc/`), each with a plain PyTorch
version that CPU tensors run.  This package imports neither JAX nor any
module of the JAX package.

Entry points: `sim.run_chunk` / `sim.TrafficSim` for one world,
`parallel.mesh.run_batch_shared` for a batch of rollouts of one city.
"""
