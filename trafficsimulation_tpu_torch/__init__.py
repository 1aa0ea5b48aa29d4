"""PyTorch + CUDA port of trafficsimulation_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays as the reference.  It
shares `trafficsimulation_tpu.config.Config` and
`trafficsimulation_tpu.codes` (neither imports JAX) and mirrors the JAX
package's module tree.  The tick's four TPU kernels are hand-written
CUDA kernels here (`ops/hopper_engine.py`, sources in `csrc/`), each with
a plain PyTorch version that CPU tensors run.  This package never
imports JAX.
"""
