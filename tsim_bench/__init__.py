"""The benchmark of trafficsimulation_tpu_torch (the PyTorch and CUDA
port): `python3 tsim_bench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>` from the repository's root.  See `harness.py`."""
