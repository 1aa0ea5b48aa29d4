# Frozen copy of trafficsimulation_tpu_torch/agents/__init__.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
