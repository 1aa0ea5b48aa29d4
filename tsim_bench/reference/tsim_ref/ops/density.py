# Frozen copy of trafficsimulation_tpu_torch/ops/density.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
"""Local traffic density via separable box filters (the JAX package's
`ops/density.py`).  The f32 sums feed `round(2 * soft)` in the routing
penalties.  The JAX version adds the 2r+1 shifted rows, then the 2r+1
shifted columns, in f32; its inputs are 0/1 planes, so every partial sum
is an integer far below 2^24 and exact in any order.  Here each pass is
one integer prefix sum and one difference: eight launches for a box
instead of ~4r."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sum over a (2r+1)x(2r+1) window with zero padding, separable; `x`
    a 0/1 (or small integer) plane, the sum f32."""
    x = x.to(torch.int32)
    H, W = x.shape
    k = 2 * r + 1
    # row y of the padded prefix minus row y - k is the window's sum
    c = F.pad(x, (0, 0, r + 1, r)).cumsum(0, dtype=torch.int32)
    rows = c[k:] - c[:H]
    c = F.pad(rows, (r + 1, r, 0, 0)).cumsum(1, dtype=torch.int32)
    return (c[:, k:] - c[:, :W]).to(torch.float32)


def density_map(occupancy: torch.Tensor, is_road: torch.Tensor,
                r: int) -> torch.Tensor:
    so = box_sum(occupancy, r)
    sr = box_sum(is_road, r)
    return torch.where(sr > 0, so / torch.clamp(sr, min=1.0), 0.0)
