"""Local traffic density via separable box filters (the JAX package's
`ops/density.py`).  The f32 sums feed `round(2 * soft)` in the routing
penalties, so the add order is the JAX one exactly: zero, then the
2r+1 shifted rows in order, then the 2r+1 shifted columns."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sum over a (2r+1)x(2r+1) window with zero padding, separable."""
    x = x.to(torch.float32)
    H, W = x.shape
    pad = F.pad(x, (0, 0, r, r))
    rows = sum(pad[k:k + H, :] for k in range(2 * r + 1))
    pad2 = F.pad(rows, (r, r, 0, 0))
    return sum(pad2[:, k:k + W] for k in range(2 * r + 1))


def density_map(occupancy: torch.Tensor, is_road: torch.Tensor,
                r: int) -> torch.Tensor:
    so = box_sum(occupancy, r)
    sr = box_sum(is_road, r)
    return torch.where(sr > 0, so / torch.clamp(sr, min=1.0),
                       torch.zeros((), dtype=torch.float32,
                                   device=so.device))
