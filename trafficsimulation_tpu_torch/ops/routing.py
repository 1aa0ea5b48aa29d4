"""Per-destination cost-to-go fields by value iteration (the JAX
package's `ops/routing.py`; see its module docstring for the cost
model).  Field layout: [D, 4, H, W] f32, INF where unreachable.

The f32 adds keep the JAX order exactly ((F + enter) + contraflow), so
the fields, and the integer keys built from them
(`engine.field_to_keys`), are bit-identical to the JAX package's."""

from __future__ import annotations

import torch

from .. import codes as C
from ..config import Config

INF = 1e9


def _shift_plane(f: torch.Tensor, d: int, fill) -> torch.Tensor:
    """Value at the neighbor in direction d along the last two axes
    (N = +y, E = +x), `fill` outside the grid."""
    out = torch.full_like(f, fill)
    if d == C.N_IDX:
        out[..., :-1, :] = f[..., 1:, :]
    elif d == C.S_IDX:
        out[..., 1:, :] = f[..., :-1, :]
    elif d == C.E_IDX:
        out[..., :, :-1] = f[..., :, 1:]
    else:
        out[..., :, 1:] = f[..., :, :-1]
    return out


def road_type_penalty(cfg: Config, road_class: torch.Tensor) -> torch.Tensor:
    """Penalty for entering a cell, by road_type_map value [H, W]."""
    dev = road_class.device
    if not cfg.VEHICLE_ROAD_TYPES_PENALTIES_ENABLED:
        return torch.zeros(road_class.shape, dtype=torch.float32, device=dev)
    tab = torch.tensor([0.0, cfg.VEHICLE_ROAD_TYPES_PENALTY_R1,
                        cfg.VEHICLE_ROAD_TYPES_PENALTY_R2,
                        cfg.VEHICLE_ROAD_TYPES_PENALTY_R3],
                       dtype=torch.float32, device=dev)
    return tab[road_class.to(torch.int64).clamp(0, 3)]


def compute_cost_fields(cfg: Config, allowed_dirs: torch.Tensor,
                        road_class: torch.Tensor, dest_pos: torch.Tensor,
                        dest_valid: torch.Tensor,
                        max_iters: int | None = None,
                        is_road: torch.Tensor = None) -> torch.Tensor:
    """Value-iterate cost-to-go fields: F[d, h, y, x] = min cost to
    reach destination d from (y, x) with current heading h.  Returns
    [D, 4, H, W] f32.  Sweeps until no entry changes (or `max_iters`,
    3 * (H + W) by default), as the JAX `while_loop` does.

    Leading batch dims are allowed: planes [..., H, W] and destinations
    [..., D] give fields [..., D, 4, H, W], each batch entry its own
    geometry (the windows of `gen/hier.build_local_stack`).  A converged
    entry is a fixpoint that later sweeps leave unchanged, and an entry
    still changing at `max_iters` stops there as it would alone, so the
    batch gives each entry its own result.

    Two field buffers ping-pong (637 MB each at D = 608, 256^2): each
    sweep builds the candidates in the spare buffer in place, so the
    peak stays near three copies of the field."""
    H, W = allowed_dirs.shape[-2:]
    lead = tuple(allowed_dirs.shape[:-2])
    D = dest_pos.shape[-1]
    dev = allowed_dirs.device
    if max_iters is None:
        max_iters = 3 * (H + W)
    tp = float(cfg.VEHICLE_TURN_PENALTY
               if cfg.VEHICLE_TURN_PENALTY_ENABLED else 0.0)
    cp = float(cfg.VEHICLE_CONTRAFLOW_PENALTY)
    use_contra = is_road is not None and (
        cfg.VEHICLE_CONTRAFLOW_OVERTAKE_ACTIVE
        or cfg.VEHICLE_STUCK_CONTRAFLOW_ENABLED)
    enter = 1.0 + road_type_penalty(cfg, road_class)
    bits = allowed_dirs.to(torch.int32)

    dest_oh = torch.zeros(lead + (D, H * W), dtype=torch.bool, device=dev)
    pos = dest_pos.to(torch.int64).clamp(0, H * W - 1)
    dest_oh.scatter_(-1, pos[..., None], dest_valid[..., None])
    F0 = torch.where(dest_oh.reshape(lead + (D, 1, H, W)),
                     torch.tensor(0.0, device=dev),
                     torch.tensor(INF, device=dev))       # [..., D, 1, H, W]

    per_m = []
    for m in range(4):
        en = _shift_plane(enter, m, INF)[..., None, :, :]
        legal = (bits & C.DIR_BITS[m]) != 0
        if use_contra:
            rd = _shift_plane(is_road, m, False)
            extra = torch.where(legal, torch.tensor(0.0, device=dev),
                                torch.tensor(cp, device=dev))
            per_m.append((en, extra[..., None, :, :],
                           (legal | rd)[..., None, :, :]))
        else:
            per_m.append((en, None, legal[..., None, :, :]))

    F = F0.expand(lead + (D, 4, H, W)).contiguous()
    spare = torch.empty_like(F)
    it = 0
    while it < max_iters:
        cand = spare
        for m in range(4):
            en, extra, ok = per_m[m]
            c = cand[..., m, :, :]
            c.copy_(_shift_plane(F[..., m, :, :], m, INF))
            c.add_(en)
            if extra is not None:
                c.add_(extra)
            c.masked_fill_(~ok, INF)
        best = cand.amin(dim=-3, keepdim=True)
        torch.minimum(cand, best + tp, out=cand)
        torch.minimum(cand, F0, out=cand)
        del best
        it += 1
        changed = not torch.equal(cand, F)
        spare, F = F, cand
        if not changed:
            break
    return F
