"""Connected-component labelling by iterated neighbour-min propagation
(the JAX package's `ops/labels.py`): every masked cell starts with its
own flat index and takes the min over its masked 4-neighbours until
nothing changes, so each component ends labelled with the flat index of
its smallest member (its root).

The fixpoint is stable, so the loops below test for it once every few
sweeps (one host sync per test): the extra sweeps change nothing, and the
labels are those of the JAX `while_loop`, which tests after every sweep.

Also here: the fixed-size `nonzero`, segment reductions and the
last-write-wins scatter that the generation modules share.
"""

from __future__ import annotations

import torch

from .routing import _shift_plane

BIG = 2**30
CHECK_EVERY = 4


def nonzero_fixed(x: torch.Tensor, size: int, fill: int = -1):
    """`jnp.nonzero(x.reshape(-1), size=size, fill_value=fill)[0]` as
    int64: the first `size` flat indices where x is set, padded with
    `fill`."""
    idx = torch.nonzero(x.reshape(-1)).reshape(-1)[:size]
    if idx.numel() < size:
        idx = torch.cat([idx, torch.full((size - idx.numel(),), fill,
                                         dtype=idx.dtype, device=x.device)])
    return idx


def seg_min(vals, seg, num: int, init):
    """`jnp.full((num,), init).at[seg].min(vals)` (exact for integers)."""
    out = torch.full((num,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, seg.reshape(-1).long(), vals.reshape(-1),
                              "amin", include_self=True)


def seg_max(vals, seg, num: int, init):
    out = torch.full((num,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, seg.reshape(-1).long(), vals.reshape(-1),
                              "amax", include_self=True)


def seg_sum(vals, seg, num: int):
    """Segment sum; the callers sum integers, or f32 multiples of 0.5
    far below 2^24, which are exact in any order."""
    out = torch.zeros((num,), dtype=vals.dtype, device=vals.device)
    return out.index_add(0, seg.reshape(-1).long(), vals.reshape(-1))


def set_last(dst: torch.Tensor, idx: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """`dst.at[idx].set(vals)` on a 1-D tensor with XLA's CPU order: of
    several updates to one index the last one wins (a plain index_put
    leaves that unspecified, and the card's differs).  Indices outside
    [0, len) are dropped."""
    n = dst.shape[0]
    idx = idx.reshape(-1).long()
    vals = vals.reshape(-1).to(dst.dtype)
    keep = (idx >= 0) & (idx < n)
    order = torch.arange(idx.numel(), device=idx.device)
    slot = torch.where(keep, idx, n)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, slot, order, "amax", include_self=True)
    win = keep & (last[slot] == order)
    out = dst.clone()
    out[idx[win]] = vals[win]
    return out


def _neighbor_min(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    big = torch.where(mask, labels, BIG)
    out = torch.minimum(
        torch.minimum(torch.minimum(_shift_plane(big, 0, BIG),
                                    _shift_plane(big, 2, BIG)),
                      torch.minimum(_shift_plane(big, 1, BIG),
                                    _shift_plane(big, 3, BIG))), big)
    return torch.where(mask, out, BIG)


def _fixpoint(step, x: torch.Tensor) -> torch.Tensor:
    """Iterate `step` until it maps x to itself."""
    while True:
        for _ in range(CHECK_EVERY):
            prev, x = x, step(x)
        if torch.equal(prev, x):
            return x


def connected_components(mask: torch.Tensor) -> torch.Tensor:
    """Label the 4-connected components of `mask` [H, W]: int32, the
    flat index of the component's root on masked cells, -1 elsewhere."""
    H, W = mask.shape
    init = torch.where(mask, torch.arange(H * W, dtype=torch.int32,
                                          device=mask.device).reshape(H, W),
                       BIG)

    def step(labels):
        new = _neighbor_min(labels, mask)
        # pointer jumping: adopt the label of your current root
        root = new.reshape(-1)[new.clamp(0, H * W - 1).reshape(-1).long()]
        return torch.where(mask & (new < BIG),
                           torch.minimum(new, root.reshape(H, W)), new)

    return torch.where(mask, _fixpoint(step, init), -1)


def connected_components_keyed(mask: torch.Tensor,
                               key_map: torch.Tensor) -> torch.Tensor:
    """Like `connected_components`, but neighbours join only where
    `key_map` agrees."""
    H, W = mask.shape
    init = torch.where(mask, torch.arange(H * W, dtype=torch.int32,
                                          device=mask.device).reshape(H, W),
                       BIG)
    nks = [_shift_plane(key_map, d, -1) for d in range(4)]
    oks = [(nk == key_map) & mask for nk in nks]

    def step(labels):
        big = torch.where(mask, labels, BIG)
        out = big
        for d in range(4):
            out = torch.minimum(out, torch.where(
                oks[d], _shift_plane(big, d, BIG), BIG))
        return torch.where(mask, out, BIG)

    return torch.where(mask, _fixpoint(step, init), -1)


def compact_labels(labels: torch.Tensor, max_items: int):
    """Dense ids for component roots in row-major order: (ids [H, W]
    int32 or -1, roots [max_items] int32 flat root index or -1,
    count)."""
    H, W = labels.shape
    HW = H * W
    dev = labels.device
    flat = labels.reshape(-1)
    is_root = flat == torch.arange(HW, dtype=torch.int32, device=dev)
    roots = nonzero_fixed(is_root, max_items).to(torch.int32)
    count = is_root.sum().to(torch.int32)
    slot = torch.arange(max_items, dtype=torch.int32, device=dev)
    dense_of_flat = set_last(
        torch.full((HW + 1,), -1, dtype=torch.int32, device=dev),
        torch.where(roots >= 0, roots, HW), torch.where(roots >= 0, slot, -1))
    ids = torch.where(flat >= 0, dense_of_flat[flat.clamp(0, HW).long()], -1)
    return ids.reshape(H, W), roots, count
