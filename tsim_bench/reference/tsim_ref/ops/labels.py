# Frozen copy of trafficsimulation_tpu_torch/ops/labels.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
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

Each runs under `torch.func.vmap` (`sim.init_worlds` generates a batch
of cities that way): no output's shape depends on the data, and the two
host tests, a fixpoint's and the dead-end loop's, read the whole batch
(`all_equal`, `any_set`).  A stable loop that runs on until every world
of the batch is stable leaves each world as it would leave it alone.
"""

from __future__ import annotations

import torch

from .routing import _shift_plane

BIG = 2**30
CHECK_EVERY = 4


def _whole(t: torch.Tensor) -> torch.Tensor:
    """`t`, or under torch.func.vmap the tensor of the whole batch that
    `t` is one world of (every vmap level unwrapped, its batch dim
    first)."""
    F = torch._C._functorch
    while F.is_batchedtensor(t):
        t = F.get_unwrapped(t).movedim(F.maybe_get_bdim(t), 0)
    return t


def all_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a equals b in every world of the batch (host sync)."""
    a, b = _whole(a), _whole(b)
    return a.shape == b.shape and torch.equal(a, b)


def any_set(x: torch.Tensor) -> bool:
    """Whether x is set anywhere in the batch (host sync)."""
    return bool(_whole(x).any())


def nonzero_fixed(x: torch.Tensor, size: int, fill: int = -1):
    """`jnp.nonzero(x.reshape(-1), size=size, fill_value=fill)[0]` as
    int64: the first `size` flat indices where x is set, padded with
    `fill`.  Each set index goes to its rank among the set ones, by a
    scatter into a sink slot past the end for the rest."""
    flat = x.reshape(-1).bool()
    pos = torch.cumsum(flat.to(torch.int64), 0) - 1
    slot = torch.where(flat & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=x.device)
    out = out.scatter(0, slot, torch.arange(flat.shape[0], device=x.device))
    return out[:size]


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
    return out.scatter_add(0, seg.reshape(-1).long(), vals.reshape(-1))


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
    # the winners' indices are unique; the rest go to a sink slot
    out = torch.cat([dst, dst.new_zeros(1)])
    return out.scatter(0, torch.where(win, idx, n), vals)[:n]


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
        if all_equal(prev, x):
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
