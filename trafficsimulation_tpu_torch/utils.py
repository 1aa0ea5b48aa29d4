"""Host-side helpers (the JAX package's `utils.py`): the bridge's
inspectors `flow_at` and `highway_label`, the flow-mask checks
`assert_flow_mask` and `interactive_check`, and `str_to_unique_int`, on
numpy copies of the world's tensors."""

from __future__ import annotations

import numpy as np
import torch

from . import codes as C


def to_numpy(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flow_at(allowed_dirs, x: int, y: int) -> set:
    """Set of direction names allowed at (x, y)."""
    bits = int(to_numpy(allowed_dirs)[y, x])
    return {C.DIR_NAMES[d] for d in range(4) if bits & (1 << d)}


def assert_flow_mask(allowed_dirs, x: int, y: int, direction: str,
                     expected: bool):
    """Raise AssertionError when the arrow presence at (x, y) does not
    match `expected` (reference `assert_flow_mask`)."""
    got = direction.upper() in flow_at(allowed_dirs, x, y)
    assert got == expected, (
        f"flow mask at ({x},{y}) {direction}: got {got}, "
        f"expected {expected}; mask = {sorted(flow_at(allowed_dirs, x, y))}")


def interactive_check(allowed_dirs):
    """REPL loop for poking at the direction mask (reference
    `interactive_check`): `x y [dir]` per line, an empty line quits."""
    print("enter: x y [dir]   (empty line quits)")
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if not line:
            break
        parts = line.split()
        x, y = int(parts[0]), int(parts[1])
        if len(parts) > 2:
            print(parts[2].upper() in flow_at(allowed_dirs, x, y))
        else:
            print(sorted(flow_at(allowed_dirs, x, y)))


def str_to_unique_int(s: str) -> int:
    """Stable integer id from a string (reference `str_to_unique_int`)."""
    import hashlib
    return int(hashlib.md5(s.encode()).hexdigest()[:12], 16)


def highway_label(grid, flat: int) -> str:
    """Decorative name of a highway entrance or exit cell in the
    reference's format "{Orientation}_{GroupIdx}_{Cardinal}_{Type}_
    {PairIdx}": highways are the contiguous boundary runs of highway
    cells, numbered in reading order (horizontal: south to north, then
    west to east; vertical: west to east, then south to north); the pair
    index counts the cells of the same type along the same edge."""
    cell = to_numpy(grid.cell_type)
    H, W = cell.shape
    y, x = flat // W, flat % W
    t = int(cell[y, x])
    if t not in (C.HIGHWAY_ENTRANCE, C.HIGHWAY_EXIT):
        raise ValueError(f"cell {flat} is not a highway entrance/exit")
    typ = "Entrance" if t == C.HIGHWAY_ENTRANCE else "Exit"

    if y == 0:
        cardinal = "South"
    elif y == H - 1:
        cardinal = "North"
    elif x == 0:
        cardinal = "West"
    elif x == W - 1:
        cardinal = "East"
    else:
        cardinal = "Center"
    horizontal = cardinal in ("South", "North")
    orientation = "Horizontal" if horizontal else "Vertical"

    hw = np.isin(cell, [C.HIGHWAY_ENTRANCE, C.HIGHWAY_EXIT])

    def edge_runs(fixed, along_vertical_edge):
        """Contiguous highway runs along one boundary edge as (start,
        end) index pairs."""
        line = hw[:, fixed] if along_vertical_edge else hw[fixed, :]
        runs, s = [], None
        for i, v in enumerate(line.tolist() + [False]):
            if v and s is None:
                s = i
            elif not v and s is not None:
                runs.append((s, i - 1))
                s = None
        return runs

    groups = []          # (sort_key, edge, lo, hi)
    for e in ((0, H - 1) if horizontal else (0, W - 1)):
        for lo, hi in edge_runs(e, not horizontal):
            groups.append(((e, lo), e, lo, hi))
    groups.sort(key=lambda g: g[0])
    my_pos = x if horizontal else y
    my_edge = y if horizontal else x
    group_idx = next(i + 1 for i, (_, e, lo, hi) in enumerate(groups)
                     if e == my_edge and lo <= my_pos <= hi)

    if horizontal:
        coll = [xx for xx in range(W) if cell[y, xx] == t]
        pair_idx = coll.index(x) + 1
    else:
        coll = [yy for yy in range(H) if cell[yy, x] == t]
        pair_idx = coll.index(y) + 1
    return f"{orientation}_{group_idx}_{cardinal}_{typ}_{pair_idx}"
