"""One world split over the ranks of a process group by rows (the JAX
package's `parallel/spatial.py`).

JAX lays every `[..., H, W]` leaf of a `World` along H over a 1-D mesh
axis "y", replicates the other leaves and jits `run_chunk` over the
sharded pytree; XLA's SPMD partitioner inserts the halo exchanges of the
neighbour shifts and the all-reduces of the reductions.  torch has no
partitioner, so this module and the `slab` argument of the engine's
functions write those collectives out.  Use it for one world too large
or too hot for one device: at config #5's 1024^2 the i32 key stack
`cost_field` [D, 4, H, W] is 2.42 GB, and each rank holds its rows of it
only.

Layout.  Rank r of n owns rows [r H / n, (r + 1) H / n).  Inside a chunk
the vehicles are six [H, W] planes (`sim._enter_engine`), so a vehicle
that crosses a row boundary needs no hand-off: the halo carries it and
the rank that owns its new row computes the move.  Two halo widths,
computed from the Config (`halo_widths`):

  * P = 1 + 3 x VEHICLE_MAX_SPEED, the reach of one tick of decide +
    move (the decide reads neighbours 1 away; a movement sub-round 3: a
    mover's key depends on its target's occupancy, a cell's commit on
    keys 2 away);
  * Q, the routing build's reach beyond P: the larger of the density box
    sum's radius VEHICLE_AWARENESS_RANGE plus 1 (the neighbour shift of
    `engine.entry_costs`) and K3's relax steps
    VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS plus 2 (its sources and its
    final argmin each read a neighbour).

A rank's "decide window" is its rows widened by P on each side, its
"route window" by P + Q, both cut at the world's edges (an edge rank
has no halo there).  `SpatialWorld.world` holds, on each rank, the grid's
planes over the route window, the key stack over the decide window (its
only copy: `field_to_keys` applied the shift already), under
hierarchical routing the windowed static stack `local_sdir4` over the
decide window too, the rank's own rows of every other plane (the
pedestrians' count planes among them), and every other leaf whole
(replicated: the routing-id tables `dests.rid` and `nearest_exit`, the
sidewalk count `grid.n_side`, the pedestrians' [4, 1, 1] stub while they
are off).

A tick (`engine.step_engine` with a `Slab`): the light reductions are
partial sums over the own rows plus one all-reduce (K4 on the own
occupancy); the controllers and the phase commit run replicated; the
stop map is built over the route window from the replicated light flags;
P halo rows of the six planes are exchanged and K1 runs on the decide
window as if it were a world (its edges act as world edges and the
damage stays within P rows of them), and the own rows are kept; the
post-move's per-cell work runs on the own rows, its reductions and its
gathers at destination cells and spawn origins (owner-masked: zero on
every rank but the cell's owner) go in one all-reduce, and its writes at
cells are made by the owning rank only.  Under hierarchical routing the
planes' dest field carries routing ids, which the post-move reads
through the replicated `dests.rid` and `nearest_exit`; K1-hier takes the
decide window's first world row, from which its cells' tile rows
follow.  With pedestrians, their 8 count planes join the decide halo
exchange at P + PED_REACH rows (`engine.PED_REACH`: the step's reach,
2), the step runs on that window with the cell types and stop map cut
from the route window, its blocked cells feed K1 over the decide window
and its counts are kept on the own rows.  A segment (`engine.
routing_planes`): P + Q rows of `pa` (and of the pedestrian count map)
are exchanged, density, penalties, entry costs and K3 run over the
route window, and K2 over the decide window.  Chunk entry packs the
vehicles whose cell is the rank's; chunk exit writes the [V] table
through one owner-masked all-reduce.

Collectives (`Slab.stats` counts them): `all_reduce` (SUM) only, as gloo
takes CUDA tensors for `all_reduce` and `broadcast` alone.  Halo bands
and owner-masked values travel as int32 bit patterns (f32 planes viewed
as int32), summed with zeros everywhere but the owner, which is exact;
f32 sums of integer values (counts, durations in whole tick lengths)
travel as int32 integers.  Each band exchange is one buffer holding the
rows every rank needs.

A leaf with a row dimension that the split does not know raises
ValueError (`ROW_LEAVES`).  The megakernel branch (K9 advances a whole
world's segment in one launch) is never taken on this path, as JAX's
spatial path closes it through `USE_PALLAS_ENGINE=False`; the port's own
kernels K1 (or K1-hier), K2-K4 and the pedestrian step run on the
slabs.  JAX's `spatial_chunk_fn` is a jit cache and has no counterpart:
`run_chunk_spatial` runs eagerly.

    from trafficsimulation_tpu_torch.parallel import launch, spatial

    def body(mesh, cfg, n):          # a function of an importable module
        smesh = spatial.spatial_mesh(device=mesh.device)
        world = make_world() if smesh.rank == 0 else None
        sw = spatial.shard_world(world, smesh, cfg)
        sw = spatial.run_chunk_spatial(cfg, sw, n, smesh)
        return spatial.gather_world(sw, smesh)    # rank 0: the world

    launch.spawn(body, 4, "gloo", args=(cfg, 100))
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..core.state import Grid, World
from ..core.transfer import world_from_leaves, world_leaves
from .mesh import Mesh, make_mesh

# the row leaves a split world knows how to carry (every grid plane too)
ROW_LEAVES = frozenset({"cost_field", "local_sdir4", "veh_map", "stop_map",
                        "rain_map", "stuck_map", "density", "ped_map",
                        "peds.walk", "peds.cross"})


def spatial_mesh(n_devices: int | None = None, device=None) -> Mesh | None:
    """The `Mesh` of this rank along axis "y" (JAX's `spatial_mesh`),
    called in every rank after `init_process_group`, as `make_mesh`."""
    return make_mesh(n_devices, "y", device)


def halo_widths(cfg: Config) -> tuple:
    """(P, Q): the rows decide + move reads beyond a cell in one tick,
    and the routing build's reach beyond P (see the module docstring)."""
    P = 1 + 3 * cfg.VEHICLE_MAX_SPEED
    Q = max(cfg.VEHICLE_AWARENESS_RANGE + 1,
            cfg.VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS + 2)
    return P, Q


def rows_of(H: int, n: int, r: int) -> tuple:
    """Rank r's own rows [lo, hi) of H split over n ranks."""
    return r * H // n, (r + 1) * H // n


def window_of(H: int, n: int, r: int, width: int) -> tuple:
    """Rank r's rows widened by `width` on each side, cut at the
    world's edges."""
    lo, hi = rows_of(H, n, r)
    return max(0, lo - width), min(H, hi + width)


def band_rows(H: int, n: int, width: int) -> list:
    """Per rank, the global rows of its halo of `width` (above its own
    rows, then below), in rank order: the slots of one band buffer."""
    out = []
    for r in range(n):
        lo, hi = rows_of(H, n, r)
        wlo, whi = window_of(H, n, r, width)
        out.append(list(range(wlo, lo)) + list(range(hi, whi)))
    return out


def local_cells(cells: torch.Tensor, W: int, lo: int, hi: int):
    """Global flat cells -> their index in the flat plane of rows
    [lo, hi), or that plane's size (a sink) where the cell lies outside;
    int64."""
    cells = cells.long()
    inside = (cells >= lo * W) & (cells < hi * W)
    return torch.where(inside, cells - lo * W, (hi - lo) * W)


def local_runs(idx: torch.Tensor, H: int, W: int, lo: int, hi: int,
               outside: int | None = None):
    """Indices into the flat buffer of a row part [H (W + 1)] then a
    column part [(H + 1) W] (`fsm._prefix_planes`' prefixes, and
    `fsm.build_stop_map`'s run diffs) -> the same buffer of rows
    [lo, hi): an entry of the row part in rows [lo, hi) moves with its
    row, else goes to `outside` (None: index 0); an entry of the column
    part has its row boundary k clipped to [lo, hi], so that the
    difference of a run's two entries counts its rows inside [lo, hi)
    alone.  int64."""
    idx = idx.long()
    NH = H * (W + 1)
    h = hi - lo
    y = torch.div(idx, W + 1, rounding_mode="floor")
    row = torch.where((y >= lo) & (y < hi), idx - lo * (W + 1),
                      0 if outside is None else outside)
    k = torch.div(idx - NH, W, rounding_mode="floor")
    x = idx - NH - k * W
    col = h * (W + 1) + (torch.clamp(k, lo, hi) - lo) * W + x
    return torch.where(idx < NH, row, col)


@dataclasses.dataclass(eq=False)
class Slab:
    """One rank's part of a world split by rows (see the module
    docstring): the world's size, the rank and group, the halo widths,
    the paths of the leaves it holds by rows (`row_leaves`), the
    replicated tables' maps onto the rank's windows (`prepare`), and the
    counts of its collectives (`stats`).  `slab=None` in the engine's
    functions is the unsharded world."""
    H: int
    W: int
    rank: int
    size: int
    P: int
    Q: int
    group: Any = None
    row_leaves: frozenset = frozenset()
    maps: dict = dataclasses.field(default_factory=dict)
    stats: dict = dataclasses.field(default_factory=lambda: {
        "all_reduce": 0, "bytes": 0, "host_s": 0.0, "largest": 0})
    _bands: dict = dataclasses.field(default_factory=dict)

    # ---- rows ------------------------------------------------------------
    @property
    def own(self) -> tuple:
        return rows_of(self.H, self.size, self.rank)

    @property
    def dec(self) -> tuple:
        """The decide window (K1's, and K2's output rows)."""
        return self.window(self.P)

    @property
    def route(self) -> tuple:
        """The route window (density, penalties, entry costs, K3)."""
        return self.window(self.P + self.Q)

    def window(self, width: int) -> tuple:
        """The own rows widened by `width`, cut at the world's edges."""
        return window_of(self.H, self.size, self.rank, width)

    @staticmethod
    def crop(x: torch.Tensor, frm: tuple, to: tuple) -> torch.Tensor:
        """Rows `to` (global [lo, hi)) of x, whose rows are `frm`: a
        view along dim -2."""
        return x[..., to[0] - frm[0]:to[1] - frm[0], :]

    def grid_rows(self, grid: Grid, to: tuple) -> Grid:
        """The route-window grid's planes cut to rows `to` (views)."""
        return grid.replace(**{
            f.name: self.crop(getattr(grid, f.name), self.route, to)
            for f in dataclasses.fields(grid) if f.name != "n_side"})

    # ---- the replicated tables on this rank's rows --------------------
    def prepare(self, world: World) -> None:
        """The maps of the replicated tables onto this rank's rows, once
        per chunk: destination cells onto the own rows (`dpos`), the
        queue runs onto the own rows' prefix buffer (`run_lo`,
        `run_hi`), the stop runs and extra stop cells onto the route
        window (`srun_lo`, `srun_hi`, `sextra`)."""
        H, W = self.H, self.W
        (o0, o1), (r0, r1) = self.own, self.route
        gs, ls = world.groups_static, world.lights_static
        sink = (r1 - r0) * (W + 1) + (r1 - r0 + 1) * W
        self.maps = {
            "dpos": local_cells(torch.clamp(world.dests.pos, 0, H * W - 1),
                                W, o0, o1),
            "run_lo": local_runs(gs.run_lo, H, W, o0, o1),
            "run_hi": local_runs(gs.run_hi, H, W, o0, o1),
            "srun_lo": local_runs(ls.srun_lo, H, W, r0, r1, sink),
            "srun_hi": local_runs(ls.srun_hi, H, W, r0, r1, sink),
            "sextra": torch.where(ls.sextra_cell >= 0, local_cells(
                ls.sextra_cell, W, r0, r1), -1)}

    def cells(self, cells: torch.Tensor) -> torch.Tensor:
        """Global flat cells (in range) -> the own rows' flat index, or
        the sink (the own cell count)."""
        return local_cells(cells, self.W, *self.own)

    # ---- collectives -----------------------------------------------------
    def _all_reduce(self, buf: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=self.group)
        st = self.stats
        st["all_reduce"] += 1
        st["bytes"] += buf.numel() * buf.element_size()
        st["host_s"] += time.perf_counter() - t0
        st["largest"] = max(st["largest"], buf.numel() * buf.element_size())
        return buf

    def all_sum(self, parts: list) -> list:
        """The sums over the group of `parts` in one all-reduce: integer
        and bool tensors as int32 (returned in their dtype; a bool is
        whether the sum is positive), f32 tensors as their bit patterns
        (owner-masked values: zero on every rank but one)."""
        if self.size == 1:
            return list(parts)
        flat = []
        for p in parts:
            q = p.reshape(-1)
            flat.append(q.view(torch.int32) if q.dtype == torch.float32
                        else q.to(torch.int32))
        buf = self._all_reduce(torch.cat(flat))
        out, o = [], 0
        for p in parts:
            n = p.numel()
            s = buf[o:o + n].reshape(p.shape)
            o += n
            if p.dtype == torch.float32:
                s = s.view(torch.float32)
            elif p.dtype == torch.bool:
                s = s > 0
            else:
                s = s.to(p.dtype)
            out.append(s)
        return out

    def sum_counts(self, x: torch.Tensor) -> torch.Tensor:
        """An f32 tensor of integer-valued partial sums (below 2^24)
        summed over the group as int32: exact, as the unsharded sum."""
        return self.all_sum([x.to(torch.int32)])[0].to(x.dtype)

    def _band(self, width: int) -> dict:
        """The band buffer's plan for halos of `width`: the rows this
        rank fills (slots, own row index), and its own slots."""
        plan = self._bands.get(width)
        if plan is None:
            per = band_rows(self.H, self.size, width)
            o0, o1 = self.own
            slots = [g for rows in per for g in rows]
            fill = [(s, g - o0) for s, g in enumerate(slots) if o0 <= g < o1]
            start = sum(len(r) for r in per[:self.rank])
            lo, _ = window_of(self.H, self.size, self.rank, width)
            plan = self._bands[width] = {
                "n": len(slots),
                "dst": torch.tensor([s for s, _ in fill], dtype=torch.long),
                "src": torch.tensor([g for _, g in fill], dtype=torch.long),
                "mine": (start, start + len(per[self.rank])),
                "above": o0 - lo}
        return plan

    def exchange(self, planes: torch.Tensor, width: int) -> torch.Tensor:
        """planes [k, h, W] over the own rows (int32 bits) -> [k, rows of
        the window of `width`, W]: one all-reduce of the band buffer
        that holds every rank's halo rows, each filled by its owner."""
        if self.size == 1:
            return planes
        plan = self._band(width)
        k, _, W = planes.shape
        dev = planes.device
        if plan["dst"].device != dev:
            plan["dst"], plan["src"] = (plan[x].to(dev) for x in ("dst",
                                                                  "src"))
        buf = torch.zeros((k, plan["n"], W), dtype=torch.int32, device=dev)
        if plan["dst"].numel():
            buf[:, plan["dst"]] = planes[:, plan["src"]]
        self._all_reduce(buf.reshape(-1))
        s0, s1 = plan["mine"]
        mine = buf[:, s0:s1]
        a = plan["above"]
        return torch.cat([mine[:, :a], planes, mine[:, a:]], dim=1)

    def halo(self, planes: list, width: int) -> list:
        """The own rows of each plane of `planes` (int32, f32 or bool
        [h, W]) widened to the window of `width`, in one exchange."""
        dts = [p.dtype for p in planes]
        st = torch.stack([p.view(torch.int32) if p.dtype == torch.float32
                          else p.to(torch.int32) for p in planes])
        out = self.exchange(st, width)
        return [o.contiguous().view(torch.float32) if dt == torch.float32
                else (o != 0 if dt == torch.bool else o.contiguous())
                for o, dt in zip(out.unbind(0), dts)]


@dataclasses.dataclass(eq=False)
class SpatialWorld:
    """A rank's part of a world split by rows: `world` (the grid's planes
    over the route window, the key stack over the decide window, the own
    rows of every other row leaf, the rest whole) and its `slab`."""
    world: World
    slab: Slab


def _is_grid_plane(path: str) -> bool:
    return path.startswith("grid.") and path != "grid.n_side"


def world_shardings(world: World, mesh: Mesh) -> dict:
    """Per leaf path (`core.transfer.world_leaves`): "rows" where the
    leaf's trailing dims are the grid's (H, W), else "replicated" (JAX's
    rule).  One exception: an RL controller's train state replicates
    whatever its shapes (a [32, 32] kernel of the 32 x 32 crossroad is
    no grid plane, and every rank runs the update).  Raises ValueError
    where H is not a multiple of the mesh's size, as JAX's does."""
    H, W = world.grid.cell_type.shape
    ny = mesh.size
    if H % ny:
        raise ValueError(f"grid height {H} not divisible by the mesh's "
                         f"{ny} devices")
    out = {}
    for k, t in world_leaves(world).items():
        rows = (t.dim() >= 2 and tuple(t.shape[-2:]) == (H, W)
                and not k.startswith("rl."))
        out[k] = "rows" if rows else "replicated"
    return out


def _check_rows(kinds: dict) -> None:
    extra = sorted(k for k, v in kinds.items() if v == "rows"
                   and not _is_grid_plane(k) and k not in ROW_LEAVES)
    if extra:
        raise ValueError(f"leaves {extra} carry the grid's rows, and the "
                         "split knows no window for them (ROW_LEAVES)")


def _rows_for(path: str, H: int, n: int, r: int, P: int, Q: int) -> tuple:
    """The global rows of a row leaf that rank r holds."""
    if _is_grid_plane(path):
        return window_of(H, n, r, P + Q)
    if path in ("cost_field", "local_sdir4"):
        return window_of(H, n, r, P)
    return rows_of(H, n, r)


def _pack(tensors: list, device) -> torch.Tensor:
    """Tensors' bytes in one uint8 buffer, each 16-byte aligned."""
    n = sum(-(-t.numel() * t.element_size() // 16) * 16 for t in tensors)
    buf = torch.zeros(n, dtype=torch.uint8, device=device)
    o = 0
    for t in tensors:
        b = t.numel() * t.element_size()
        buf[o:o + b] = t.contiguous().reshape(-1).view(torch.uint8).to(device)
        o += -(-b // 16) * 16
    return buf


def _unpack(buf: torch.Tensor, specs: list) -> list:
    out, o = [], 0
    for shape, dtype in specs:
        b = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out.append(buf[o:o + b].view(dtype).reshape(shape).clone())
        o += -(-b // 16) * 16
    return out


def shard_world(world: World | None, mesh: Mesh, cfg: Config,
                src: int = 0) -> SpatialWorld:
    """Lay rank `src`'s whole world out over the mesh by rows (JAX's
    `shard_world`; the port also takes the Config, whose speeds set the
    halo widths): every rank gets its `SpatialWorld`; the other ranks
    pass None.  The replicated leaves go in one broadcast; each rank's
    row windows in one point-to-point message from `src` (through the
    CPU under gloo), so that no rank but `src` ever holds the whole
    world.  Raises ValueError (every rank) for a row leaf the split does
    not know and where H is not a multiple of the mesh's size."""
    P, Q = halo_widths(cfg)
    n, r, dev = mesh.size, mesh.rank, mesh.device
    meta = [None]
    if r == src:
        if world.cost_field is None:
            raise ValueError("world.cost_field is not built "
                             "(snapshot.build_field)")
        try:
            kinds = world_shardings(world, mesh)
            _check_rows(kinds)
            leaves = world_leaves(world)
            meta = [[(k, tuple(t.shape), str(t.dtype).split(".")[1],
                      kinds[k]) for k, t in leaves.items()]]
        except ValueError as e:
            meta = [str(e)]
    dist.broadcast_object_list(meta, src=src, group=mesh.group)
    if isinstance(meta[0], str):
        raise ValueError(meta[0])
    spec = [(k, shape, getattr(torch, dt), kind)
            for k, shape, dt, kind in meta[0]]
    H, W = next(shape[-2:] for k, shape, _, kind in spec
                if k == "grid.cell_type")
    rep = [(k, shape, dt) for k, shape, dt, kind in spec
           if kind == "replicated"]
    rows = [(k, shape, dt) for k, shape, dt, kind in spec if kind == "rows"]

    # the replicated leaves: one broadcast
    if r == src:
        buf = _pack([leaves[k] for k, _, _ in rep], dev)
    else:
        size = sum(-(-int(np.prod(s, dtype=np.int64)) * dt.itemsize // 16)
                   * 16 for _, s, dt in rep)
        buf = torch.empty(size, dtype=torch.uint8, device=dev)
    dist.broadcast(buf, src=src, group=mesh.group)
    out = dict(zip([k for k, _, _ in rep],
                   _unpack(buf, [(s, dt) for _, s, dt in rep])))
    del buf

    # the row windows: one message a rank
    def window_specs(q):
        specs = []
        for k, s, dt in rows:
            lo, hi = _rows_for(k, H, n, q, P, Q)
            specs.append((tuple(s[:-2]) + (hi - lo, W), dt))
        return specs

    p2p_dev = dev if dist.get_backend(mesh.group) == "nccl" else "cpu"
    if r == src:
        for q in range(n):
            parts = []
            for k, _, _ in rows:
                lo, hi = _rows_for(k, H, n, q, P, Q)
                parts.append(leaves[k][..., lo:hi, :])
            if q == r:
                out.update({k: t.to(dev, copy=True).contiguous()
                            for (k, _, _), t in zip(rows, parts)})
                continue
            msg = _pack(parts, p2p_dev)
            # a mesh holds the group's first ranks: its rank q is global q
            dist.send(msg, dst=q, group=mesh.group)
            del msg
    else:
        specs = window_specs(r)
        size = sum(-(-int(np.prod(s, dtype=np.int64)) * dt.itemsize // 16)
                   * 16 for s, dt in specs)
        msg = torch.empty(size, dtype=torch.uint8, device=p2p_dev)
        dist.recv(msg, src=src, group=mesh.group)
        out.update({k: t.to(dev) for (k, _, _), t in
                    zip(rows, _unpack(msg, specs))})
        del msg
    slab = Slab(H=H, W=W, rank=r, size=n, P=P, Q=Q, group=mesh.group,
                row_leaves=frozenset(k for k, _, _ in rows))
    return SpatialWorld(world=world_from_leaves(out), slab=slab)


def run_chunk_spatial(cfg: Config, sworld: SpatialWorld, n_ticks: int,
                      mesh: Mesh) -> SpatialWorld:
    """Advance a split world n_ticks (JAX's `run_chunk_spatial`): the key
    chain and the RL plan walked on every rank alike (`sim._chain`), then
    `sim.advance` with the rank's `Slab` on the per-tick path (the
    megakernel branch is never taken; the light reductions are the
    sparse forms that the unsharded `sim.run_chunk` takes by default)."""
    from .. import sim
    slab = sworld.slab
    if (mesh.size, mesh.rank) != (slab.size, slab.rank):
        raise ValueError(f"the world is split over {slab.size} ranks "
                         f"(this is rank {slab.rank}), the mesh has "
                         f"{mesh.size} (rank {mesh.rank})")
    if (cfg.HEIGHT, cfg.WIDTH) != (slab.H, slab.W) or \
            halo_widths(cfg) != (slab.P, slab.Q):
        raise ValueError("the Config's grid or speeds differ from the ones "
                         "the world was split with")
    world = sworld.world
    dev = world.grid.is_road.device
    slab.prepare(world)
    draws, plan, key = sim._chain(cfg, world, n_ticks)
    end = sim.advance(cfg, world, n_ticks, torch.from_numpy(draws).to(dev),
                      None, plan, slab=slab)
    return SpatialWorld(world=end.replace(key=sim._key_tensor(key, dev)),
                        slab=slab)


def gather_world(sworld: SpatialWorld, mesh: Mesh, dst: int = 0):
    """The whole `World` on rank `dst` (on the CPU), None on the others:
    every rank's own rows of each row leaf, through the CPU, for checks
    only (JAX's `jax.device_get` of a sharded world)."""
    slab = sworld.slab
    H, n = slab.H, slab.size
    mine = {}
    for k, t in world_leaves(sworld.world).items():
        if k in slab.row_leaves:
            t = slab.crop(t, _rows_for(k, H, n, slab.rank, slab.P, slab.Q),
                          slab.own)
        mine[k] = t.detach().cpu().contiguous()
    parts = [None] * n if mesh.rank == dst else None
    dist.gather_object({k: v for k, v in mine.items()
                        if k in slab.row_leaves},
                       parts, dst=dst, group=mesh.group)
    if parts is None:
        return None
    whole = dict(mine)
    for k in parts[0]:
        whole[k] = torch.cat([p[k] for p in parts], dim=-2)
    return world_from_leaves(whole)
