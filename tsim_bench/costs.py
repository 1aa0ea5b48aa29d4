"""The yardstick's byte counts and peak: frozen copies from
`chip_smoke.py` at commit 20130c3 (`PEAK_BYTES`, `k1_cost`,
`MEGA_STATE` / `MEGA_TABLES` / `MEGA_BLOCK` and `mega_cost`), copied
verbatim so that a later change to the program or to `chip_smoke.py`
does not move them.  Each counts what the data needs: every cell plane
read once and written once, and each vehicle's own reads, whatever
implements the work."""

# H100 SXM device memory bytes/s (NVIDIA's data sheet, at 700 W)
PEAK_BYTES = 3.35e12


def k1_cost(planes, kcfg, shared_geometry=False, stack_words=None):
    """(bytes, ops) of K1 (one world, or B worlds) on these vehicle
    planes, counting what this data needs.  At every cell of every world
    the 5 i32 + 1 f32 planes in and the 6 planes and flags out; at a cell
    where a vehicle stands also what only a vehicle reads: its 4 random
    draws, wnd, the stop, rain and pedestrian masks, and the geometry
    (intersection and dest_id, 5 bytes; once for a cell where any world
    holds a vehicle when the worlds share it); and `stack_words` packed
    stack words (default: one a vehicle).  Operations: at least one
    compare (ALU only) per cell, world and phase (2 K + 2 phases)."""
    H, W = planes[0].shape[-2:]
    present = ((planes[0] & 1) == 1).reshape(-1, H, W)
    cells = present.numel()
    n_veh = int(present.sum())
    geo = int(present.any(0).sum()) if shared_geometry else n_veh
    words = n_veh if stack_words is None else stack_words
    nbytes = cells * (6 * 4 + 7 * 4) + n_veh * (4 * 4 + 4 + 3) + geo * 5 \
        + words * 4
    return nbytes, (cells * (2 * kcfg.VEHICLE_MAX_SPEED + 2),) * 2


# K9's state planes (read at every cell), its tables of the light groups,
# runs and ticks (read whole), and the block planes beside b_mask (read at
# a block's cells)
MEGA_STATE = ("pa", "pb", "pc", "pd", "pe", "pl", "food", "waste", "frem",
              "wrem")
MEGA_TABLES = ("qrun", "srun", "l_group", "l_axis", "gg_valid", "nbr",
               "ticks", "elapsed", "force", "li", "lf", "lstop", "lown")
MEGA_BLOCK = ("b_ok", "b_bid", "b_svcdest", "b_needs", "b_prod", "b_inner",
              "b_fcap", "b_wcap")


def mega_cost(a: dict, got: dict, batched=()) -> int:
    """The bytes a K9 call (one world, or a batch whose inputs `batched`
    names carry a leading world dim) must move on this data, counted as
    k1_cost counts K1's: the state planes in and every output written
    once at every cell of every world; the tables whole, b_mask and the
    scheduled-spawn plane at every cell and tick, and the scheduled
    vehicle where one is due; the block planes at the block cells; and a
    tick's vehicles (the fewer of the segment's first and last tick) each
    reading one packed stack word, wnd, the rain mask and the geometry
    (intersection and dest_id) every tick.  A table the batch shares
    counts once: its block cells once, and at a tick the cells where any
    world holds a vehicle.  The tables only an arriving vehicle reads
    (g_destkind1, g_nexit, g_exitcell) are left out."""
    H, W = a["pa"].shape[-2:]
    R = a["ticks"].shape[-2]

    def nb(n):
        return a[n].numel() * a[n].element_size()
    ends = [((p & 1) == 1).reshape(-1, H, W) for p in (a["pa"], got["pa"])]
    veh = min(int(p.sum()) for p in ends)
    cells = min(int(p.any(0).sum()) for p in ends)

    def per_tick(n):
        return veh if n in batched else cells
    nbytes = sum(nb(n) for n in MEGA_STATE + MEGA_TABLES
                 + ("b_mask", "spawn_pe"))
    nbytes += int((a["spawn_pe"] >= 0).sum()) * 4           # spawn_pa
    nbytes += int((a["b_mask"] != 0).sum()) * 4 * len(MEGA_BLOCK)
    nbytes += R * (veh * 4 + per_tick("wnd") * 4 + per_tick("rain")
                   + per_tick("inter") + per_tick("g_destid") * 4)
    return nbytes + sum(t.numel() * t.element_size() for t in got.values())

