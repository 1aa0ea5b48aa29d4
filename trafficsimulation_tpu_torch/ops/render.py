"""The RGB framebuffer (the JAX package's `ops/render.py` and
`ops/pallas_render.py`).

`render_frame` is the framebuffer every caller uses (`TrafficSim.render`,
the bridge's `/frame.png`): u8 [H, W, 3] from the palette by cell type,
the stop recolors, pending-phase intersections, rain desaturated toward
the luma, the vehicle overlay by the `veh_map` slot and the dummy
overlay.  It is plain PyTorch on the world's device: the JAX package runs
it in XLA, and no TPU kernel backs it.

K8 `render_planes` is the hand-written kernel of the JAX package's
`render_pallas`: the planar [3, H, W] u8 pass with rain mixed toward flat
grey and the vehicle overlay by class, no pending or dummy overlay.  No
caller of the JAX package uses it, and neither does the port's path;
`render_pallas` (the vehicle class plane, then K8) is its entry point.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import codes as C

from .hopper_engine import _check, _check_rc, _entry, _on_cuda, launches

PENDING_COLOR = (189, 183, 107)      # ZONE_COLORS["IntersectionPending"]
DUMMY_COLOR = (255, 0, 255)
# the luma weights as f32, as XLA folds them
_LUMA = tuple(float(np.float32(w)) for w in (0.299, 0.587, 0.114))


def _color(c, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(c, np.uint8), device=device)


def _desaturate(fb: torch.Tensor) -> torch.Tensor:
    """(0.5 * fb + 0.5 * luma) truncated to u8, bit for bit as XLA's CPU
    compile of JAX's `render_frame` gives it: the luma is r * 0.299
    rounded to f32, then fma(g, 0.587, .) and fma(b, 0.114, .), each
    rounded once to f32 (XLA contracts the reduction's multiply-adds in
    channel order).  The fused steps run in f64: a product of a channel
    value 0..255 and an f32 weight is exact there, and so is its sum
    with the f32 partial (under 53 bits), so the one rounding to f32 is
    the FMA's.  The 0.5 products are exact, so the last sum needs no
    care."""
    f = fb.to(torch.float32)
    t = f[..., 0] * _LUMA[0]
    t = (f[..., 1].double() * _LUMA[1] + t.double()).float()
    grey = (f[..., 2].double() * _LUMA[2] + t.double()).float()
    return (0.5 * f + 0.5 * grey[..., None]).to(torch.uint8)


def render_frame(grid, stop_map, rain_map, veh_map, vehicles,
                 pending_mask=None, level: int = 2,
                 dummy_overlay: bool = False) -> torch.Tensor:
    """u8 [H, W, 3] on the world's device.  `level` follows the
    reference's AGENT_PORTRAYAL_LEVEL: 0 the static palette only, >= 1
    the dynamic recolors and vehicle overlays.  `dummy_overlay`
    (cfg.USE_DUMMY_AGENTS) paints magenta every cell whose `veh_map`
    slot is inactive or stands elsewhere (JAX's `render_frame`)."""
    dev = grid.cell_type.device
    H, W = grid.cell_type.shape
    palette = _color(C.PALETTE, dev)
    # a code past the palette takes its last entry, as JAX's gather clamps
    fb = palette[grid.cell_type.long().clamp(max=palette.shape[0] - 1)]
    if level == 0:
        return fb

    def paint(mask, c, fb):
        return torch.where(mask[..., None], _color(c, dev), fb)

    fb = paint((grid.cell_type == C.TRAFFIC_LIGHT) & stop_map,
               C.COLOR_TRAFFIC_LIGHT_STOP, fb)
    fb = paint((grid.cell_type == C.CONTROLLED_ROAD) & stop_map,
               C.COLOR_CONTROLLED_ROAD_STOP, fb)
    if pending_mask is not None:
        fb = paint(grid.intersection & pending_mask, PENDING_COLOR, fb)
    fb = torch.where(rain_map[..., None], _desaturate(fb), fb)

    v = vehicles
    V = v.active.shape[0]
    occupied = veh_map >= 0
    vi = veh_map.clamp(0, V - 1).long()
    color = _color(C.COLOR_VEHICLE, dev).expand(V, 3)
    for mask, c in ((v.kind >= 2, C.COLOR_SERVICE_VEHICLE),
                    (v.parked, C.COLOR_VEHICLE_PARKED),
                    (v.in_malfunction, C.COLOR_VEHICLE_MALFUNCTION),
                    (v.in_collision, C.COLOR_VEHICLE_COLLISION)):
        color = paint(mask, c, color)
    fb = torch.where(occupied[..., None], color[vi], fb)

    if dummy_overlay:
        cellpos = torch.arange(H * W, dtype=torch.int32,
                               device=dev).reshape(H, W)
        mismatch = occupied & (~v.active[vi] | (v.pos[vi] != cellpos))
        fb = paint(mismatch, DUMMY_COLOR, fb)
    return fb


# ---------------------------------------------------------------------------
# K8: the planar framebuffer pass
# ---------------------------------------------------------------------------

def _colour_table() -> np.ndarray:
    """The kernel's colour table, u8 [25, 3]: the 18 palette entries,
    then light stop, controlled-road stop, and the five vehicle classes
    (csrc/render.cu)."""
    return np.ascontiguousarray(np.concatenate([
        np.asarray(C.PALETTE, np.uint8),
        np.stack([C.COLOR_TRAFFIC_LIGHT_STOP, C.COLOR_CONTROLLED_ROAD_STOP,
                  C.COLOR_VEHICLE, C.COLOR_SERVICE_VEHICLE,
                  C.COLOR_VEHICLE_PARKED, C.COLOR_VEHICLE_MALFUNCTION,
                  C.COLOR_VEHICLE_COLLISION]).astype(np.uint8)]))


def _packed_colours():
    """The colour table as the kernel takes it, one r | g << 8 | b << 16
    word a colour (a ctypes array, built once)."""
    t = _colour_table().astype(np.uint32)
    words = t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16)
    return (ctypes.c_uint32 * len(words))(*words.tolist())


_colours = []             # the packed table, built at the first launch


def vehicle_classes(vehicles, H: int, W: int) -> torch.Tensor:
    """u8 [H, W]: 0 where no active vehicle stands, else its class (1
    vehicle, 2 service, 3 parked, 4 malfunction, 5 collision), the
    largest where two share a cell (JAX's scatter-max; the inactive go
    to a sink slot past the grid)."""
    v = vehicles
    HW = H * W
    cls = torch.where(v.in_collision, 5, torch.where(
        v.in_malfunction, 4, torch.where(v.parked, 3, torch.where(
            v.kind >= 2, 2, 1))))
    cls = torch.where(v.active, cls, 0).to(torch.int32)
    vpos = torch.where(v.active, v.pos.clamp(0, HW - 1), HW).long()
    plane = torch.zeros(HW + 1, dtype=torch.int32, device=cls.device)
    plane = plane.scatter_reduce(0, vpos, cls, "amax")
    return plane[:HW].reshape(H, W).to(torch.uint8)


def render_planes_plain(cell, stop, rain, vstate) -> torch.Tensor:
    """Plain version of K8: JAX's where-chain in f32 per channel, u8
    [3, H, W].  cell u8, stop and rain bool, vstate u8 [H, W]."""
    cell = cell.to(torch.int32)
    vstate = vstate.to(torch.int32)
    dev = cell.device
    pal = np.asarray(C.PALETTE, np.float32)
    is_light = cell == C.TRAFFIC_LIGHT
    is_ctrl = cell == C.CONTROLLED_ROAD

    def f(x):
        return torch.tensor(float(x), dtype=torch.float32, device=dev)
    out = []
    for ch in range(3):
        base = torch.zeros(cell.shape, dtype=torch.float32, device=dev)
        for code in range(C.NUM_CELL_TYPES):
            base = torch.where(cell == code, f(pal[code, ch]), base)
        base = torch.where(is_light & stop,
                           f(C.COLOR_TRAFFIC_LIGHT_STOP[ch]), base)
        base = torch.where(is_ctrl & stop,
                           f(C.COLOR_CONTROLLED_ROAD_STOP[ch]), base)
        base = torch.where(rain, 0.5 * base + 0.5 * 128.0, base)
        for k, c in enumerate((C.COLOR_VEHICLE, C.COLOR_SERVICE_VEHICLE,
                               C.COLOR_VEHICLE_PARKED,
                               C.COLOR_VEHICLE_MALFUNCTION,
                               C.COLOR_VEHICLE_COLLISION), start=1):
            base = torch.where(vstate == k, f(c[ch]), base)
        out.append(base.to(torch.int32).to(torch.uint8))
    return torch.stack(out)


def render_path(cell, stop, rain, vstate, out=None) -> str:
    """The path K8's wrapper takes for these planes (and output): "vector"
    (16 pixels a thread, 16-byte loads; a scalar tail for HW % 16) where
    every one starts on a 16-byte boundary, else "scalar" (a pixel a
    thread)."""
    ts = (cell, stop, rain, vstate) + (() if out is None else (out,))
    return "vector" if all(t.data_ptr() % 16 == 0 for t in ts) \
        else "scalar"


def render_planes(cell, stop, rain, vstate) -> torch.Tensor:
    """K8: cell u8, stop and rain bool, vehicle classes u8 (all [H, W])
    -> the planar frame u8 [3, H, W].

    Replaces `pallas_render.render_pallas`'s `pallas_call` (`_kernel`,
    ops/pallas_render.py).  Source: csrc/render.cu.  On the H100 it is
    bound by device-memory bytes: 4 bytes read and 3 written a pixel
    (7.3 MB at 1024^2, about 2.2 us at 3.35 TB/s).  Design: 16 pixels a
    thread, one 16-byte load from each input plane and one 16-byte store
    into each channel plane, the colour table a by-value kernel argument
    staged in shared memory (a packed RGB word a colour, rain mixed on
    the word); the path by alignment (`render_path`).  The wrapper is
    lean: the table is packed once, the entry point resolved once, and
    its checks read no tensor data."""
    if not _on_cuda(cell):
        return render_planes_plain(cell, stop, rain, vstate)
    H, W = cell.shape
    dev = cell.device
    _check("cell", cell, torch.uint8, (H, W), dev)
    _check("stop", stop, torch.bool, (H, W), dev)
    _check("rain", rain, torch.bool, (H, W), dev)
    _check("vstate", vstate, torch.uint8, (H, W), dev)
    out = torch.empty((3, H, W), dtype=torch.uint8, device=dev)
    if not _colours:
        _colours.append(_packed_colours())
    _check_rc("tsim_render_planes", _entry("tsim_render_planes")(
        ctypes.addressof(_colours[0]), cell.data_ptr(), stop.data_ptr(),
        rain.data_ptr(), vstate.data_ptr(), out.data_ptr(), H * W,
        C.TRAFFIC_LIGHT, C.CONTROLLED_ROAD,
        int(render_path(cell, stop, rain, vstate, out) == "vector"),
        torch._C._cuda_getCurrentRawStream(dev.index)))
    launches["render"] += 1
    return out


def render_pallas(cell_type, stop_map, rain_map, veh_map, vehicles):
    """The planar frame u8 [3, H, W] of JAX's `render_pallas` (which, like
    it, takes `veh_map` and reads the vehicle pool instead): the class
    plane, then K8."""
    H, W = cell_type.shape
    return render_planes(cell_type, stop_map, rain_map,
                         vehicle_classes(vehicles, H, W))


def render_pallas_plain(cell_type, stop_map, rain_map, veh_map, vehicles):
    """`render_pallas` with K8's plain version, on any device."""
    H, W = cell_type.shape
    return render_planes_plain(cell_type, stop_map, rain_map,
                               vehicle_classes(vehicles, H, W))
