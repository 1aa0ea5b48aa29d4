"""World state: dataclasses of tensors (the JAX package's flax structs,
`trafficsimulation_tpu/core/state.py`).

Field names, shapes and meanings are those of the JAX package; see its
docstrings for what each table holds.  Types map as follows:

  * u8 / i8 / i32 / f32 / bool -> the torch dtype of the same name;
  * u32 (the PRNG key; the engine's packed planes) -> torch.int32 with
    the same bit pattern: torch has no usable uint32, so every right
    shift of such a value is masked (see `ops/engine.py`).

Every class has `replace(**changes)` like a flax struct.  Tensors are
never mutated in place by the simulation: a tick builds new tensors.
One field is the port's own, derived from the others and carried for
speed: `Grid.n_side` (`PORT_ONLY` in `core/transfer.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .. import codes as C

Tensor = torch.Tensor


class _Struct:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def sidewalk_count(cell_type: Tensor) -> Tensor:
    """The SIDEWALK cells of a [..., H, W] cell plane, i32 [...]
    (`Grid.n_side`)."""
    return (cell_type == C.SIDEWALK).sum((-2, -1), dtype=torch.int32)


@dataclasses.dataclass
class Grid(_Struct):
    cell_type: Tensor      # u8 [H, W]
    orig_type: Tensor      # u8 [H, W]
    allowed_dirs: Tensor   # u8 [H, W] bitmask N=1,E=2,S=4,W=8
    road_class: Tensor     # u8 [H, W]
    is_road: Tensor        # bool [H, W]
    intersection: Tensor   # bool [H, W]
    group_id: Tensor       # i32 [H, W]
    block_id: Tensor       # i32 [H, W]
    light_id: Tensor       # i32 [H, W]
    dest_id: Tensor        # i32 [H, W]
    queue_group: Tensor    # i32 [H, W]
    queue_bucket: Tensor   # i8 [H, W]
    # port-only (no JAX leaf): the sidewalk cells of cell_type, the
    # pedestrian step's spawn divisor, counted once where the statics
    # are built (`sidewalk_count`); i32 []
    n_side: Optional[Tensor] = None


@dataclasses.dataclass
class LightStatic(_Struct):
    valid: Tensor          # bool [L]
    pos: Tensor            # i32 [L]
    group: Tensor          # i32 [L]
    axis: Tensor           # i32 [L]
    assign_road: Tensor    # i32 [A]
    assign_light: Tensor   # i32 [A]
    assign_valid: Tensor   # bool [A]
    srun_lo: Tensor        # i32 [A]
    srun_hi: Tensor        # i32 [A]
    srun_light: Tensor     # i32 [A]
    sextra_cell: Tensor    # i32 [A]
    sextra_light: Tensor   # i32 [A]


@dataclasses.dataclass
class GroupStatic(_Struct):
    valid: Tensor              # bool [G]
    neighbor: Tensor           # i32 [G, 4]
    intermediates: Tensor      # i32 [G, M]
    bbox: Tensor               # i32 [G, 4]
    intersection_size: Tensor  # f32 [G]
    penalty_score: Tensor      # f32 [G]
    queue_cells: Tensor        # i32 [Q]
    queue_qgroup: Tensor       # i32 [Q]
    queue_qbucket: Tensor      # i32 [Q]
    run_lo: Tensor             # i32 [R]
    run_hi: Tensor             # i32 [R]
    run_seg: Tensor            # i32 [R]


@dataclasses.dataclass
class BlockStatic(_Struct):
    valid: Tensor           # bool [B]
    btype: Tensor           # u8 [B]
    inner_count: Tensor     # i32 [B]
    entrance: Tensor        # i32 [B]
    dest: Tensor            # i32 [B]
    service_dest: Tensor    # i32 [B]
    food_cap: Tensor        # f32 [B]
    waste_cap: Tensor       # f32 [B]
    needs_food: Tensor      # bool [B]
    produces_waste: Tensor  # bool [B]


@dataclasses.dataclass
class DestStatic(_Struct):
    valid: Tensor     # bool [D]
    pos: Tensor       # i32 [D]
    kind: Tensor      # u8 [D] 0 block entrance, 1 highway exit
    block: Tensor     # i32 [D]
    hw_pos: Tensor    # i32 [E]
    hw_valid: Tensor  # bool [E]
    rid: Optional[Tensor] = None  # i32 [D]; None = identity (dense)


@dataclasses.dataclass
class LightsState(_Struct):
    current_phase: Tensor     # i32 [G]
    pending_phase: Tensor     # i32 [G]
    transition_timer: Tensor  # i32 [G]
    clearance_timer: Tensor   # i32 [G]
    ft_phase: Tensor          # i32 [G]
    fixed_time_timer: Tensor  # i32 [G]
    queue_timer: Tensor       # i32 [G]
    gap_timer: Tensor         # i32 [G]
    last_arrival: Tensor      # i32 [G]
    ns_pressure: Tensor       # f32 [G]
    ew_pressure: Tensor       # f32 [G]
    rl_timer: Tensor          # i32 [G]
    light_stop: Tensor        # bool [L]


@dataclasses.dataclass
class Vehicles(_Struct):
    active: Tensor            # bool [V]
    pos: Tensor               # i32 [V]
    heading: Tensor           # i32 [V]
    dest: Tensor              # i32 [V]
    base_speed: Tensor        # i32 [V]
    current_speed: Tensor     # i32 [V]
    stuck_ticks: Tensor       # i32 [V]
    is_stuck: Tensor          # bool [V]
    stranded_ticks: Tensor    # i32 [V]
    parked: Tensor            # bool [V]
    in_collision: Tensor      # bool [V]
    in_malfunction: Tensor    # bool [V]
    contraflow_ticks: Tensor  # i32 [V]
    contraflow_key: Tensor    # i32 [V]
    contraflow_steps: Tensor  # i32 [V]
    detour: Tensor            # bool [V]
    kind: Tensor              # u8 [V]
    depart_time: Tensor       # f32 [V]
    steps_traveled: Tensor    # i32 [V]
    service_phase: Tensor     # u8 [V]
    load: Tensor              # f32 [V]
    service_timer: Tensor     # i32 [V]
    service_block: Tensor     # i32 [V]


@dataclasses.dataclass
class BlocksState(_Struct):
    food: Tensor       # f32 [B]
    waste: Tensor      # f32 [B]
    food_rem: Tensor   # f32 [B]
    waste_rem: Tensor  # f32 [B]


@dataclasses.dataclass
class RainState(_Struct):
    active: Tensor    # bool [R]
    cx: Tensor        # f32 [R]
    cy: Tensor        # f32 [R]
    vx: Tensor        # f32 [R]
    vy: Tensor        # f32 [R]
    radius: Tensor    # f32 [R]
    cooldown: Tensor  # i32 []


@dataclasses.dataclass
class Demand(_Struct):
    depart_tick: Tensor  # i32 [T]
    origin: Tensor       # i32 [T]
    dest: Tensor         # i32 [T]
    kind: Tensor         # u8 [T]
    valid: Tensor        # bool [T]
    cursor: Tensor       # i32 []
    day: Tensor          # i32 []


@dataclasses.dataclass
class Metrics(_Struct):
    created_internal: Tensor
    created_through: Tensor
    created_service: Tensor
    completed_internal: Tensor
    completed_through: Tensor
    completed_service: Tensor
    errored_internal: Tensor
    errored_through: Tensor
    sum_duration_internal: Tensor   # f32 sim-seconds
    sum_duration_through: Tensor    # f32
    sum_steps_internal: Tensor
    sum_steps_through: Tensor
    collisions_total: Tensor
    malfunctions_total: Tensor
    daily_created: Tensor
    daily_finished: Tensor
    last_daily_difference: Tensor
    daily_diff_sum: Tensor
    days_completed: Tensor
    day: Tensor


@dataclasses.dataclass
class Overrides(_Struct):
    light_force: Tensor  # i8 [L] -1 none, 0 force go, 1 force stop
    spawn_rain: Tensor   # bool []


@dataclasses.dataclass
class Pedestrians(_Struct):
    """Pedestrian count planes by heading (`agents/pedestrians.py`):
    [4, H, W] while PEDESTRIANS_ENABLED, a [4, 1, 1] stub while they
    are off, as the JAX package carries them."""
    walk: Tensor   # i32 [4, H, W]
    cross: Tensor  # i32 [4, H, W]


@dataclasses.dataclass
class World(_Struct):
    grid: Grid
    lights_static: LightStatic
    groups_static: GroupStatic
    blocks_static: BlockStatic
    dests: DestStatic
    cost_field: Optional[Tensor]  # i32 [D, 4, H, W] pre-encoded keys
    nearest_exit: Tensor          # i32 [D]
    veh_map: Tensor               # i32 [H, W]
    stop_map: Tensor              # bool [H, W]
    rain_map: Tensor              # bool [H, W]
    stuck_map: Tensor             # i32 [H, W]
    density: Tensor               # f32 [H, W]
    vehicles: Vehicles
    lights: LightsState
    blocks: BlocksState
    rain: RainState
    demand: Demand
    metrics: Metrics
    overrides: Overrides
    peds: Pedestrians
    ped_map: Tensor               # i32 [H, W]
    tick: Tensor                  # i32 []
    elapsed: Tensor               # f32 []
    key: Tensor                   # u32 [2] as i32 bits
    rl: Any = None
    local_sdir4: Optional[Tensor] = None


# nested struct fields, for the leaf mapping (core/transfer.py)
NESTED = {
    World: {"grid": Grid, "lights_static": LightStatic,
            "groups_static": GroupStatic, "blocks_static": BlockStatic,
            "dests": DestStatic, "vehicles": Vehicles,
            "lights": LightsState, "blocks": BlocksState,
            "rain": RainState, "demand": Demand, "metrics": Metrics,
            "overrides": Overrides, "peds": Pedestrians},
}
