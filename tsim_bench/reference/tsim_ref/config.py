# Frozen copy of trafficsimulation_tpu_torch/config.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
"""Frozen configuration of the simulated city: the port's own copy of
the JAX package's `config.py`, field for field, with the same names,
defaults and `capacities()`.  The port keeps a copy instead of importing
it, so that nothing of the JAX package is loaded with the port
(tests/test_torch_batch.py holds the two copies equal).

Every tunable keeps the name and default value of the reference
simulator's public parameter API, so that a user of the reference can
move their configuration over unchanged.  The containers (road
thickness, zone chances, time zones) are stored as tuples so the whole
config is hashable.

Fixed capacities for the struct-of-arrays pools live at the bottom.
They are *derived* from the reference parameters by
:meth:`Config.capacities` unless overridden explicitly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


# --------------------------------------------------------------------------
# Immutable helper records
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class TimeZone:
    """One 3-hour demand zone (reference `config.py:155-236`)."""
    start_hour: int
    end_hour: int
    through_distribution: float
    # ((origin_abbr, dest_abbr, fraction), ...)
    internal_distribution: Tuple[Tuple[str, str, float], ...]


@dataclass(frozen=True)
class Capacities:
    """Static SoA capacities (TPU-specific; XLA needs fixed shapes)."""
    max_bands: int            # per axis road bands
    max_lights: int           # TrafficLight cells
    max_groups: int           # intersection light groups
    max_blocks: int           # city blocks
    max_vehicles: int         # vehicle pool
    max_trips: int            # pre-generated trips per day
    max_dests: int            # routing destinations (entrances + exits)
    lane_coords_per_group: int  # padded in/out lane coords per group+axis
    stop_cells_per_light: int   # light cell + controlled road cells
    max_exits: int            # highway exits
    max_entrances_hw: int     # highway entrances
    max_spawns_per_tick: int
    max_rain: int             # simultaneous rain clouds
    path_lookahead: int       # cells of route unrolled for obstacle scan
    max_queue_cells: int      # labeled lane + intersection cells (compact
    #                           queue list; see fsm.group_reductions)


DEFAULT_TIME_ZONES: Tuple[TimeZone, ...] = (
    TimeZone(6, 9, 0.15, (("Res", "Off", 0.05), ("Res", "Mar", 0.05),
                          ("Res", "Lei", 0.02), ("Res", "Oth", 0.03))),
    TimeZone(9, 12, 0.20, (("Res", "Mar", 0.10), ("Res", "Oth", 0.04),
                           ("Off", "Oth", 0.06))),
    TimeZone(12, 15, 0.15, (("Res", "Mar", 0.07), ("Res", "Oth", 0.03),
                            ("Off", "Oth", 0.05))),
    TimeZone(15, 18, 0.15, (("Res", "Mar", 0.03), ("Off", "Oth", 0.05),
                            ("Mar", "Oth", 0.05), ("Lei", "Oth", 0.02))),
    TimeZone(18, 21, 0.12, (("Res", "Oth", 0.02), ("Res", "Lei", 0.02),
                            ("Off", "Lei", 0.02), ("Mar", "Lei", 0.02),
                            ("Oth", "Lei", 0.02), ("Mar", "Oth", 0.01),
                            ("Lei", "Oth", 0.01))),
    TimeZone(21, 24, 0.10, (("Off", "Res", 0.03), ("Mar", "Res", 0.03),
                            ("Lei", "Res", 0.02), ("Oth", "Res", 0.02))),
    TimeZone(0, 3, 0.08, (("Off", "Res", 0.02), ("Lei", "Res", 0.04),
                          ("Oth", "Res", 0.01), ("Res", "Lei", 0.01))),
    TimeZone(3, 6, 0.05, (("Res", "Mar", 0.02), ("Res", "Lei", 0.02),
                          ("Res", "Oth", 0.01))),
)

ABBR = {"Res": "Residential", "Off": "Office", "Mar": "Market",
        "Lei": "Leisure", "Oth": "Other"}


@dataclass(frozen=True)
class Config:
    """All simulator tunables.  Reference: `Simulation/config.py:4-449`."""

    # grid -----------------------------------------------------------------
    WIDTH: int = 200
    HEIGHT: int = 200
    # frame
    WALL_THICKNESS: int = 15
    SIDEWALK_RING_WIDTH: int = 2

    # road network -----------------------------------------------------------
    RING_ROAD_TYPE: str = "R2"
    HIGHWAY_OFFSET: int = 7

    R1_CHANCE_MEAN: float = 0.15
    R1_CHANCE_STD: float = 0.03
    R2_CHANCE_MEAN: float = 0.70
    R2_CHANCE_STD: float = 0.05
    MIN_R1_BANDS: int = 2

    # blocks -----------------------------------------------------------------
    BLOCK_ENTRANCE_ROAD_LEVEL: int = 0
    # Compatibility-only: declared in the reference config
    # (`config.py:27`) but read by NO reference code — entrance placement
    # (`city_model.py:884-963`) only honors BLOCK_ENTRANCE_ROAD_LEVEL.
    # Kept for config-API parity; intentionally unread here too.
    BLOCK_ENTRANCE_AVOID_TRAFFIC_LIGHTS: bool = True
    MIN_BLOCK_SPACING: int = 6
    MAX_BLOCK_SPACING: int = 18

    # sub-blocks ---------------------------------------------------------------
    SUBBLOCK_CHANGE: float = 0.3
    CARVE_SUBBLOCK_ROADS: bool = False
    MIN_SUBBLOCK_SPACING: int = 5
    SUBBLOCK_ROADS_HAVE_INTERSECTIONS: bool = True
    SUBBLOCK_ROAD_TYPE: str = "R3"

    # control ------------------------------------------------------------------
    OPTIMISED_INTERSECTIONS: bool = True
    TRAFFIC_LIGHT_RANGE: int = 10
    FORWARD_TRAFFIC_LIGHT_RANGE: bool = False
    FORWARD_TRAFFIC_LIGHT_INTERSECTIONS: str = "Skip"

    # road thickness (R1, R2, R3) — reference `ROAD_THICKNESS` dict
    ROAD_THICKNESS_R1: int = 4
    ROAD_THICKNESS_R2: int = 2
    ROAD_THICKNESS_R3: int = 1

    # zoning chances — reference `CITY_BLOCK_CHANCE`
    CITY_BLOCK_CHANCE: Tuple[Tuple[str, float], ...] = (
        ("Residential", 0.25), ("Office", 0.25), ("Market", 0.2),
        ("Leisure", 0.2), ("Other", 0.1), ("Empty", 0.0))

    # city flow ------------------------------------------------------------
    TIME_ZONES: Tuple[TimeZone, ...] = DEFAULT_TIME_ZONES
    TIME_PER_STEP_IN_SECONDS: int = 6
    SIMULATION_STARTING_TIME_OF_DAY_HOURS: int = 6
    SIMULATION_STARTING_TIME_OF_DAY_MINUTES: int = 0

    INTERNAL_POPULATION_TRAFFIC_PER_DAY: int = 10000
    PASSING_POPULATION_TRAFFIC_PER_DAY: int = 2400
    TOTAL_SERVICE_VEHICLES_FOOD: int = 50
    TOTAL_SERVICE_VEHICLES_WASTE: int = 50
    INDIVIDUAL_SERVICE_VEHICLE_COOLDOWN: int = 3600

    # city resources ---------------------------------------------------------
    FOOD_CAPACITY_PER_CELL: float = 2.0
    FOOD_CONSUMPTION_TICKS: int = 50
    WASTE_CAPACITY_PER_CELL: float = 1.5
    WASTE_PRODUCTION_TICKS: int = 100
    CITY_BLOCK_THAT_NEED_FOOD: Tuple[str, ...] = ("Market", "Leisure")
    CITY_BLOCK_THAT_PRODUCE_WASTE: Tuple[str, ...] = (
        "Residential", "Office", "Market", "Leisure", "Other")
    GRADUAL_CITY_BLOCK_RESOURCES: bool = True

    # weather ----------------------------------------------------------------
    RAIN_ENABLED: bool = True
    RAIN_SPEED_REDUCTION: int = 2
    RAIN_RADIUS_MIN: int = 50
    RAIN_RADIUS_MAX: int = 100
    RAIN_SPEED_MIN: int = 1
    RAIN_SPEED_MAX: int = 10
    RAIN_OCCURRENCES_MAX: int = 3
    RAIN_COOLDOWN: int = 86400
    RAIN_SPAWN_CHANCE: float = 0.1
    RAIN_SPAWN_OFFSET: int = 10

    # vehicles -----------------------------------------------------------------
    VEHICLE_MIN_SPEED: int = 1
    VEHICLE_MAX_SPEED: int = 5

    VEHICLE_RESPECT_AWARENESS: bool = False
    VEHICLE_AWARENESS_RANGE: int = 10
    VEHICLE_AWARENESS_WIDTH: int = 3

    VEHICLE_ROAD_TYPES_PENALTIES_ENABLED: bool = True
    VEHICLE_ROAD_TYPES_PENALTY_R1: float = 0.5
    VEHICLE_ROAD_TYPES_PENALTY_R2: float = 5.0
    VEHICLE_ROAD_TYPES_PENALTY_R3: float = 50.0

    VEHICLE_TURN_PENALTY_ENABLED: bool = True
    VEHICLE_TURN_PENALTY: float = 10.0

    VEHICLE_DYNAMIC_PENALTIES_ENABLED: bool = True
    VEHICLE_DYNAMIC_PENALTY_SCALE: float = 4.0

    VEHICLE_OBSTACLE_PENALTY_VEHICLE: float = 1_000.0
    VEHICLE_OBSTACLE_PENALTY_STOP: float = 500.0

    VEHICLE_CONTRAFLOW_OVERTAKE_ACTIVE: bool = True
    VEHICLE_CONTRAFLOW_PENALTY: float = 5_000.0
    VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS: int = 6
    VEHICLE_CONTRAFLOW_OVERTAKE_DURATION: int = 30

    VEHICLE_STUCK_RECOMPUTE_THRESHOLD: int = 30
    VEHICLE_STUCK_RECOMPUTE_THRESHOLD_INTERSECTION: int = 1

    VEHICLE_STUCK_CONTRAFLOW_ENABLED: bool = True
    VEHICLE_STUCK_CONTRAFLOW_THRESHOLD: int = 60
    VEHICLE_STUCK_CONTRAFLOW_THRESHOLD_INTERSECTION: int = 10
    VEHICLE_MAX_CONTRAFLOW_STUCK_DETOUR_STEPS: int = 20
    VEHICLE_CONTRAFLOW_STUCK_DETOUR_DURATION: int = 10

    VEHICLE_STUCK_DESPAWN_ENABLED: bool = False
    VEHICLE_STUCK_DESPAWN_THRESHOLD: int = 3600
    VEHICLE_STUCK_DESPAWN_THRESHOLD_INTERSECTION: int = 20

    # NOTE: the reference rolls malfunction with an inverted probability
    # check (`vehicle_base.py:609` fires with p≈1-1e-7).  We implement the
    # *intended* semantics: a malfunction occurs with probability
    # VEHICLE_MALFUNCTION_CHANCE per tick.
    VEHICLE_MALFUNCTION_ACTIVE: bool = True
    VEHICLE_MALFUNCTION_CHANCE: float = 1e-7
    VEHICLE_MALFUNCTION_DURATION: int = 400

    VEHICLE_SIDESWIPE_COLLISION_ACTIVE: bool = True
    VEHICLE_SIDESWIPE_COLLISION_CHANCE: float = 1e-9
    VEHICLE_SIDESWIPE_COLLISION_DURATION: int = 600

    # service vehicles ----------------------------------------------------------
    SERVICE_VEHICLE_MAX_LOAD_FOOD: float = 50.0
    SERVICE_VEHICLE_MAX_LOAD_WASTE: float = 250.0
    SERVICE_VEHICLE_LOAD_TIME: int = 20

    # traffic lights ------------------------------------------------------------
    TRAFFIC_LIGHT_TRANSITION_DURATION_ENABLED: bool = False
    TRAFFIC_LIGHT_TRANSITION_CLEARANCE_ENABLED: bool = True

    TRAFFIC_LIGHT_AGENT_ALGORITHM: str = "QUEUE_ACTUATED"
    # "DISABLED", "FIXED_TIME", "QUEUE_ACTUATED",
    # "PRESSURE_CONTROL", "NEIGHBOR_PRESSURE_CONTROL", "NEIGHBOR_GREEN_WAVE",
    # "NEIGHBOR_RL", "NEIGHBOR_RL_BATCHED", "RL_A2C_BATCHED",
    # "GAT_DQN", "GAT_DQN_BATCHED"

    TRAFFIC_LIGHT_ALL_RED_DURATION: int = 2
    TRAFFIC_LIGHT_CLEARANCE_MAX_DURATION: int = 5
    TRAFFIC_LIGHT_GREEN_DURATION: int = 20
    TRAFFIC_LIGHT_QUEUE_ACTUATED_MIN_GREEN: int = 5
    TRAFFIC_LIGHT_QUEUE_ACTUATED_MAX_GREEN: int = 30
    TRAFFIC_LIGHT_QUEUE_ACTUATED_GAP: int = 3
    TRAFFIC_LIGHT_PRESSURE_CONTROL_MIN_GREEN: int = 5

    # simple RL (REINFORCE-style) — reference `rl_simple.py`
    SRL_INPUT_DIMENSIONS: int = 13      # 7, 11, 13, 17, 19
    SRL_PUNISH_STUCK: bool = False
    SRL_PUNISH_STUCK_FACTOR: float = 5.0
    SRL_PUNISH_NEIGHBOR: bool = True
    SRL_PUNISH_NEIGHBOR_FACTOR: float = 0.25
    SRL_HIDDEN_LAYERS: int = 10
    SRL_HIDDEN_LAYER_SIZE: int = 128
    SRL_LEARNING_RATE: float = 0.005
    SRL_UPDATE_EVERY: int = 32
    SRL_BATCH_SIZE: int = 64
    SRL_DROPOUT: float = 0.01
    SRL_MIN_GREEN: int = 5

    # A2C — reference `rl_a2c.py`
    A2C_HIDDEN_LAYERS: int = 10
    A2C_HIDDEN_LAYER_SIZE: int = 256
    A2C_TRAFFIC_RL_MAX_GREEN: int = 30
    A2C_GAMMA: float = 0.80
    A2C_LAMBDA: float = 0.75
    A2C_UPDATE_EVERY: int = 32
    A2C_BATCH_SIZE: int = 256
    # exact-reference GAE trajectory: run the advantage recursion over
    # the FLAT interleaved rollout buffer like `compute_gae`
    # (`rl_a2c.py:183-192` over storage order) instead of per group
    # along time (the declared-deviation default; PARITY.md)
    A2C_INTERLEAVED_GAE: bool = False
    A2C_ENTROPY_MAX: float = 0.01
    A2C_ENTROPY_MIN: float = 0.001
    A2C_ENTROPY_DECAY_STEPS: int = 64

    # GAT-DQN — reference `rl_gatdqn.py`
    GAT_GAMMA: float = 0.99
    GAT_BATCH_SIZE: int = 64
    GAT_MEMORY_CAPACITY: int = 10000
    GAT_TARGET_UPDATE_EVERY: int = 32
    EPS_INITIAL: float = 1.0
    EPS_MIN: float = 0.1
    EPS_DECAY_RATE: float = 1e-5
    GAT_TRAFFIC_RL_MIN_GREEN: int = 5

    # pathfinding ---------------------------------------------------------------
    # PATHFINDING_METHOD selects the routing backend: "FIELD" = on-device
    # cost fields (the TPU-native planner), "CPP" = the native host A*
    # (`native/astar.py`) for CPU-only tooling.  COOLDOWN/CACHE/BATCHING
    # are accepted for API compatibility: the field router effectively
    # replans every tick (no cooldown needed), fields ARE the cache, and
    # decide is always batched.
    PATHFINDING_METHOD: str = "FIELD"
    PATHFINDING_COOLDOWN: int = 5
    PATHFINDING_CACHE: bool = True
    PATHFINDING_BATCHING: bool = True
    # TPU addition (reserved): cadence for refreshing cost fields with
    # dynamic penalties folded in; the current router applies dynamic
    # penalties at step-choice time instead (see ops/routing.py)
    FIELD_REFRESH_INTERVAL: int = 16
    # TPU addition: days of demand pre-generated into the device trip
    # table.  In-step regeneration would execute on every tick under
    # vmapped world batches (lax.cond -> select), so the table is built
    # ahead and extended host-side between scan segments.
    DEMAND_PREGEN_DAYS: int = 2
    # TPU addition: number of destinations with precomputed cost fields.
    # Destinations are compacted valid-first (entrances, exits, then
    # block service cells); only the first MAX_FIELD_DESTS get fields
    # ([D,4,H,W] f32 — the memory knob).
    MAX_FIELD_DESTS: int = 512
    # TPU addition: hierarchical two-level routing (VERDICT r4 next #2).
    # The dense [D,4,H,W] field stack cannot reach D~10k at 1024^2
    # (~87 GB); instead every destination gets an EXACT static cost
    # field over a tile-aligned 3x3 window around its tile (stored as
    # packed next-move bytes in a (9*HIER_LMAX)-plane stack addressed by
    # (dest-tile - cell-tile, local id) arithmetic — no per-vehicle
    # gathers), while long-range guidance comes from a small set of
    # dense DYNAMIC per-region hub fields (one hub destination per 2x2
    # tiles, rebuilt with congestion penalties every routing segment
    # like the dense path).  A vehicle descends its destination's hub
    # row until its cell's tile is within the 3x3 window of the
    # destination's tile, then follows the exact windowed field.
    # Because the hub lives in the destination's region, arrival at the
    # hub implies the window has been entered: every destination is
    # routable.  Reference capability matched: unbounded destination
    # set (`astar_numba.py:243-281`, `vehicle_base.py:143-167`); the
    # declared deviation (PARITY) is that dynamic congestion penalties
    # apply to the long-range stage only — the last <=3-tile approach
    # follows the static-cost optimum.
    ROUTING_HIER: bool = False
    HIER_TILE: int = 64                # tile side (divides HEIGHT/WIDTH)
    HIER_LMAX: int = 48                # local-id slots per tile

    # traffic
    ENABLE_TRAFFIC: bool = True

    # pedestrians (extension: reference lists them as future work,
    # `readme.md:118-124`; BASELINE config #3 requires them)
    PEDESTRIANS_ENABLED: bool = False
    PEDESTRIANS_PER_DAY: int = 20000
    PEDESTRIAN_MAX: int = 0            # 0 → derived in capacities()
    PEDESTRIAN_SPEED: int = 1
    PEDESTRIAN_CROSS_CHANCE: float = 0.02

    # recording -----------------------------------------------------------------
    SAVE_TOTAL_RESULTS: bool = True
    RESULTS_TOTAL_INTERVAL_UNIT: str = "minutes"
    RESULTS_TOTAL_INTERVAL_VALUE: int = 30
    SAVE_INDIVIDUAL_RESULTS: bool = True
    RESULTS_INDIVIDUAL_INTERVAL_UNIT: str = "minutes"
    RESULTS_INDIVIDUAL_INTERVAL_VALUE: int = 60

    # statistics
    SHOW_TIME_STATISTICS: bool = True
    SHOW_TRAFFIC_STATISTICS: bool = True
    SHOW_METRICS_STATISTICS: bool = True
    STATISTICS_UPDATE_INTERVAL: int = 20

    # misc / debug (reference `config.py:430-449`; portrayal caching and
    # dummy agents are CPU-object-graph optimizations with no TPU
    # counterpart — accepted for API compatibility, no behavioral effect)
    ENABLE_AGENT_PORTRAYAL: bool = True
    AGENT_PORTRAYAL_LEVEL: int = 2
    USE_DUMMY_AGENTS: bool = False
    CACHE_CELL_PORTRAYAL: bool = True
    CUDA_GPU_ENABLED: bool = False
    CHANGE_ASSIGNED_CELL_COLOR_ON_STOP: bool = False
    # Fused decide+movement as one VMEM-resident Pallas TPU kernel
    # (ops/pallas_engine.py); automatically falls back to the identical
    # XLA implementation off-TPU or when the grid exceeds VMEM.
    USE_PALLAS_ENGINE: bool = True

    # colors (reference `config.py:297-332`; the renderer palette in
    # `codes.py` is derived from these CSS names)
    VEHICLE_BASE_COLOR: str = "black"
    VEHICLE_PARKED_COLOR: str = "aliceblue"
    VEHICLE_CONTRAFLOW_OVERTAKE_COLOR: str = "orange"
    VEHICLE_MALFUNCTION_COLOR: str = "yellow"
    VEHICLE_COLLISION_COLOR: str = "red"
    SERVICE_VEHICLE_BASE_COLOR: str = "darkolivegreen"

    # TPU capacity overrides (0 → derive from grid size)
    MAX_VEHICLES: int = 0
    MAX_TRIPS: int = 0
    # Measured-capacity overrides: ((capacity_name, value), ...) applied
    # on top of the conservative worst-case bounds in `capacities()`.
    # Scatter/gather cost on TPU is priced by *padded* table size, so
    # `sim.measure_and_shrink` re-derives these from an actually
    # generated world (pow2-rounded) and re-jits the step 3-7x smaller.
    CAP_OVERRIDES: Tuple[Tuple[str, int], ...] = ()

    # ------------------------------------------------------------------
    # Derived helpers (plain python — static under jit)
    # ------------------------------------------------------------------

    def road_thickness(self, rtype: str) -> int:
        return self.ROAD_THICKNESS[rtype]

    # ------------------------------------------------------------------
    # Reference-compatible constant tables (class attributes, not
    # dataclass fields, so hashability for jit static args is preserved).
    # Reference: `config.py:13, 51-95, 62-72, 42, 98-141, 146-152, 439-447`.
    # ------------------------------------------------------------------
    ROADS = ("R1", "R2", "R3")
    AVAILABLE_CITY_BLOCKS = ("Residential", "Office", "Market", "Leisure",
                             "Other")
    AVAILABLE_DIRECTIONS = ("N", "S", "E", "W")
    DIRECTION_VECTORS = {"N": (0, 1), "S": (0, -1), "W": (-1, 0),
                         "E": (1, 0)}
    DIRECTION_OPPOSITES = {"N": "S", "S": "N", "E": "W", "W": "E"}
    DIRECTION_TO_THE_RIGHT = {"N": "E", "E": "S", "S": "W", "W": "N"}
    DIRECTION_ICONS = {"N": "↑", "S": "↓", "E": "→",
                       "W": "←"}
    ROAD_LIKE_TYPES = frozenset({"R1", "R2", "R3", "Intersection",
                                 "HighwayEntrance", "HighwayExit",
                                 "BlockEntrance"})
    ROAD_LIKE_TYPES_WITHOUT_INTERSECTIONS = frozenset(
        {"R1", "R2", "R3", "HighwayEntrance", "HighwayExit",
         "BlockEntrance"})
    REMOVABLE_DEAD_END_TYPES = frozenset({"R2", "R3", "Intersection"})
    FORWARD_TRAFFIC_LIGHT_INTERSECTION_OPTIONS = (
        "Skip", "Include in Range", "Include as Extra")
    ZONES = ("Residential", "Office", "Market", "Leisure", "Other",
             "Empty", "Nothing", "Sidewalk", "Wall", "R1", "R2", "R3",
             "Intersection", "HighwayEntrance", "HighwayExit",
             "TrafficLight", "TrafficLightStop", "ControlledRoad",
             "ControlledRoadStop", "BlockEntrance")
    ZONE_COLORS = {
        "Residential": "cadetblue", "Office": "orange", "Market": "green",
        "Leisure": "palevioletred", "Other": "darkkhaki",
        "Empty": "papayawhip", "Nothing": "white", "Sidewalk": "grey",
        "Wall": "black", "R1": "dodgerblue", "R2": "saddlebrown",
        "R3": "darkgreen", "Intersection": "yellow",
        "IntersectionPending": "darkkhaki", "HighwayEntrance": "blue",
        "HighwayExit": "royalblue", "TrafficLight": "lime",
        "TrafficLightStop": "red", "ControlledRoad": "thistle",
        "ControlledRoadStop": "salmon", "BlockEntrance": "magenta"}
    DESCRIPTION_MAP = {
        "Residential": "Residential City Block",
        "Office": "Office City Block", "Market": "Market City Block",
        "Leisure": "Leisure City Block",
        "Other": "Miscellaneous City Block", "Empty": "Empty City Block",
        "Nothing": "Empty/unused space", "Sidewalk": "Pedestrian Walkway",
        "Wall": "Outer Wall", "R1": "Highway (4 Lanes, 2/Dir)",
        "R2": "Major Road (2 Lanes, 1/Dir)",
        "R3": "Local Road (1 Lane, One Dir)",
        "Intersection": "Road intersection",
        "HighwayEntrance": "Highway Entrance",
        "HighwayExit": "Highway Exit",
        "TrafficLight": "Intersection Traffic Light",
        "ControlledRoad": "Road Controlled by Traffic Light",
        "BlockEntrance": "City Block Entrance & Exit"}
    ABBR = {"Res": "Residential", "Off": "Office", "Mar": "Market",
            "Lei": "Leisure", "Oth": "Other"}
    CACHED_TYPES = tuple(z for z in ZONES if z not in (
        "HighwayEntrance", "HighwayExit", "TrafficLight",
        "TrafficLightStop", "ControlledRoad", "ControlledRoadStop",
        "Intersection", "BlockEntrance"))

    @property
    def ROAD_THICKNESS(self):
        return {"R1": self.ROAD_THICKNESS_R1, "R2": self.ROAD_THICKNESS_R2,
                "R3": self.ROAD_THICKNESS_R3}

    @property
    def interior_x_min(self) -> int:
        return self.WALL_THICKNESS + self.SIDEWALK_RING_WIDTH

    @property
    def interior_x_max(self) -> int:
        return self.WIDTH - self.WALL_THICKNESS - self.SIDEWALK_RING_WIDTH - 1

    @property
    def interior_y_min(self) -> int:
        return self.WALL_THICKNESS + self.SIDEWALK_RING_WIDTH

    @property
    def interior_y_max(self) -> int:
        return self.HEIGHT - self.WALL_THICKNESS - self.SIDEWALK_RING_WIDTH - 1

    def capacities(self) -> Capacities:
        """Static capacities for the SoA pools, derived from the grid size.

        Scatter/gather cost on TPU scales with the *padded* table sizes,
        so these bounds are as tight as the generator's worst case
        allows: bands pack at most every (1 + MIN_BLOCK_SPACING) cells
        (`city_model.py:1124-1127`), the min-R1 quota only inserts while
        count < MIN_R1_BANDS and each insertion removes overlapping
        bands (`city_model.py:1233-1266`)."""
        interior = min(self.interior_x_max - self.interior_x_min + 1,
                       self.interior_y_max - self.interior_y_min + 1)
        max_bands = max(4, interior // (1 + self.MIN_BLOCK_SPACING)
                        + 2 + self.MIN_R1_BANDS)
        # every group needs a distinct (h-band x v-band) crossing
        max_groups = max(16, (max_bands * max_bands) // 2)
        max_lights = 4 * max_groups
        max_blocks = max(16, (max_bands + 2) * (max_bands + 2))
        service = self.TOTAL_SERVICE_VEHICLES_FOOD + self.TOTAL_SERVICE_VEHICLES_WASTE
        max_vehicles = self.MAX_VEHICLES or 4096
        max_trips = self.MAX_TRIPS or (
            self.INTERNAL_POPULATION_TRAFFIC_PER_DAY
            + self.PASSING_POPULATION_TRAFFIC_PER_DAY + service + 64)
        max_exits = 4 * self.MIN_R1_BANDS * self.ROAD_THICKNESS_R1 + 32
        # the packed vehicle planes carry block ids and destination ids
        # in 14 bits each (ops/engine.py bit layout): the PADDED tables
        # clamp to the representable id space.  The worst-case formula
        # overshoots real generation by ~2x (1024x1024 formula 21609 vs
        # ~13k actual blocks), so the clamp only binds headroom; a world
        # that truly saturates a clamped table is caught by
        # sim.assert_world_fits.
        max_blocks = min(max_blocks, 16382)
        caps = self._base_capacities(max_bands, max_groups, max_lights,
                                     max_blocks, max_vehicles, max_trips,
                                     max_exits)
        if caps.max_dests > 16382:
            caps = dataclasses.replace(caps, max_dests=16382)
        if self.CAP_OVERRIDES:
            caps = dataclasses.replace(caps, **dict(self.CAP_OVERRIDES))
        if caps.max_blocks > 16382 or caps.max_dests > 16382:
            raise ValueError(
                f"CAP_OVERRIDES exceed the packed plane id fields "
                f"(max_blocks={caps.max_blocks}, max_dests="
                f"{caps.max_dests}, limit 16382)")
        return caps

    def _base_capacities(self, max_bands, max_groups, max_lights,
                         max_blocks, max_vehicles, max_trips,
                         max_exits) -> Capacities:
        return Capacities(
            max_bands=max_bands,
            max_lights=max_lights,
            max_groups=max_groups,
            max_blocks=max_blocks,
            max_vehicles=max_vehicles,
            max_trips=max_trips,
            max_dests=max_blocks + max_exits,
            lane_coords_per_group=8 * (self.TRAFFIC_LIGHT_RANGE + 1),
            stop_cells_per_light=8,
            max_exits=max_exits,
            max_entrances_hw=max_exits,
            max_spawns_per_tick=64,
            max_rain=self.RAIN_OCCURRENCES_MAX,
            path_lookahead=self.VEHICLE_AWARENESS_RANGE,
            # per group: <= 8 lanes x (range+1) cells of queue labels plus
            # the intersection cells themselves (clearance bucket)
            max_queue_cells=min(
                self.WIDTH * self.HEIGHT,
                max_groups * (8 * (self.TRAFFIC_LIGHT_RANGE + 1) + 64)),
        )

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# Reference-compatible alias: the reference exposes `Defaults` as the class
# of constants; we expose a default instance under the same name.
Defaults = Config()
