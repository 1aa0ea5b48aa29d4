"""Cell-type and direction encodings for the lattice world (the port's own
copy of the JAX package's `codes.py`).

The reference keeps cell types as strings on `CellAgent.cell_type`
(`cell.py:22-48`, zone taxonomy `config.py:74-95`) and packs allowed
directions into a 4-bit mask N=1, E=2, S=4, W=8 only for its array mirror
(`city_model.py:2189-2197`).  Here the u8 code + 4-bit mask ARE the world.

Coordinate convention (same as the reference maps): arrays are indexed
``[y, x]``; North is +y, East is +x (`numba_utilities.py:5-10`).
Flat index = ``y * W + x``.
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# Cell type codes (u8).  One code per reference zone type; the *Stop
# variants in the reference ZONES list are portrayal states, not types.
# --------------------------------------------------------------------------
NOTHING = 0
WALL = 1
SIDEWALK = 2
RESIDENTIAL = 3
OFFICE = 4
MARKET = 5
LEISURE = 6
OTHER = 7
EMPTY = 8
R1 = 9
R2 = 10
R3 = 11
INTERSECTION = 12
HIGHWAY_ENTRANCE = 13
HIGHWAY_EXIT = 14
TRAFFIC_LIGHT = 15
CONTROLLED_ROAD = 16
BLOCK_ENTRANCE = 17

NUM_CELL_TYPES = 18

TYPE_NAMES = {
    NOTHING: "Nothing", WALL: "Wall", SIDEWALK: "Sidewalk",
    RESIDENTIAL: "Residential", OFFICE: "Office", MARKET: "Market",
    LEISURE: "Leisure", OTHER: "Other", EMPTY: "Empty",
    R1: "R1", R2: "R2", R3: "R3", INTERSECTION: "Intersection",
    HIGHWAY_ENTRANCE: "HighwayEntrance", HIGHWAY_EXIT: "HighwayExit",
    TRAFFIC_LIGHT: "TrafficLight", CONTROLLED_ROAD: "ControlledRoad",
    BLOCK_ENTRANCE: "BlockEntrance",
}
NAME_TO_TYPE = {v: k for k, v in TYPE_NAMES.items()}

ZONE_TYPES = (RESIDENTIAL, OFFICE, MARKET, LEISURE, OTHER)

# Reference `ROAD_LIKE_TYPES` (`config.py:68`)
ROAD_LIKE = (R1, R2, R3, INTERSECTION, HIGHWAY_ENTRANCE, HIGHWAY_EXIT,
             BLOCK_ENTRANCE, CONTROLLED_ROAD)
# Reference `ROAD_LIKE_TYPES_WITHOUT_INTERSECTIONS` (`config.py:69`)
ROAD_LIKE_NO_INTERSECTION = (R1, R2, R3, HIGHWAY_ENTRANCE, HIGHWAY_EXIT,
                             BLOCK_ENTRANCE, CONTROLLED_ROAD)
# Reference `REMOVABLE_DEAD_END_TYPES` (`config.py:70`)
REMOVABLE_DEAD_END = (R2, R3, INTERSECTION)

# --------------------------------------------------------------------------
# Directions.  Index order N, E, S, W; bit = 1 << index (N=1,E=2,S=4,W=8
# matching `city_model.py:2189-2197`).
# --------------------------------------------------------------------------
N_IDX, E_IDX, S_IDX, W_IDX = 0, 1, 2, 3
DIR_NAMES = ("N", "E", "S", "W")
DIR_BITS = (1, 2, 4, 8)

# displacement per direction index: (dy, dx)
DIR_DY = np.array([1, 0, -1, 0], dtype=np.int32)
DIR_DX = np.array([0, 1, 0, -1], dtype=np.int32)

def opposite(d: int) -> int:
    return (d + 2) % 4

def right_of(d: int) -> int:
    """Reference `DIRECTION_TO_THE_RIGHT` (`config.py:66`): N→E→S→W→N."""
    return (d + 1) % 4

def left_of(d: int) -> int:
    return (d + 3) % 4

def dir_bit(d: int) -> int:
    return 1 << d

# Road-class codes for the `road_class` plane: 0=none, 1=R1, 2=R2, 3=R3,
# 4=R4 (sub-block / other road-like).  Matches the reference
# `road_type_map` semantics (`city_model.py:2151-2199`).
RC_NONE, RC_R1, RC_R2, RC_R3, RC_R4 = 0, 1, 2, 3, 4

# --------------------------------------------------------------------------
# Palette (RGB u8) for the on-device framebuffer — reference ZONE_COLORS
# (`config.py:98-120`), converted from CSS color names.
# --------------------------------------------------------------------------
_CSS = {
    "cadetblue": (95, 158, 160), "orange": (255, 165, 0),
    "green": (0, 128, 0), "palevioletred": (219, 112, 147),
    "darkkhaki": (189, 183, 107), "papayawhip": (255, 239, 213),
    "white": (255, 255, 255), "grey": (128, 128, 128),
    "black": (0, 0, 0), "dodgerblue": (30, 144, 255),
    "saddlebrown": (139, 69, 19), "darkgreen": (0, 100, 0),
    "yellow": (255, 255, 0), "blue": (0, 0, 255),
    "royalblue": (65, 105, 225), "lime": (0, 255, 0),
    "red": (255, 0, 0), "thistle": (216, 191, 216),
    "salmon": (250, 128, 114), "magenta": (255, 0, 255),
    "aliceblue": (240, 248, 255), "darkolivegreen": (85, 107, 47),
}

PALETTE = np.zeros((NUM_CELL_TYPES, 3), dtype=np.uint8)
for _code, _name, in ((NOTHING, "white"), (WALL, "black"),
                      (SIDEWALK, "grey"), (RESIDENTIAL, "cadetblue"),
                      (OFFICE, "orange"), (MARKET, "green"),
                      (LEISURE, "palevioletred"), (OTHER, "darkkhaki"),
                      (EMPTY, "papayawhip"), (R1, "dodgerblue"),
                      (R2, "saddlebrown"), (R3, "darkgreen"),
                      (INTERSECTION, "yellow"), (HIGHWAY_ENTRANCE, "blue"),
                      (HIGHWAY_EXIT, "royalblue"), (TRAFFIC_LIGHT, "lime"),
                      (CONTROLLED_ROAD, "thistle"),
                      (BLOCK_ENTRANCE, "magenta")):
    PALETTE[_code] = _CSS[_name]

# Stop-state recolors (reference `cell.py:274-299`)
COLOR_TRAFFIC_LIGHT_STOP = np.array(_CSS["red"], dtype=np.uint8)
COLOR_CONTROLLED_ROAD_STOP = np.array(_CSS["salmon"], dtype=np.uint8)
COLOR_VEHICLE = np.array(_CSS["black"], dtype=np.uint8)
COLOR_VEHICLE_PARKED = np.array(_CSS["aliceblue"], dtype=np.uint8)
COLOR_VEHICLE_COLLISION = np.array(_CSS["red"], dtype=np.uint8)
COLOR_VEHICLE_MALFUNCTION = np.array(_CSS["yellow"], dtype=np.uint8)
COLOR_SERVICE_VEHICLE = np.array(_CSS["darkolivegreen"], dtype=np.uint8)
