"""Class and colour constants of the SAMRS labels (the port's copy of
samrs_tpu/data/mapping.py).  They are the output format: colour PNGs are
painted with this palette and the instance records' labels index these
class-name tuples.  PALETTE is a dense (256, 3) uint8 array, index 255 the
white ignore colour.
"""

from typing import Dict, Tuple

import numpy as np

# label index -> RGB color (GD/mapping.py:3-42); 255 is the ignore/background white
MAPPING: Dict[int, Tuple[int, int, int]] = {
    255: (255, 255, 255),
    0: (0, 127, 255),
    1: (0, 63, 0),
    2: (0, 127, 63),
    3: (0, 63, 255),
    4: (0, 0, 127),
    5: (0, 127, 127),
    6: (0, 0, 63),
    7: (0, 63, 127),
    8: (0, 63, 191),
    9: (0, 191, 127),
    10: (0, 127, 191),
    11: (0, 63, 63),
    12: (0, 100, 155),
    13: (0, 0, 255),
    14: (0, 0, 191),
    15: (64, 191, 127),
    16: (64, 0, 191),
    17: (128, 63, 63),
    18: (128, 0, 63),
    19: (191, 63, 0),
    20: (255, 127, 0),
    21: (63, 0, 0),
    22: (127, 63, 0),
    23: (63, 255, 0),
    24: (0, 127, 0),
    25: (127, 127, 0),
    26: (63, 0, 63),
    27: (63, 127, 0),
    28: (63, 191, 0),
    29: (191, 127, 0),
    30: (127, 191, 0),
    31: (63, 63, 0),
    32: (100, 155, 0),
    33: (0, 255, 0),
    34: (0, 191, 0),
    35: (191, 127, 64),
    36: (0, 191, 64),
}

# dense palette for vectorized color painting: PALETTE[label] -> RGB
PALETTE = np.zeros((256, 3), dtype=np.uint8)
for _k, _v in MAPPING.items():
    PALETTE[_k] = _v

# class-name tuples (GD/mapping.py:46-63; order defines the label indices)
DOTA2_0: Tuple[str, ...] = (
    "large-vehicle", "swimming-pool", "helicopter", "bridge",
    "plane", "ship", "soccer-ball-field", "basketball-court",
    "ground-track-field", "small-vehicle", "baseball-diamond",
    "tennis-court", "roundabout", "storage-tank", "harbor",
    "container-crane", "airport", "helipad",
)

DIOR: Tuple[str, ...] = (
    "airplane", "airport", "baseballfield", "basketballcourt", "bridge",
    "chimney", "expressway-service-area", "expressway-toll-station",
    "dam", "golffield", "groundtrackfield", "harbor", "overpass", "ship",
    "stadium", "storagetank", "tenniscourt", "trainstation", "vehicle",
    "windmill",
)

FAIR1M: Tuple[str, ...] = (
    "A220", "A321", "A330", "A350", "ARJ21", "Baseball-Field", "Basketball-Court",
    "Boeing737", "Boeing747", "Boeing777", "Boeing787", "Bridge", "Bus", "C919",
    "Cargo-Truck", "Dry-Cargo-Ship", "Dump-Truck", "Engineering-Ship", "Excavator",
    "Fishing-Boat", "Football-Field", "Intersection", "Liquid-Cargo-Ship", "Motorboat",
    "other-airplane", "other-ship", "other-vehicle", "Passenger-Ship", "Roundabout",
    "Small-Car", "Tennis-Court", "Tractor", "Trailer", "Truck-Tractor", "Tugboat",
    "Van", "Warship",
)

CLASS_SETS: Dict[str, Tuple[str, ...]] = {
    "dota": DOTA2_0,
    "sota": DOTA2_0,
    "dior": DIOR,
    "sior": DIOR,
    "fair1m": FAIR1M,
    "fast": FAIR1M,
}

NAME_TO_INDEX: Dict[str, Dict[str, int]] = {
    ds: {name: i for i, name in enumerate(names)} for ds, names in CLASS_SETS.items()
}
