"""The general generator of a fit's traffic: the cameras that every step
renders, read from a mix's data file (``portbench/traffic/<name>.json``).

A mix's ``cameras`` hold ``distance``, ``elevations_deg`` (a list),
``azimuths`` (the count, evenly spaced from 0), ``fovy_deg``, ``look_at``
and ``up``. The views are every elevation at every azimuth,
elevation-major, and each step renders all of them.
"""

import json
import math
from pathlib import Path

import torch

DIR = Path(__file__).resolve().parent / "traffic"


def load(name):
    with open(DIR / f"{name}.json") as f:
        return json.load(f)


def cameras(mix, device):
    """Camera positions (N, 3), the look-at point and up direction (1, 3)
    and the vertical field of view in radians."""
    cam = mix["cameras"]
    d = cam["distance"]
    rows = []
    for el in map(math.radians, cam["elevations_deg"]):
        for k in range(cam["azimuths"]):
            az = 2 * math.pi * k / cam["azimuths"]
            rows.append([d * math.cos(el) * math.sin(az), d * math.sin(el),
                         d * math.cos(el) * math.cos(az)])
    return {"cam_pos": torch.tensor(rows, device=device),
            "look_at": torch.tensor([cam["look_at"]], device=device),
            "up": torch.tensor([cam["up"]], device=device),
            "fovy": math.radians(cam["fovy_deg"])}
