"""Quaternion math recipe in the port: construction, rotation,
composition, conversions.

Counterpart of ``examples/recipes/quaternions.py``, line for line; on the
card unless ``cpu`` is named.

Run: PYTHONPATH=. python examples/recipes/torch_quaternions.py [cuda|cpu]
"""

import sys

import numpy as np
import torch

from kaolin_tpu_torch.math.quat import (
    quat_from_angle_axis, quat_from_rot33, quat_identity, quat_inverse,
    quat_mul, quat_rotate, quat_unit, rot33_from_quat,
)
from kaolin_tpu_torch.utils.backend import resolve_device


def main(device=None):
    device = resolve_device(device, "the quaternion recipe")

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def show(x):
        return x.cpu().numpy().round(4)

    # axis-angle -> quaternion (xyzw)
    q = quat_from_angle_axis(t([[np.pi / 2]]), t([[0.0, 0.0, 1.0]]))
    print("90deg about z:", show(q))

    # rotate a point
    p = t([[1.0, 0.0, 0.0]])
    print("rotated x-axis:", show(quat_rotate(q, p)))

    # composition and inverse
    q2 = quat_mul(q, q)                       # 180 degrees
    back = quat_rotate(quat_inverse(q2), quat_rotate(q2, p))
    print("rotate+unrotate:", show(back))

    # matrix round trip
    m = rot33_from_quat(quat_unit(q))
    q_back = quat_from_rot33(m)
    print("rot33 round trip:", show(quat_rotate(q_back, p)))

    # identity batch
    print("identity:", quat_identity((2,), device=device).cpu().numpy())
    return {"q": q, "q2": q2, "m": m}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
