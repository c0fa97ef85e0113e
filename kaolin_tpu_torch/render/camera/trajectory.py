"""Camera paths: smoothstep polynomial and Catmull-Rom interpolation
between cameras. Counterpart of ``kaolin_tpu/render/camera/trajectory.py``;
the interpolation runs on the host in float64 numpy, and each camera it
yields lies on the device of the cameras it came from."""

import math

import numpy as np
import torch

from kaolin_tpu_torch.math.quat import quat_from_rot33, rot33_from_quat
from kaolin_tpu_torch.render.camera.camera import Camera

__all__ = ["camera_path_generator", "loop_camera_path_generator"]


def _smoothstep(x, n=3):
    """Generalized smoothstep of order 2n + 1."""
    x = np.clip(x, 0.0, 1.0)
    result = np.zeros_like(x)
    for k in range(n + 1):
        result += (math.comb(n + k, k) * math.comb(2 * n + 1, n - k)
                   * (-x) ** k)
    return result * x ** (n + 1)


def _lerp(a, b, t):
    return a + (b - a) * t


def _slerp_q(a, b, t, eps=1e-7):
    """Quaternion slerp along the shorter arc."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    dot = float(np.dot(a, b))
    if dot < 0:
        b = -b
        dot = -dot
    if dot > 1 - eps:
        out = _lerp(a, b, t)
    else:
        theta = math.acos(min(dot, 1.0))
        out = (math.sin((1 - t) * theta) * a + math.sin(t * theta) * b) \
            / math.sin(theta)
    return out / np.linalg.norm(out)


def _catmull_rom(p0, p1, p2, p3, t, alpha=0.5, eps=1e-6):
    """Centripetal Catmull-Rom interpolation between p1 and p2."""
    p0, p1, p2, p3 = [np.asarray(p, dtype=np.float64)
                      for p in (p0, p1, p2, p3)]

    def tj(ti, pi, pj):
        return ti + max(np.linalg.norm(pj - pi) ** alpha, eps)

    t0 = 0.0
    t1 = tj(t0, p0, p1)
    t2 = tj(t1, p1, p2)
    t3 = tj(t2, p2, p3)
    tt = t1 + t * (t2 - t1)

    def safe_div(n, d):
        return n / (d if abs(d) > eps else eps)

    a1 = safe_div(t1 - tt, t1 - t0) * p0 + safe_div(tt - t0, t1 - t0) * p1
    a2 = safe_div(t2 - tt, t2 - t1) * p1 + safe_div(tt - t1, t2 - t1) * p2
    a3 = safe_div(t3 - tt, t3 - t2) * p2 + safe_div(tt - t2, t3 - t2) * p3
    b1 = safe_div(t2 - tt, t2 - t0) * a1 + safe_div(tt - t0, t2 - t0) * a2
    b2 = safe_div(t3 - tt, t3 - t1) * a2 + safe_div(tt - t1, t3 - t1) * a3
    return safe_div(t2 - tt, t2 - t1) * b1 + safe_div(tt - t1, t2 - t1) * b2


def _host(x):
    return x.detach().cpu().numpy()


def _cam_quat(cam):
    return _host(quat_from_rot33(cam.extrinsics.R)[0])


def _cam_t(cam):
    return _host(cam.extrinsics.t)[0, :, 0]


def _cam_from_rt(q, t, cam1, cam2, x):
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = _host(rot33_from_quat(
        torch.as_tensor(q[None], dtype=torch.float32)))[0]
    view[:3, 3] = t
    intrinsics = {}
    if cam1.lens_type == "pinhole":
        f1 = float(cam1.intrinsics.fov(in_degrees=False)[0])
        f2 = float(cam2.intrinsics.fov(in_degrees=False)[0])
        intrinsics["fov"] = _lerp(f1, f2, x)
    else:
        intrinsics["fov_distance"] = _lerp(float(cam1.fov_distance[0]),
                                           float(cam2.fov_distance[0]), x)
    width = round(_lerp(cam1.width, cam2.width, x))
    height = round(_lerp(cam1.height, cam2.height, x))
    return Camera.from_args(view_matrix=view[None], width=width,
                            height=height, device=cam1.extrinsics.device,
                            **intrinsics)


def _interpolate_polynomial(trajectory, timestep, frames_between, n=3):
    traj_idx = (timestep // frames_between) % len(trajectory)
    cam1 = trajectory[traj_idx]
    cam2 = trajectory[traj_idx + 1]
    xs = _smoothstep(np.linspace(0.0, 1.0, frames_between + 1), n=n)
    x = float(xs[timestep % frames_between])
    q = _slerp_q(_cam_quat(cam1), _cam_quat(cam2), x)
    t = _lerp(_cam_t(cam1), _cam_t(cam2), x)
    return _cam_from_rt(q, t, cam1, cam2, x)


def _interpolate_spline(trajectory, timestep, frames_between):
    """Catmull-Rom through 4 control cameras; the rotation a smoothstep
    slerp between the middle two."""
    traj_idx = (timestep // frames_between) % len(trajectory)
    traj_idx = min(max(traj_idx, 1), len(trajectory) - 3)
    cams = [trajectory[traj_idx + k] for k in (-1, 0, 1, 2)]
    x = (timestep % frames_between) / frames_between
    t = _catmull_rom(*[_cam_t(c) for c in cams], x)
    xq = float(_smoothstep(np.asarray([x]))[0])
    q = _slerp_q(_cam_quat(cams[1]), _cam_quat(cams[2]), xq)
    return _cam_from_rt(q, t, cams[1], cams[2], x)


def _get_interpolator(interpolation, trajectory):
    if interpolation == "polynomial":
        assert len(trajectory) >= 2
        return _interpolate_polynomial
    if interpolation == "catmull_rom":
        assert len(trajectory) >= 4, "catmull_rom needs >= 4 cameras"
        return _interpolate_spline
    raise ValueError(f"unknown interpolation {interpolation!r}")


def camera_path_generator(trajectory, frames_between_cameras=60,
                          interpolation="polynomial"):
    """Yield interpolated cameras along a trajectory, not looped."""
    interpolator = _get_interpolator(interpolation, trajectory)
    _trajectory = [trajectory[0]] + list(trajectory) + [trajectory[-1],
                                                        trajectory[-1]]
    total = (len(trajectory) - 1) * frames_between_cameras + 1
    for step in range(frames_between_cameras,
                      frames_between_cameras + total):
        yield interpolator(_trajectory, step, frames_between_cameras)


def loop_camera_path_generator(trajectory, frames_between_cameras=60,
                               interpolation="polynomial", repeat=None):
    """Yield cameras along a looped trajectory, forever unless ``repeat``
    is given."""
    interpolator = _get_interpolator(interpolation, trajectory)
    _trajectory = [trajectory[-1]] + list(trajectory) + [trajectory[0],
                                                         trajectory[1]]
    frames = frames_between_cameras + 1
    timestep = frames
    it = 0
    iters_per_round = len(trajectory) * frames
    while True:
        yield interpolator(_trajectory, timestep, frames)
        timestep = max((timestep + 1) % ((len(trajectory) + 1) * frames),
                       frames)
        it += 1
        if repeat is not None and it > iters_per_round * repeat:
            break
