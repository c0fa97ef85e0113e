"""The DIB-R fit's inputs, made from a configuration file and the seed.

The mesh is a UV sphere with per-face UVs; the target is the same topology
deformed and scaled, under a two-colour checker texture times a ramp, posed
near BASELINE config 2's target pose. Only the checker's colours and the
target pose come from the seed (one draw of a ``torch.Generator`` on the
device), so every seed has the same sizes and the same work. The same
inputs go to the port and to the reference.
"""

import math

import numpy as np
import torch


def uv_sphere(n_lat, n_lon):
    """Unit UV sphere → (vertices (V, 3) float32, faces (F, 3) int64), in
    the order of the port's examples: for each latitude band and longitude
    step, the faces (a, b, c) and (b, d, c)."""
    lat = np.linspace(0.1, np.pi - 0.1, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    v = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                  np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_lat - 1), np.arange(n_lon), indexing="ij")
    a = i * n_lon + j
    b = i * n_lon + (j + 1) % n_lon
    c = (i + 1) * n_lon + j
    d = (i + 1) * n_lon + (j + 1) % n_lon
    faces = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], 2)
    return v.astype(np.float32), faces.reshape(-1, 3).astype(np.int64)


def sphere_uvs(n_lat, n_lon):
    """Per-face UVs (F, 3, 2) float32 of :func:`uv_sphere`'s faces: u =
    j / n_lon (the seam column's wrapped corners at u = 1), v = i /
    (n_lat - 1)."""
    i, j = np.meshgrid(np.arange(n_lat - 1), np.arange(n_lon), indexing="ij")
    u0, u1 = j / n_lon, (j + 1) / n_lon
    v0, v1 = i / (n_lat - 1), (i + 1) / (n_lat - 1)
    f0 = np.stack([np.stack([u0, v0], -1), np.stack([u1, v0], -1),
                   np.stack([u0, v1], -1)], -2)
    f1 = np.stack([np.stack([u1, v0], -1), np.stack([u1, v1], -1),
                   np.stack([u0, v1], -1)], -2)
    return np.stack([f0, f1], 2).reshape(-1, 3, 2).astype(np.float32)


def target_shape(vertices, wave, scale):
    """The sphere's vertices at radius 1 + wave·sin(2θ)·cos(3φ), scaled by
    ``scale`` → (V, 3) float32."""
    v = vertices.astype(np.float64)
    theta = np.arccos(np.clip(v[:, 1], -1.0, 1.0))
    phi = np.arctan2(v[:, 2], v[:, 0])
    r = 1.0 + wave * np.sin(2 * theta) * np.cos(3 * phi)
    return (v * r[:, None] * np.asarray(scale)).astype(np.float32)


def checker_texture(size, cells, c0, c1):
    """A ``cells`` x ``cells`` checker of the colours ``c0`` and ``c1`` (3,)
    times a ramp from 0.35 to 1 → (3, size, size) on their device."""
    ys, xs = torch.meshgrid(torch.arange(size, device=c0.device),
                            torch.arange(size, device=c0.device),
                            indexing="ij")
    cell = max(size // cells, 1)
    odd = ((xs // cell + ys // cell) % 2).bool()
    ramp = 0.35 + 0.65 * (xs + ys).float() / (2.0 * max(size - 1, 1))
    return torch.where(odd, c1[:, None, None], c0[:, None, None]) * ramp


def make(cfg, cameras, seed, device):
    """The fit's inputs as tensors on ``device``: the template, its faces
    and UVs, the target's shape, texture and pose, and the cameras (the
    traffic's)."""
    mesh, tgt = cfg["mesh"], cfg["target"]
    vertices, faces = uv_sphere(mesh["n_lat"], mesh["n_lon"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    u = torch.rand(13, generator=gen, device=device)
    lo, hi = tgt["colour_range"]
    colours = lo + (hi - lo) * u[:6]
    angle = math.radians(tgt["angle_deg"]) \
        + math.radians(tgt["angle_jitter_deg"]) * (2 * u[6:7] - 1)
    axis = torch.tensor(tgt["axis"], device=device) \
        + tgt["axis_jitter"] * (2 * u[7:10] - 1)
    t = torch.tensor(tgt["t"], device=device) \
        + tgt["t_jitter"] * (2 * u[10:13] - 1)

    def dev(x):
        return torch.as_tensor(x, device=device)

    return {
        "template": dev(vertices),
        "faces": dev(faces),
        "face_uvs": dev(sphere_uvs(mesh["n_lat"], mesh["n_lon"])),
        "target_shape": dev(target_shape(vertices, tgt["wave"],
                                         tgt["scale"])),
        "target_texture": checker_texture(cfg["texture_size"],
                                          tgt["checker_cells"], colours[:3],
                                          colours[3:]),
        "target_angle": angle,
        "target_axis": axis,
        "target_t": t,
        **cameras,
    }
