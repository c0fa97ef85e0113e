"""Mesh → SPC → raytrace with kaolin_tpu_torch: BASELINE config 3 as written,
"SPC pipeline: mesh → Structured Point Cloud octree conversion +
unbatched_raytrace render (nglod-style)".

- **Scene.** The deformed UV sphere of ``torch_dibr_texture_fit.py``
  (``target_shape(uv_sphere(40, 64))``, 4,992 faces) times 0.7, as face
  vertices → ``unbatched_mesh_to_spc`` at level 9 → ``scan_octrees``,
  ``generate_points``, ``unbatched_make_dual`` and
  ``unbatched_make_trinkets`` (``spc_scene``).
- **Views.** Eight cameras: config 3's eye (1.6, 1.1, 1.6) turned about +y
  by k·45°, looking at the origin, up +y, fov 0.8, 512² (``view_rays``:
  the rays the JAX package makes for these cameras, made on the host so
  that every device traces the same ones).
- **Depth render** (``examples/spc_raytrace.py``'s frame,
  ``depth_render``): ``unbatched_raytrace(..., with_exit=True)``,
  ``mark_pack_boundaries``, the first-hit depth map.
- **nglod-style render** (``nglod_render``; NGLOD, Takikawa et al., CVPR
  2021): 32-wide features on the dual corners of all levels, one table;
  each nugget sampled at its midpoint x = o + ½(t_in + t_out)·d, its
  features summed over LODs 9, 8 and 7 (``unbatched_interpolate_trilinear``
  at the leaf and its two ancestors, taken from the trinkets' parent
  pointers); a decoder 32 → 128 → ReLU → 4; σ = softplus(out₀), rgb =
  sigmoid(out₁:₄), τ = σ·(t_out − t_in); ``exponential_integration`` with
  ``exclusive=True``, on a black background.
- **Fit** (``fit_step``): a student field (features from N(0, 0.01²))
  fitted by ``torch.optim.Adam`` at lr 1e-2 to the renders of a teacher
  field (N(0, 0.5²)) of the 8 views; step s renders view s mod 8 and
  raytraces it anew; the loss is mean‖I − I*‖².

Plain PyTorch, no kernel: the JAX package's raytrace and packed ray ops are
XLA with no Pallas kernel. It runs on the CUDA device unless ``cpu`` is
named:

    PYTHONPATH=. python examples/torch_spc_raytrace.py [cuda|cpu] [level] \
        [res] [--fit N]
"""

import importlib.util
import math
import os
import sys

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from kaolin_tpu_torch.ops.conversions import unbatched_mesh_to_spc
from kaolin_tpu_torch.ops.spc import (
    generate_points,
    scan_octrees,
    unbatched_interpolate_trilinear,
    unbatched_make_dual,
    unbatched_make_trinkets,
)
from kaolin_tpu_torch.render.camera import Camera, generate_rays
from kaolin_tpu_torch.render.spc import (
    exponential_integration,
    mark_pack_boundaries,
    unbatched_raytrace,
)
from kaolin_tpu_torch.render.spc.raster import lookat_ray_origin

LEVEL = 9
RES = 512
VIEWS = 8
EYE = (1.6, 1.1, 1.6)
FOV = 0.8
MESH_SCALE = np.float32(0.7)
FEATURE_DIM = 32
HIDDEN = 128
LODS = 3
STUDENT = dict(std=0.01, feature_seed=0, decoder_seed=1)
TEACHER = dict(std=0.5, feature_seed=2, decoder_seed=3)
LR = 1e-2
STEPS = 50


def _sibling(name):
    """``examples/<name>.py`` as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mesh_faces():
    """The scene's mesh as face vertices (4992, 3, 3) float32, within
    |x| <= 0.7438."""
    tex = _sibling("torch_dibr_texture_fit")
    vertices, faces = _sibling("torch_dibr_optimization").uv_sphere(40, 64)
    return (tex.target_shape(vertices) * MESH_SCALE)[faces]


def icosphere():
    """``examples/spc_raytrace.py``'s scene: an icosahedron of radius 0.6
    → (vertices (12, 3) float32, faces (20, 3) int32)."""
    t = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int32)
    return v * 0.6, f


def spc_scene(level=LEVEL, device="cuda", face_vertices=None):
    """The SPC of ``face_vertices`` (``mesh_faces()`` when None) at
    ``level`` on ``device`` → dict with ``level``, ``octree``, ``pyramid``,
    ``exsum``, ``point_hierarchy``, ``dual``, ``pyramid_dual``,
    ``trinkets`` and ``parents``."""
    fv = mesh_faces() if face_vertices is None else face_vertices
    octree, _ = unbatched_mesh_to_spc(torch.as_tensor(fv).to(device), level)
    _, pyramids, exsum = scan_octrees(
        octree, torch.tensor([len(octree)], dtype=torch.int32))
    ph = generate_points(octree, pyramids, exsum)
    dual, pyramid_dual = unbatched_make_dual(ph, pyramids[0])
    trinkets, parents = unbatched_make_trinkets(ph, pyramids[0], dual,
                                                pyramid_dual)
    return {"level": level, "octree": octree, "pyramid": pyramids[0],
            "exsum": exsum, "point_hierarchy": ph, "dual": dual,
            "pyramid_dual": pyramid_dual, "trinkets": trinkets,
            "parents": parents}


def view_eye(k):
    """View k's eye: ``EYE`` turned about +y by k·45°, float32 (3,)."""
    a = 2 * math.pi * k / VIEWS
    x, y, z = EYE
    return np.array([x * math.cos(a) + z * math.sin(a), y,
                     -x * math.sin(a) + z * math.cos(a)], np.float32)


def view_rays(k, res=RES, device="cuda", fov=FOV):
    """The rays of view k at res² → (origins, directions), (res², 3)
    float32 on ``device``: ``generate_rays``' directions and
    ``lookat_ray_origin``, made on the host and moved, so that every device
    traces the rays the JAX package makes for this camera."""
    eye = torch.from_numpy(view_eye(k))
    camera = Camera.from_args(eye=eye, at=torch.zeros(3),
                              up=torch.tensor([0.0, 1.0, 0.0]), fov=fov,
                              width=res, height=res)
    _, dirs = generate_rays(camera)
    origin = lookat_ray_origin(camera.extrinsics.R[0], eye)
    return (origin.expand_as(dirs).contiguous().to(device), dirs.to(device))


def trace(scene, rays):
    """``unbatched_raytrace`` of ``rays`` with exits → (ridx, pidx, depth
    (N, 2))."""
    return unbatched_raytrace(scene["octree"], scene["point_hierarchy"],
                              scene["pyramid"], scene["exsum"], rays[0],
                              rays[1], scene["level"], with_exit=True)


def depth_render(scene, rays):
    """The first-hit depth map (R,) (inf where a ray misses) and the
    nuggets → dict with ``depth``, ``ridx``, ``pidx``, ``t`` (N, 2) and
    ``first`` (the pack boundaries)."""
    ridx, pidx, t = trace(scene, rays)
    first = mark_pack_boundaries(ridx)
    depth = torch.full((rays[0].shape[0],), math.inf, device=t.device)
    depth[ridx[first].long()] = t[first, 0]
    return {"depth": depth, "ridx": ridx, "pidx": pidx, "t": t,
            "first": first}


def make_params(num_corners, std, feature_seed, decoder_seed,
                feature_dim=FEATURE_DIM, hidden=HIDDEN, device="cuda"):
    """A field: features (num_corners, feature_dim) from N(0, std²) and a
    decoder feature_dim → hidden → ReLU → 4 whose weights and biases are
    uniform in ±1/√fan_in (``nn.Linear``'s bounds), each drawn from its own
    seeded CPU ``torch.Generator`` and moved to ``device``, so every device
    holds the same field → {"features", "decoder"}."""
    g = torch.Generator().manual_seed(feature_seed)
    features = torch.randn((num_corners, feature_dim), generator=g) * std
    decoder = nn.Sequential(nn.Linear(feature_dim, hidden), nn.ReLU(),
                            nn.Linear(hidden, 4))
    g = torch.Generator().manual_seed(decoder_seed)
    with torch.no_grad():
        for linear in (decoder[0], decoder[2]):
            bound = 1.0 / math.sqrt(linear.in_features)
            for p in (linear.weight, linear.bias):
                p.copy_(torch.rand(p.shape, generator=g) * (2 * bound)
                        - bound)
    return {"features": features.to(device), "decoder": decoder.to(device)}


def nglod_render(scene, params, rays, nuggets=None):
    """The field's image (R, 3) of ``rays``, raytraced unless ``nuggets``
    (``trace``'s output) are given; differentiable in the features and the
    decoder."""
    ridx, pidx, t = trace(scene, rays) if nuggets is None else nuggets
    r = ridx.long()
    t_in, t_out = t[:, 0], t[:, 1]
    x = rays[0][r] + (0.5 * (t_in + t_out))[:, None] * rays[1][r]
    p = pidx.long()
    f = 0.0
    for lod in range(scene["level"], scene["level"] - LODS, -1):
        f = f + unbatched_interpolate_trilinear(
            x[:, None], p, scene["point_hierarchy"], scene["trinkets"],
            params["features"], lod)[:, 0]
        p = scene["parents"][p].long()
    out = params["decoder"](f)
    tau = F.softplus(out[:, 0]) * (t_out - t_in)
    boundaries = mark_pack_boundaries(ridx)
    color, _ = exponential_integration(torch.sigmoid(out[:, 1:4]),
                                       tau[:, None], boundaries,
                                       exclusive=True)
    image = color.new_zeros((rays[0].shape[0], 3))
    return image.index_put((r[boundaries],), color)


def student_optimizer(student, lr=LR):
    student["features"].requires_grad_(True)
    return torch.optim.Adam([student["features"],
                             *student["decoder"].parameters()], lr=lr)


def fit_step(scene, student, optimizer, rays, target):
    """One Adam step of the student on one view, raytraced anew → the
    loss (a device scalar, before the step)."""
    image = nglod_render(scene, student, rays)
    loss = ((image - target) ** 2).mean()
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def fit_setup(scene, views, feature_dim=FEATURE_DIM, hidden=HIDDEN):
    """Teacher, targets (the teacher's images of every view, without
    gradient), student and optimizer of the fit."""
    device = scene["octree"].device
    n = scene["dual"].shape[0]
    teacher = make_params(n, **TEACHER, feature_dim=feature_dim,
                          hidden=hidden, device=device)
    student = make_params(n, **STUDENT, feature_dim=feature_dim,
                          hidden=hidden, device=device)
    with torch.no_grad():
        targets = [nglod_render(scene, teacher, rays) for rays in views]
    return {"teacher": teacher, "targets": targets, "student": student,
            "optimizer": student_optimizer(student)}


def fit(scene, views, steps, fit_state=None):
    """``steps`` fit steps, step s on view s mod 8 → the losses (numpy)."""
    state = fit_state or fit_setup(scene, views)
    losses = [fit_step(scene, state["student"], state["optimizer"],
                       views[s % len(views)], state["targets"][s % len(views)])
              for s in range(steps)]
    return torch.stack(losses).cpu().numpy()


def main(device="cuda", level=LEVEL, res=RES, steps=STEPS):
    """Build the scene, render view 0's depth, fit ``steps`` steps on
    ``device`` (the CUDA device unless ``"cpu"`` is named) → dict with
    ``scene``, ``depth`` (view 0's render) and ``losses``."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; name 'cpu' to run on the CPU")
    scene = spc_scene(level, device)
    pyr = scene["pyramid"].cpu().numpy()
    print(f"level {level}: octree {len(scene['octree'])} bytes, "
          f"{pyr[0, level]} leaves, {pyr[1, level + 1]} points, "
          f"{scene['dual'].shape[0]} dual corners")
    views = [view_rays(k, res, device) for k in range(VIEWS)]
    frame = depth_render(scene, views[0])
    depth = frame["depth"]
    hit = torch.isfinite(depth)
    print(f"view 0 at {res}x{res}: {frame['ridx'].shape[0]} nuggets, hit "
          f"fraction {float(hit.float().mean()):.4f}, depth range "
          f"[{float(depth[hit].min()):.4f}, {float(depth[hit].max()):.4f}]")
    losses = fit(scene, views, steps) if steps else np.zeros(0)
    if steps:
        print("fit loss: " + " ".join(f"{x:.4e}" for x in losses))
    return {"scene": scene, "depth": frame, "losses": losses}


if __name__ == "__main__":
    args = sys.argv[1:]
    n_fit = STEPS
    if "--fit" in args:
        i = args.index("--fit")
        n_fit = int(args[i + 1])
        del args[i:i + 2]
    main(args[0] if args else "cuda", *(int(a) for a in args[1:3]),
         steps=n_fit)
