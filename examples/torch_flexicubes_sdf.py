"""FlexiCubes SDF shape optimization with kaolin_tpu_torch: BASELINE
config 4, "FlexiCubes/marching-tets shape optimization from an SDF
(differentiable mesh extraction inner loop)".

A scalar field on the (R+1)³ grid of ``FlexiCubes.construct_voxel_grid``
starts as the ellipsoid ``‖x·(1.6, 0.7, 1.0)‖ − 0.35`` and is fitted by
``torch.optim.Adam`` at 2e-2 (optax's rules: m̂/(√v̂ + 1e-8)) so that the
extracted mesh lies on the sphere of radius 0.35. Two forms:

- **bench** (``bench.py``'s ``bench_flexicubes``): res 64, 50 steps
  through ``dense_extract(training=True)``; the loss is the mean of
  |‖v‖ − 0.35| over the valid dense dual vertices plus 0.01 × the L_dev sum
  over their count (``bench_loss``, ``bench_step``).
- **topology** (``examples/flexicubes_sdf.py``'s loop): each step refreshes
  the topology (``precompute_topology``) and differentiates
  ``FlexiCubes.__call__(training=True)``; the loss is the mean of
  |‖v‖ − 0.35| over the vertices plus 0.01 × the mean L_dev
  (``topology_loss``, ``topology_step``).

Plain PyTorch, no kernel: the JAX package runs this as XLA and host numpy,
with no Pallas kernel. It runs on the CUDA device unless ``cpu`` is named:

    PYTHONPATH=. python examples/torch_flexicubes_sdf.py [cuda|cpu] \
        [bench|topology|both] [--res R] [--steps N]
"""

import sys

import torch

from kaolin_tpu_torch.ops.conversions import (
    FlexiCubes,
    dense_extract,
    voxelgrids_to_trianglemeshes,
)

RES = 64
STEPS = 50
LR = 2e-2
TARGET_R = 0.35
SCALE = (1.6, 0.7, 1.0)


def start_field(grid_verts):
    """The start field, ``‖x·(1.6, 0.7, 1.0)‖ − 0.35`` on the grid."""
    scale = torch.tensor(SCALE, device=grid_verts.device)
    return torch.linalg.norm(grid_verts * scale, dim=-1) - TARGET_R


def setup(res=RES, device=None, sdf=None):
    """The grid on ``device`` (the CUDA device when None), the field
    (``start_field`` unless ``sdf`` is given) as a leaf to optimize and its
    Adam → dict with ``fc``, ``grid_verts``, ``cube_idx``, ``res``, ``sdf``
    and ``optimizer``."""
    fc = FlexiCubes(device=device)
    grid_verts, cube_idx = fc.construct_voxel_grid(res)
    field = start_field(grid_verts) if sdf is None else \
        torch.as_tensor(sdf, device=fc.device)
    field = field.detach().clone().requires_grad_(True)
    return {"fc": fc, "grid_verts": grid_verts, "cube_idx": cube_idx,
            "res": res, "sdf": field,
            "optimizer": torch.optim.Adam([field], lr=LR, eps=1e-8)}


def bench_loss(sdf, res):
    """The bench form's loss → (loss, aux of ``dense_extract``)."""
    _, _, reg, aux = dense_extract(sdf, res, training=True)
    vd, vm = aux["vd_dense"], aux["vd_valid_dense"]
    d = (torch.sqrt((vd * vd).sum(dim=1)) - TARGET_R).abs() * vm
    nv = vm.sum().clamp(min=1)
    return d.sum() / nv + 0.01 * reg.sum() / nv, aux


def topology_loss(state, topology):
    """The topology form's loss for a fixed topology → (loss, vertices,
    faces)."""
    verts, faces, reg = state["fc"](
        state["grid_verts"], state["sdf"], state["cube_idx"], state["res"],
        topology=topology, training=True)[:3]
    d = (torch.linalg.norm(verts, dim=-1) - TARGET_R).abs()
    return d.mean() + 0.01 * reg.mean(), verts, faces


def _adam(state, loss):
    opt = state["optimizer"]
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()


def bench_step(state):
    """One bench-form step: the loss, its gradient and Adam → (the loss
    before the step, a device scalar, and ``dense_extract``'s counts)."""
    loss, aux = bench_loss(state["sdf"], state["res"])
    _adam(state, loss)
    return loss.detach(), aux["counts"]


def topology_step(state):
    """One topology-form step: the topology of the current field, the loss
    through ``FlexiCubes.__call__``, its gradient and Adam → (the loss
    before the step, the topology)."""
    topology = state["fc"].precompute_topology(
        state["sdf"], state["cube_idx"], state["res"])
    loss, _, _ = topology_loss(state, topology)
    _adam(state, loss)
    return loss.detach(), topology


def run(form, state, steps):
    """``steps`` steps of ``form`` → the losses (a device tensor)."""
    step = bench_step if form == "bench" else topology_step
    return torch.stack([step(state)[0] for _ in range(steps)])


def fitted_mesh(state):
    """The fitted field's mesh (``FlexiCubes.__call__``, not training) →
    (vertices, faces)."""
    with torch.no_grad():
        return state["fc"](state["grid_verts"], state["sdf"],
                           state["cube_idx"], state["res"])[:2]


def marching_cubes(state):
    """Marching cubes of the fitted field on its grid, −sdf at iso 0 (the
    grid is padded with 0, outside) → (vertices, faces) in grid index
    coordinates + 1."""
    r = state["res"] + 1
    field = -state["sdf"].detach().reshape(1, r, r, r)
    vertices, faces = voxelgrids_to_trianglemeshes(field, iso_value=0.0)
    return vertices[0], faces[0]


def main(device=None, form="both", res=RES, steps=STEPS):
    """Run ``form`` (``bench``, ``topology`` or ``both``) from the start
    field for ``steps`` steps on ``device`` (the CUDA device unless
    ``"cpu"`` is named) → {form: (state, losses numpy)}."""
    out = {}
    for f in (("bench", "topology") if form == "both" else (form,)):
        state = setup(res, device)
        losses = run(f, state, steps).cpu().numpy()
        verts, faces = fitted_mesh(state)
        r = torch.linalg.norm(verts, dim=-1)
        print(f"{f} form, res {res}, {steps} steps: loss {losses[0]:.6f} → "
              f"{losses[-1]:.6f}; {verts.shape[0]} vertices, "
              f"{faces.shape[0]} faces, median radius {float(r.median()):.4f}"
              f" (target {TARGET_R})")
        out[f] = (state, losses)
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    kw = {}
    for flag, key in (("--res", "res"), ("--steps", "steps")):
        if flag in args:
            i = args.index(flag)
            kw[key] = int(args[i + 1])
            del args[i:i + 2]
    main(args[0] if args else None, args[1] if len(args) > 1 else "both",
         **kw)
