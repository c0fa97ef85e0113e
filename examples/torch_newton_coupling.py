"""The Newton bridge in the port: a soft Simplicits cube coupled to rigid
shapes.

Counterpart of ``examples/newton_coupling.py``, as written: a 125-point
soft cube with 8 handles (builder → finalize → state → solver.step), a
ground plane and a sphere with soft contact and lagged IPC friction, 120
implicit steps at dt 0.01, a ``visualize.Timelapse`` checkpoint of the
particles every 10 steps. Plain PyTorch, no kernel. On the card unless
``cpu`` is named; ``smoke`` takes 20 steps.

Run: PYTHONPATH=. python examples/torch_newton_coupling.py [cuda|cpu]
     [smoke] [--steps N] [--dt DT] [--out DIR]
(``--out`` defaults to ``build/newton_usd`` in the checkout.)
"""

import argparse
import os
import sys

import numpy as np
import torch

from kaolin_tpu_torch.experimental.newton import (
    SimplicitsModelBuilder,
    SimplicitsSolver,
)
from kaolin_tpu_torch.physics.simplicits import SkinnedPhysicsPoints
from kaolin_tpu_torch.visualize import Timelapse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_soft_cube(num_handles=8, n=5, half=0.25, center=(0.0, 0.6, 0.0)):
    """A baked Simplicits object: grid points and a smooth skinning field
    (in place of a trained MLP, with its shapes), from the JAX example's
    numpy draws."""
    rng = np.random.RandomState(0)
    g = np.linspace(-half, half, n)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = (pts + np.asarray(center)).astype(np.float32)
    freqs = rng.randn(3, num_handles - 1).astype(np.float32)
    w = np.concatenate([np.sin(pts @ freqs), np.ones((len(pts), 1))],
                       axis=1).astype(np.float32)
    dwdx = np.zeros((len(pts), num_handles, 3), np.float32)
    dwdx[:, :-1, :] = np.cos(pts @ freqs)[:, :, None] * freqs.T[None]
    return SkinnedPhysicsPoints(pts=pts, yms=5e4, prs=0.45, rhos=500.0,
                                appx_vol=(2 * half) ** 3,
                                skinning_weights=w, dwdx=dwdx)


def build(device, dt=0.01):
    """The coupled model on ``device`` and its solver."""
    builder = SimplicitsModelBuilder(up_axis="y", gravity=-9.8)
    builder.add_simplicits_object(make_soft_cube())
    builder.add_ground_plane(height=-0.5, mu=0.4)
    builder.add_shape_sphere(pos=(0.05, -0.1, 0.0), radius=0.2, mu=0.2)
    builder.configure_soft_contact(
        particle_ke=5e4, particle_mu=0.4,
        friction_use_lagged_body_contact_force_norm=True)
    # a conv_tol below the default: Newton's convergence check runs before
    # the first increment, and this light cube's first |dx·g| can lie
    # under 1e-4
    model = builder.finalize(device=device, timestep=dt, max_newton_steps=5,
                             max_ls_steps=10, conv_tol=1e-9)
    model.simplicits_scene.force_dict["pt_wise"][
        "newton_soft_collisions"]["coeff"] = 1.0
    return model, SimplicitsSolver(model)


def run(device=None, steps=120, dt=0.01, out=None, every=10, quiet=False):
    """``steps`` coupled steps → (model, the states after each step, the
    logged iterations). A Timelapse goes to ``out`` every ``every`` steps
    when ``out`` is given."""
    model, solver = build(device, dt)
    state = model.state()
    timelapse = None if out is None else Timelapse(out)
    states, logged = [], []
    for i in range(steps):
        state = solver.step(state)
        states.append(state)
        if i % every == 0:
            lo = float(torch.min(state.particle_q[:, 1]))
            vmax = float(torch.max(torch.linalg.vector_norm(
                state.particle_qd, dim=-1)))
            if not quiet:
                print(f"step {i:4d}  min_y={lo:+.3f}  max|v|={vmax:.3f}")
            if timelapse is not None:
                timelapse.add_pointcloud_batch(
                    iteration=i, pointcloud_list=[state.particle_q],
                    category="soft_cube")
            logged.append(i)
    return model, states, logged


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser()
    ap.add_argument("words", nargs="*", choices=("cuda", "cpu", "smoke"))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "newton_usd"))
    args = ap.parse_args(argv)
    device = "cpu" if "cpu" in args.words else None
    steps = args.steps or (20 if "smoke" in args.words else 120)
    run(device, steps, args.dt, args.out)
    print(f"wrote Timelapse USD to {args.out}")


if __name__ == "__main__":
    main()
