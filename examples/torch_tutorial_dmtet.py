"""Tutorial: DMTet, an SDF optimized on a tetrahedral grid, with
kaolin_tpu_torch.

The port of ``examples/tutorial_dmtet.py`` (the reference notebook
``examples/tutorial/dmtet_tutorial.ipynb``): an MLP 3 → 64 → 64 → 4 predicts
an SDF and per-vertex offsets on a Kuhn tet grid of [-1, 1]³ at res 24
(82,944 tets); ``marching_tetrahedra_fixed`` extracts the surface with
fixed shapes (a vertex slot for every unique grid edge, with masks), and a
masked chamfer to 2,048 target points on a squashed torus is the loss,
with Adam at 3e-3 for 120 steps; the chamfer must halve. ``smoke=True``
runs res 8, 8 steps and 256 targets.

The MLP's weights are drawn from a seeded ``torch.Generator`` (N(0, 2/fan_in),
zero biases), or carried from the JAX tutorial by
``kaolin_tpu_torch.utils.interop.dmtet_mlp_from_jax``. Plain PyTorch, no
kernel. It runs on the CUDA device unless ``cpu`` is named:

    PYTHONPATH=. python examples/torch_tutorial_dmtet.py [cuda|cpu] [smoke]
"""

import math
import sys

import numpy as np
import torch
from torch import nn

from kaolin_tpu_torch.ops.conversions.tetmesh import marching_tetrahedra_fixed
from kaolin_tpu_torch.utils.backend import resolve_device

RES, STEPS, TARGETS = 24, 120, 2048
SMOKE = dict(res=8, steps=8, targets=256)
WIDTHS = (3, 64, 64, 4)
LR = 3e-3


def make_tet_grid(res):
    """Axis-aligned tet grid on [-1, 1]³, each cube split into 6 tets (the
    Kuhn split) → (vertices (V, 3) float32, tets (T, 4) int64), numpy."""
    xs = np.linspace(-1, 1, res + 1, dtype=np.float32)
    verts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"),
                     axis=-1).reshape(-1, 3)
    vid = np.arange((res + 1) ** 3).reshape(res + 1, res + 1, res + 1)
    c = [vid[:-1, :-1, :-1], vid[1:, :-1, :-1], vid[:-1, 1:, :-1],
         vid[1:, 1:, :-1], vid[:-1, :-1, 1:], vid[1:, :-1, 1:],
         vid[:-1, 1:, 1:], vid[1:, 1:, 1:]]
    c = [x.reshape(-1) for x in c]
    kuhn = [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
            (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)]
    tets = np.stack([np.stack([c[a], c[b], c[d], c[e]], 1)
                     for a, b, d, e in kuhn]).reshape(-1, 4)
    return verts, tets.astype(np.int64)


def target_points(n, rng):
    """The target surface, a squashed torus, as n points (numpy float32)."""
    u = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    v = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    r, rr = 0.55, 0.22
    x = (r + rr * np.cos(v)) * np.cos(u)
    y = rr * np.sin(v) * 0.9
    z = (r + rr * np.cos(v)) * np.sin(u)
    return np.stack([x, y, z], 1)


def masked_chamfer(verts, mask, target):
    """The chamfer both ways between the valid vertex slots and the target
    (the invalid slots left out)."""
    d2 = ((verts[:, None] - target[None]) ** 2).sum(-1)       # (E, P)
    d2_masked = torch.where(mask[:, None], d2, 1e9)
    to_target = torch.where(mask, d2.amin(dim=1), 0.0)
    loss_a = to_target.sum() / mask.sum().clamp(min=1)
    loss_b = d2_masked.amin(dim=0).mean()
    return loss_a + loss_b


def make_mlp(generator, widths=WIDTHS, device="cpu"):
    """The SDF MLP (Linear and ReLU layers), weights from N(0, 2/fan_in)
    drawn from ``generator`` (a CPU generator: every device holds the same
    weights), zero biases."""
    layers = []
    for i in range(len(widths) - 1):
        linear = nn.Linear(widths[i], widths[i + 1])
        with torch.no_grad():
            w = torch.randn((widths[i], widths[i + 1]), generator=generator)
            linear.weight.copy_((w * math.sqrt(2.0 / widths[i])).T)
            linear.bias.zero_()
        layers += [linear, nn.ReLU()]
    return nn.Sequential(*layers[:-1]).to(device)


def sdf_and_offset(mlp, x, res):
    """The MLP at the grid vertices → (sdf (V,), offsets (V, 3)): the sdf
    starts near a sphere of radius 0.7, the offsets stay within a cell."""
    out = mlp(x)
    sdf = out[:, 0] + (torch.linalg.norm(x, dim=-1) - 0.7)
    offset = torch.tanh(out[:, 1:]) * (1.0 / res)
    return sdf, offset


def setup(device=None, smoke=False, mlp=None, seed=0):
    """The grid, the target, the MLP (``make_mlp`` from ``seed`` unless
    given) and its Adam on ``device`` (the CUDA device when None) →
    dict."""
    device = resolve_device(device, "the DMTet tutorial")
    size = SMOKE if smoke else dict(res=RES, steps=STEPS, targets=TARGETS)
    grid_v, tets = make_tet_grid(size["res"])
    rng = np.random.RandomState(0)
    target = torch.from_numpy(target_points(size["targets"], rng)).to(device)
    if mlp is None:
        mlp = make_mlp(torch.Generator().manual_seed(seed), device=device)
    mlp = mlp.to(device)
    return {"res": size["res"], "steps": size["steps"],
            "grid": torch.from_numpy(grid_v).to(device),
            "tets": torch.from_numpy(tets).to(device), "target": target,
            "mlp": mlp, "optimizer": torch.optim.Adam(mlp.parameters(),
                                                      lr=LR, eps=1e-8)}


def extract(state):
    """The MLP's surface → ``marching_tetrahedra_fixed``'s dict."""
    sdf, offset = sdf_and_offset(state["mlp"], state["grid"], state["res"])
    return marching_tetrahedra_fixed(state["grid"] + offset, state["tets"],
                                     sdf)


def step(state):
    """One Adam step → the chamfer before it (a device scalar)."""
    out = extract(state)
    loss = masked_chamfer(out["verts"], out["vert_mask"], state["target"])
    opt = state["optimizer"]
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def main(device=None, smoke=False, mlp=None):
    """Fit on ``device`` (the CUDA device unless ``"cpu"`` is named) →
    dict with ``losses`` (numpy), ``first``, ``last``, ``verts`` and
    ``faces`` (the extracted mesh's counts). Raises where the chamfer is
    not finite, where it did not halve (full size) or where the mesh is
    empty, as the JAX tutorial asserts."""
    state = setup(device, smoke, mlp)
    losses = torch.stack([step(state) for _ in range(state["steps"])])
    losses = losses.cpu().numpy()
    for it in range(0, len(losses), 20):
        print(f"iter {it:4d}  chamfer {losses[it]:.5f}")
    first, last = float(losses[0]), float(losses[-1])
    print(f"iter {len(losses) - 1:4d}  chamfer {last:.5f}")
    if not np.isfinite(last):
        raise RuntimeError(f"chamfer not finite: {last}")
    if not smoke and not last < first * 0.5:
        raise RuntimeError(f"chamfer did not halve: {first} → {last}")
    with torch.no_grad():
        out = extract(state)
    nv, nf = int(out["vert_mask"].sum()), int(out["face_mask"].sum())
    print(f"extracted mesh: {nv} verts, {nf} faces (fixed buffers: "
          f"{out['verts'].shape[0]} edge slots)")
    if not (nv > 0 and nf > 0):
        raise RuntimeError("the extracted mesh is empty")
    return {"losses": losses, "first": first, "last": last, "verts": nv,
            "faces": nf, "state": state}


if __name__ == "__main__":
    args = sys.argv[1:]
    main(args[0] if args and args[0] != "smoke" else None,
         smoke="smoke" in args)
