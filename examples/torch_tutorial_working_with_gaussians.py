"""Tutorial: working with 3D gaussians, with the PyTorch port.

The steps of ``examples/tutorial_working_with_gaussians.py`` (the reference
notebook ``examples/tutorial/working_with_gaussians.ipynb``): build a
``GaussianSplatModel``, slice and concatenate it, transform it rigidly
(with the Wigner-D rotation of its spherical harmonics, so view-dependent
color follows the object), voxelize it to a shell, and densify its
interior with ``sample_points_in_volume`` — the pipeline that feeds
simulatable gaussians. Each step asserts what the JAX tutorial asserts.

    PYTHONPATH=. python examples/torch_tutorial_working_with_gaussians.py
        [cuda|cpu] [smoke]

It runs on the CUDA device unless ``cpu`` is named; ``smoke`` is the
tutorial's small size (300 gaussians).
"""

import sys

import numpy as np
import torch

from kaolin_tpu_torch.ops.conversions import gs_to_voxelgrid
from kaolin_tpu_torch.ops.gaussians import (
    sample_points_in_volume,
    transform_gaussians,
)
from kaolin_tpu_torch.rep import GaussianSplatModel


def _shell(n, rng, radius=0.4, center=(0.0, 0.0, 0.0)):
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.asarray(center, np.float32) + radius * d)


def make_model(n, device):
    """The tutorial's model: ``n`` gaussians on a sphere of radius 0.4,
    scales 0.05, opacity 0.9, SH degree 1 (DC 0.5, the rest seeded)."""
    rng = np.random.RandomState(0)
    xyz = _shell(n, rng)
    sh = np.concatenate([np.full((n, 1, 3), 0.5, np.float32),
                         0.1 * rng.randn(n, 3, 3).astype(np.float32)],
                        axis=1)
    return GaussianSplatModel(
        positions=torch.from_numpy(xyz).to(device),
        orientations=torch.tensor([1.0, 0, 0, 0],
                                  device=device).repeat(n, 1),
        scales=torch.full((n, 3), 0.05, device=device),
        opacities=torch.full((n,), 0.9, device=device),
        sh_coeff=torch.from_numpy(sh).to(device))


def main(smoke=False, device="cuda"):
    n = 300 if smoke else 2000
    gs = make_model(n, device)
    xyz = gs.positions
    assert len(gs.positions) == n

    # 1. container protocol: boolean-mask slicing and concatenation
    top = gs[xyz[:, 1] > 0]
    bottom = gs[xyz[:, 1] <= 0]
    both = GaussianSplatModel.cat([top, bottom])
    assert len(both.positions) == n

    # 2. rigid transform with SH rotation (Wigner-D): view-dependent color
    # follows the rotation
    angle = np.pi / 2
    rot = np.asarray([[1, 0, 0],
                      [0, np.cos(angle), -np.sin(angle)],
                      [0, np.sin(angle), np.cos(angle)]], np.float32)
    tfm = np.eye(4, dtype=np.float32)
    tfm[:3, :3] = rot
    tfm[:3, 3] = [0.0, 0.5, 0.0]
    new_pos, new_rot, new_scales, new_sh = transform_gaussians(
        gs.positions, gs.orientations, gs.scales,
        torch.from_numpy(tfm).to(device), sh_coeff=gs.sh_coeff)
    np.testing.assert_allclose(
        new_pos.mean(dim=0).cpu().numpy(),
        rot @ gs.positions.mean(dim=0).cpu().numpy()
        + np.asarray([0.0, 0.5, 0.0]), atol=1e-5)
    # degree-0 SH (view-independent) is rotation-invariant
    np.testing.assert_allclose(new_sh[:, 0].cpu().numpy(),
                               gs.sh_coeff[:, 0].cpu().numpy(), atol=1e-5)
    # degree-1 coefficients rotate but keep their norm (Wigner-D is
    # orthogonal per degree)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(new_sh[:, 1:], dim=1).cpu().numpy(),
        torch.linalg.vector_norm(gs.sh_coeff[:, 1:], dim=1).cpu().numpy(),
        atol=1e-4)

    # 3. shell voxelization (the first stage of the densifier)
    level = 4 if smoke else 5
    vox_coords, vox_opac = gs_to_voxelgrid(gs.positions, gs.scales,
                                           gs.orientations, gs.opacities,
                                           level=level)
    assert vox_coords.shape[0] > 0

    # 4. interior densification: volumetric physics samples inside the shell
    pts = sample_points_in_volume(
        gs.positions, gs.scales, gs.orientations, gs.opacities,
        octree_level=6, num_samples=128 if smoke else 1024,
        method="floodfill")
    r = torch.linalg.vector_norm(pts, dim=1)
    assert bool((r < 0.55).all()), "densified samples stay inside the shell"
    assert float(r.min()) < 0.35, \
        "densifier fills the INTERIOR, not just the shell"
    print("working_with_gaussians:",
          {"n": n, "device": str(pts.device),
           "voxels": int(vox_coords.shape[0]),
           "volume_samples": int(pts.shape[0])})
    return gs


if __name__ == "__main__":
    main(smoke="smoke" in sys.argv[1:],
         device="cpu" if "cpu" in sys.argv[1:] else "cuda")
