"""Dense linear-algebra helpers of the physics solver, in PyTorch.

Counterpart of ``kaolin_tpu/physics/utils/torch_utilities.py``.
"""

import numpy as np
import torch

__all__ = ["standard_transform_to_relative", "hess_reduction",
           "create_projection_mask", "create_projection_matrix"]


def standard_transform_to_relative(transform):
    """4x4 or 3x4 standard transform → 3x4 relative (minus identity)."""
    t = torch.as_tensor(transform)[:3, :4]
    return t - torch.eye(3, 4, dtype=t.dtype, device=t.device)


def hess_reduction(dense_ja, block_wise_h, dense_jb=None):
    """Jaᵀ H Jb for a block-diagonal H of per-point (b, b) blocks.

    dense_ja: (N·b, R); block_wise_h: (N, b, b); dense_jb: (N·b, R2).
    Returns (R, R2): one batched (N, b, b) x (N, b, R2) product, then one
    (R, N·b) x (N·b, R2) matrix product."""
    if dense_jb is None:
        dense_jb = dense_ja
    n, b, _ = block_wise_h.shape
    hj = torch.bmm(block_wise_h, dense_jb.reshape(n, b, -1))
    return dense_ja.reshape(n * b, -1).T @ hj.reshape(n * b, -1)


def create_projection_mask(num_dofs, kin_dofs):
    """Indices of the dynamic (not kinematic) DOFs, host-side numpy."""
    mask = np.ones(num_dofs, dtype=bool)
    mask[np.asarray(kin_dofs)] = False
    return np.nonzero(mask)[0]


def create_projection_matrix(num_dofs, list_of_kin_dofs):
    """Dense selection matrix without the kinematic DOF rows,
    (num_dofs − k, num_dofs) float32."""
    mask = np.ones(num_dofs, dtype=bool)
    mask[np.asarray(list_of_kin_dofs, dtype=np.int64)] = False
    return torch.from_numpy(np.eye(num_dofs, dtype=np.float32)[mask])
