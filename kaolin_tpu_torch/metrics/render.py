"""Render metrics. Counterpart of ``kaolin_tpu/metrics/render.py``."""

import torch

__all__ = ["mask_iou"]


def mask_iou(lhs_mask, rhs_mask):
    """IoU loss between soft segmentation masks (B, H, W) → scalar
    ``1 - mean(IoU)``."""
    sil_mul = lhs_mask * rhs_mask
    sil_add = lhs_mask + rhs_mask
    b = lhs_mask.shape[0]
    iou_up = torch.sum(sil_mul.reshape(b, -1), dim=1)
    iou_down = torch.sum((sil_add - sil_mul).reshape(b, -1), dim=1)
    return 1.0 - torch.mean(iou_up / (iou_down + 1e-10))
