"""Voxelgrid metrics. Counterpart of ``kaolin_tpu/metrics/voxelgrid.py``."""

__all__ = ["iou"]


def iou(pred, gt):
    """IoU between binary voxelgrids (B, X, Y, Z) → (B,)."""
    if pred.shape != gt.shape:
        raise ValueError(f"shape mismatch {tuple(pred.shape)} vs "
                         f"{tuple(gt.shape)}")
    p = pred.bool().reshape(pred.shape[0], -1)
    g = gt.bool().reshape(gt.shape[0], -1)
    inter = (p & g).sum(-1).float()
    union = (p | g).sum(-1).float()
    return inter / union.clamp(min=1.0)
