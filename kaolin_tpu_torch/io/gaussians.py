"""Format-dispatching gaussian-splat cloud import.

Counterpart of ``kaolin_tpu/io/gaussians.py``.
"""

__all__ = ["import_gaussiancloud"]


def import_gaussiancloud(filename, device=None):
    """Read a 3D Gaussian Splat cloud (.ply, .usd, .usda, .usdc, .usdz) →
    GaussianSplatModel on ``device`` (the CUDA device unless named)."""
    extension = filename.split(".")[-1].lower()
    if extension == "ply":
        from kaolin_tpu_torch.io import ply
        return ply.import_gaussiancloud(filename, device=device)
    if extension in ("usd", "usda", "usdc", "usdz"):
        from kaolin_tpu_torch.io import usd
        return usd.import_gaussiancloud(filename, device=device)
    raise ValueError(
        f"Unsupported Gaussian Splat filename extension {extension}")
