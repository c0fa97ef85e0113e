"""Format-dispatching gaussian-splat cloud import.

Counterpart of ``kaolin_tpu/io/gaussians.py``.
"""

__all__ = ["import_gaussiancloud"]


def import_gaussiancloud(filename, device=None):
    """Read a 3D Gaussian Splat cloud (.ply) → GaussianSplatModel on
    ``device`` (the CUDA device unless named). USD files are not read by
    the port yet."""
    extension = filename.split(".")[-1].lower()
    if extension == "ply":
        from kaolin_tpu_torch.io import ply
        return ply.import_gaussiancloud(filename, device=device)
    if extension in ("usd", "usda", "usdc", "usdz"):
        raise NotImplementedError(
            "USD is not ported yet: see ROADMAP, Queue A, \"USD and the "
            "native library\"")
    raise ValueError(
        f"Unsupported Gaussian Splat filename extension {extension}")
