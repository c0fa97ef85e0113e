"""Unified mesh import dispatcher. Counterpart of ``kaolin_tpu/io/mesh.py``."""

import os

__all__ = ["import_mesh"]


def import_mesh(path, device=None, **kwargs):
    """Dispatch on the file extension (.obj, .off, .usd, .usda, .usdc,
    .usdz, .gltf, .glb, .ply) to the format's ``import_mesh``, on ``device``
    (the CUDA device unless named). The JAX package's dispatcher refuses
    ``.usdz``, which its USD reader reads; this one passes it on."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        from kaolin_tpu_torch.io import obj
        return obj.import_mesh(path, device=device, **kwargs)
    kwargs.pop("triangulate", None)
    if ext == ".off":
        from kaolin_tpu_torch.io import off
        return off.import_mesh(path, device=device, **kwargs)
    if ext in (".usd", ".usda", ".usdc", ".usdz"):
        from kaolin_tpu_torch.io import usd
        return usd.import_mesh(path, device=device, **kwargs)
    if ext in (".gltf", ".glb"):
        from kaolin_tpu_torch.io import gltf
        return gltf.import_mesh(path, device=device)
    if ext == ".ply":
        from kaolin_tpu_torch.io import ply
        return ply.import_mesh(path, device=device)
    raise ValueError(f"unsupported mesh format {ext!r}")
