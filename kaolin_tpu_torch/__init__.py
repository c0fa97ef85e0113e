"""kaolin_tpu_torch — the PyTorch + CUDA port of ``kaolin_tpu``.

The port carries three paths today: the DIB-R inverse-rendering step,
:func:`kaolin_tpu_torch.render.mesh.dibr_rasterization` (winner search,
differentiable re-gather, soft silhouette) and
:func:`kaolin_tpu_torch.metrics.render.mask_iou`; and the SPC first-hit
raster, :func:`kaolin_tpu_torch.render.spc.raster_first_hit` with the
octree build of :mod:`kaolin_tpu_torch.ops.spc` and the cameras of
:mod:`kaolin_tpu_torch.render.camera`. Each Pallas kernel of those paths is
a hand-written CUDA kernel for Hopper (``sm_90a``), built from the ``csrc``
sources at first use; a tensor on the CPU takes the kernel's plain PyTorch
version instead. The third, the Simplicits sim step of
:class:`kaolin_tpu_torch.physics.simplicits.SimplicitsScene`, has no Pallas
kernel in the JAX package and is plain PyTorch here (dense products and
``torch.linalg`` solves), optionally replayed from a CUDA graph; so is the
SPC raytrace of :func:`kaolin_tpu_torch.render.spc.unbatched_raytrace`
with the mesh → SPC conversion of :mod:`kaolin_tpu_torch.ops.conversions`
and the ``Spc`` container of :mod:`kaolin_tpu_torch.rep`, and the FlexiCubes
and marching-tetrahedra extraction of :mod:`kaolin_tpu_torch.ops.conversions`
with the metrics of :mod:`kaolin_tpu_torch.metrics`. The full mesh render,
:func:`kaolin_tpu_torch.render.easy_render.render_mesh` of a
:class:`kaolin_tpu_torch.rep.SurfaceMesh` with the materials and SG lights
of :mod:`kaolin_tpu_torch.render`, is plain PyTorch around the winner
search. :mod:`kaolin_tpu_torch.io` reads and writes OBJ/MTL, glTF/GLB,
PLY (with INRIA 3DGS), OFF and USD (text, Crate binary and ``.usdz``)
files, images through Pillow, and caches dataset preprocessing;
:mod:`kaolin_tpu_torch.ops` also holds the graph convolution of
``ops.gcn`` and the random generators of ``ops.random``.
:mod:`kaolin_tpu_torch.native` is the host C++ library (``check_sign``'s
TriangleHash, the Crate reader's LZ4), built by g++ at first use;
:mod:`kaolin_tpu_torch.visualize` writes Timelapse checkpoints and drives
the Jupyter viewers, and ``experimental.dash3d`` serves the checkpoints.

``kaolin_tpu`` stays the reference. This package imports neither it nor jax.
"""

__version__ = "0.1.0"

from kaolin_tpu_torch import io       # noqa: F401
from kaolin_tpu_torch import math     # noqa: F401
from kaolin_tpu_torch import metrics  # noqa: F401
from kaolin_tpu_torch import non_commercial  # noqa: F401
from kaolin_tpu_torch import ops      # noqa: F401
from kaolin_tpu_torch import physics  # noqa: F401
from kaolin_tpu_torch import render   # noqa: F401
from kaolin_tpu_torch import rep      # noqa: F401
from kaolin_tpu_torch import utils    # noqa: F401
from kaolin_tpu_torch import visualize  # noqa: F401
