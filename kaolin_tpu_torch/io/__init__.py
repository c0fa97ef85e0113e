"""File I/O of the port: OBJ/MTL, glTF/GLB, PLY (meshes, point clouds,
INRIA 3DGS), OFF, USD (``.usda``, ``.usdc``, ``.usdz``), the synthetic-view
loader, the dataset wrappers and ``CachedDataset``. Counterpart of
``kaolin_tpu/io``.

Textures are read and written through Pillow, as the JAX package reads
and writes them. No module imports Pillow when it is imported: a file that
needs it raises an ImportError naming the file where Pillow is missing.
"""

from kaolin_tpu_torch.io import dataset   # noqa: F401
from kaolin_tpu_torch.io import gltf      # noqa: F401
from kaolin_tpu_torch.io import materials  # noqa: F401
from kaolin_tpu_torch.io import obj       # noqa: F401
from kaolin_tpu_torch.io import off       # noqa: F401
from kaolin_tpu_torch.io import ply       # noqa: F401
from kaolin_tpu_torch.io import shapenet  # noqa: F401
from kaolin_tpu_torch.io import shrec     # noqa: F401
from kaolin_tpu_torch.io import usd       # noqa: F401
from kaolin_tpu_torch.io import utils     # noqa: F401
from kaolin_tpu_torch.io.dataset import Cache, CachedDataset  # noqa: F401
from kaolin_tpu_torch.io.mesh import import_mesh  # noqa: F401
from kaolin_tpu_torch.io.modelnet import ModelNet  # noqa: F401
from kaolin_tpu_torch.io.shapenet import ShapeNetV1, ShapeNetV2  # noqa: F401
from kaolin_tpu_torch.io.shrec import SHREC16  # noqa: F401
from kaolin_tpu_torch.io import gaussians  # noqa: F401
from kaolin_tpu_torch.io import render     # noqa: F401
from kaolin_tpu_torch.io.gaussians import import_gaussiancloud  # noqa: F401
from kaolin_tpu_torch.io.render import import_synthetic_view  # noqa: F401
