"""kaolin-dash3d: web visualizer for Timelapse checkpoints.

Counterpart of ``kaolin_tpu/experimental/dash3d`` (reference
``kaolin/experimental/dash3d/``: a tornado server streaming Timelapse
geometry over websockets to a canvas frontend). tornado is imported at
first use.
"""
from kaolin_tpu_torch.experimental.dash3d import util as _util
from kaolin_tpu_torch.experimental.dash3d.run import (  # noqa: F401
    create_server,
    run_main,
)
from kaolin_tpu_torch.experimental.dash3d.util import (  # noqa: F401
    StreamingGeometryHelper,
    meshes_to_binary,
    point_clouds_to_binary,
)


def __getattr__(name):
    if name == "GeometryWebSocketHandler":   # imports tornado
        return _util.GeometryWebSocketHandler
    raise AttributeError(name)
