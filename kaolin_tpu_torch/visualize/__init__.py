"""Visualizers of the port: Timelapse checkpoints and the Jupyter
turntable and first-person viewers. Counterpart of
``kaolin_tpu/visualize``."""

from kaolin_tpu_torch.visualize.timelapse import (  # noqa: F401
    Timelapse,
    TimelapseParser,
)
from kaolin_tpu_torch.visualize.ipython import (  # noqa: F401
    BaseIpyVisualizer,
    IpyFirstPersonVisualizer,
    IpyTurntableVisualizer,
    quick_viz,
    update_canvas,
)
