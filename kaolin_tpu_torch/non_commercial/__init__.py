"""The reference's ``kaolin.non_commercial`` namespace.

The reference kaolin keeps FlexiCubes under a non-commercial licence in
``kaolin/non_commercial/__init__.py``. This package's FlexiCubes lives in
:mod:`kaolin_tpu_torch.ops.conversions.flexicubes` and is re-exported here,
so that ``from kaolin.non_commercial import FlexiCubes`` ports as it is.
"""

from kaolin_tpu_torch.ops.conversions.flexicubes import (  # noqa: F401
    FlexiCubes,
)

__all__ = ["FlexiCubes"]
