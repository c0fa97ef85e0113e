"""Environment-variable registry. Counterpart of
``kaolin_tpu/utils/env_vars.py``."""

import enum
import os

__all__ = ["KaolinTestEnvVars", "KaolinEnvVars", "get_env"]


class KaolinTestEnvVars(str, enum.Enum):
    """Env vars gating optional tests (heavyweight datasets, backends)."""
    TEST_SCANNED_TOYS = "KAOLIN_TEST_SCANNED_TOYS"
    TEST_TENSOR_IR = "KAOLIN_TEST_TENSOR_IR"
    TEST_GSPLATS_DIR = "KAOLIN_TEST_GSPLATS_DIR"
    TEST_MODELNET_PATH = "KAOLIN_TEST_MODELNET_PATH"
    TEST_SHAPENETV1_PATH = "KAOLIN_TEST_SHAPENETV1_PATH"
    TEST_SHAPENETV2_PATH = "KAOLIN_TEST_SHAPENETV2_PATH"
    TEST_SHREC16_PATH = "KAOLIN_TEST_SHREC16_PATH"


class KaolinEnvVars(str, enum.Enum):
    """Env vars read by the library."""
    SCANNED_TOYS_PATH = "KAOLIN_SCANNED_TOYS_PATH"
    BUNDLED_DATA_DIR = "KAOLIN_BUNDLED_DATA_DIR"


def get_env(var, default=None):
    """Read a registered env var (enum member or raw name)."""
    name = var.value if isinstance(var, enum.Enum) else var
    return os.environ.get(name, default)
