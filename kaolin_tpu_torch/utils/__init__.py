from kaolin_tpu_torch.utils.backend import is_cuda  # noqa: F401
from kaolin_tpu_torch.utils.interop import from_numpy_tree  # noqa: F401
