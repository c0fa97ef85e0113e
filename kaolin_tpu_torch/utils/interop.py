"""Hand numpy data to the port, so both packages see identical inputs."""

import numpy as np
import torch


def from_numpy_tree(tree, device):
    """Turn arrays nested in dicts, lists, tuples and namedtuples into torch
    tensors on ``device``, keeping each array's dtype and shape. The tensors
    own their memory (the arrays are copied).

    A namedtuple comes back as the same type, built field by field; its
    fields that are not arrays (a Python int such as ``RasterSPC.level``)
    stay as they are."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            from_numpy_tree(v, device)
            if hasattr(v, "__array__") or isinstance(v, (dict, list, tuple))
            else v for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
