"""Hand numpy data to the port, so both packages see identical inputs."""

import numpy as np
import torch


def from_numpy_tree(tree, device):
    """Turn numpy arrays nested in dicts, lists and tuples into torch tensors
    on ``device``, keeping each array's dtype and shape. The tensors own
    their memory (the arrays are copied)."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
