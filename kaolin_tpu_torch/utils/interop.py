"""Hand numpy data to the port, so both packages see identical inputs, and
carry the JAX package's Simplicits MLP weights into the port."""

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


def simplicits_mlp_from_jax(params, bb_min=None, bb_max=None):
    """The port's :class:`~kaolin_tpu_torch.physics.simplicits.SimplicitsMLP`
    holding the JAX package's MLP weights: ``params`` is its list of
    ``{"w": (in, out), "b": (out,)}`` arrays (numpy, or anything
    ``np.asarray`` takes), transposed here into ``nn.Linear``'s (out, in).
    ``bb_min``/``bb_max`` are the skinning function's box."""
    from kaolin_tpu_torch.physics.simplicits.network import SimplicitsMLP

    ws = [np.array(layer["w"], np.float32) for layer in params]
    bs = [np.array(layer["b"], np.float32) for layer in params]
    mlp = SimplicitsMLP(ws[0].shape[0], ws[0].shape[1], ws[-1].shape[1] + 1,
                        len(ws) - 2, bb_min=bb_min, bb_max=bb_max)
    with torch.no_grad():
        for linear, w, b in zip(mlp.layers, ws, bs):
            if tuple(linear.weight.shape) != w.T.shape:
                raise ValueError(f"layer of shape {w.shape} does not fit "
                                 f"the architecture {mlp.layers}")
            linear.weight.copy_(torch.from_numpy(w.T.copy()))
            linear.bias.copy_(torch.from_numpy(b))
    return mlp
