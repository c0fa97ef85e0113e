"""Hand numpy data to the port, so both packages see identical inputs, and
carry the JAX package's Simplicits MLP weights, contact buffers and
configured ``Collision`` objects into the port."""

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


def contacts_from_jax(contacts, device="cpu"):
    """The port's :class:`~kaolin_tpu_torch.physics.common.Contacts` holding
    a JAX ``Contacts`` buffer's arrays (numpy, or anything ``np.asarray``
    takes): the same values, indices as int64, fields that are None kept
    None."""
    from kaolin_tpu_torch.physics.common.collisions import Contacts

    def conv(name, value):
        if value is None:
            return None
        a = np.array(value, copy=True)
        if name.startswith("indices"):
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(device)

    return Contacts(**{name: conv(name, getattr(contacts, name))
                       for name in Contacts._fields})


_COLLISION_FIELDS = (
    "dt", "collision_radius", "collision_detection_ratio",
    "collision_barrier_ratio", "ignore_self_collision_ratio",
    "collision_penalty_stiffness", "friction_reg", "friction_fluid",
    "friction", "max_contacts", "bounds", "broad_phase", "cell_capacity",
    "sweep_window", "slot_contact_capacity", "max_occupied_cells",
    "point_contact_capacity", "grid_dims", "grid_cell")


def collision_from_jax(collision):
    """The port's :class:`~kaolin_tpu_torch.physics.common.Collision` with a
    configured JAX ``Collision``'s parameters, capacities and grid geometry
    (dims, origin, cell): both then detect over the same grid."""
    from kaolin_tpu_torch.physics.common.collisions import Collision

    out = Collision(dt=1.0)
    for name in _COLLISION_FIELDS:
        value = getattr(collision, name)
        if name == "grid_dims" and value is not None:
            value = tuple(int(d) for d in value)
        elif isinstance(value, (np.generic, np.ndarray)) or hasattr(
                value, "__array__"):
            value = np.asarray(value).item()
        setattr(out, name, value)
    if collision.grid_origin is not None:
        out.grid_origin = np.array(collision.grid_origin, np.float32)
    return out
