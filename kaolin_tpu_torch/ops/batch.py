"""Batched-tensor conventions: list / packed / padded.

Counterpart of ``kaolin_tpu/ops/batch.py``. Three layouts for items of
different sizes (meshes with different vertex counts):

* **list**: a Python list of per-item tensors;
* **packed**: one 2D tensor ``(total_numel, last_dim)`` concatenating the
  items along dim 0, with the metadata ``shape_per_tensor`` and
  ``first_idx``;
* **padded**: a dense ``(B, *max_shape, last_dim)`` tensor with a padding
  value.

As in the JAX package, the metadata are numpy arrays on the host (a torch
tensor is accepted wherever they are read); the data are torch tensors.
"""

import numpy as np
import torch

from kaolin_tpu_torch.utils.backend import input_device

__all__ = [
    "get_shape_per_tensor",
    "get_first_idx",
    "list_to_packed",
    "packed_to_list",
    "list_to_padded",
    "padded_to_list",
    "packed_to_padded",
    "padded_to_packed",
    "tile_to_packed",
    "fill_max_shape",
    "packed_segment_ids",
    "packed_simple_sum",
]


def host(x, dtype=None):
    """Metadata or topology (numpy, a list or a torch tensor) → numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def get_shape_per_tensor(tensor_list):
    """Stack the shapes (minus the last dim) of each item → (B, ndim - 1)
    int64 numpy."""
    if len(tensor_list) == 0:
        raise ValueError("empty tensor list")
    ndim = tensor_list[0].ndim
    for t in tensor_list:
        if t.ndim != ndim:
            raise ValueError("all tensors must have the same rank")
    return np.array([tuple(t.shape[:-1]) for t in tensor_list],
                    dtype=np.int64)


def get_first_idx(numel_per_tensor):
    """Exclusive cumsum with a leading 0: the start of each item, and the
    total at the end → (B + 1,) int64 numpy.

    Example:
        >>> get_first_idx([2, 3, 1]).tolist()
        [0, 2, 5, 6]
    """
    numel = host(numel_per_tensor, np.int64)
    out = np.zeros(numel.shape[0] + 1, dtype=np.int64)
    np.cumsum(numel, out=out[1:])
    return out


def list_to_packed(tensor_list):
    """Concatenate (..., last_dim) tensors into a packed 2D tensor →
    (packed_tensor, shape_per_tensor)."""
    shape_per_tensor = get_shape_per_tensor(tensor_list)
    last_dim = tensor_list[0].shape[-1]
    for t in tensor_list:
        if t.shape[-1] != last_dim:
            raise ValueError("all tensors must share last_dim")
    packed = torch.cat([torch.as_tensor(t).reshape(-1, last_dim)
                        for t in tensor_list], dim=0)
    return packed, shape_per_tensor


def packed_to_list(packed_tensor, shape_per_tensor, first_idx):
    """Split a packed tensor back into a list."""
    spt = host(shape_per_tensor)
    fi = host(first_idx)
    return [packed_tensor[int(fi[i]):int(fi[i + 1])].reshape(
        tuple(int(s) for s in spt[i]) + (packed_tensor.shape[-1],))
        for i in range(spt.shape[0])]


def fill_max_shape(shape_per_tensor, partial_max_shape=None):
    """Fill the None entries of a partial max shape with per-dim maxima."""
    maxima = host(shape_per_tensor).max(axis=0)
    if partial_max_shape is None:
        return tuple(int(m) for m in maxima)
    out = []
    for i, v in enumerate(partial_max_shape):
        if v is None:
            out.append(int(maxima[i]))
        else:
            if v < maxima[i]:
                raise ValueError(f"max_shape[{i}]={v} < required "
                                 f"{maxima[i]}")
            out.append(int(v))
    return tuple(out)


def list_to_padded(tensor_list, padding_value, max_shape=None):
    """Stack a list into a dense padded batch (B, *max_shape, last_dim) →
    (padded, shape_per_tensor)."""
    shape_per_tensor = get_shape_per_tensor(tensor_list)
    max_shape = fill_max_shape(shape_per_tensor, max_shape)
    padded = []
    for t in tensor_list:
        t = torch.as_tensor(t)
        pads = []
        for m, s in reversed(list(zip(max_shape, t.shape[:-1]))):
            pads += [0, m - s]
        padded.append(torch.nn.functional.pad(t, [0, 0] + pads,
                                              value=padding_value))
    return torch.stack(padded, dim=0), shape_per_tensor


def padded_to_list(padded_tensor, shape_per_tensor):
    """Slice a padded batch back into a list."""
    spt = host(shape_per_tensor)
    return [padded_tensor[(i,) + tuple(slice(0, int(s)) for s in spt[i])]
            for i in range(spt.shape[0])]


def packed_to_padded(packed_tensor, shape_per_tensor, first_idx,
                     padding_value, max_shape=None):
    """Packed → padded. Items of one dim (B items of (N_i, last_dim)) take
    one gather; other ranks go through a list."""
    spt = host(shape_per_tensor)
    if spt.shape[1] == 1:
        fi = host(first_idx)
        max_n = fill_max_shape(spt, max_shape)[0]
        b = spt.shape[0]
        base = fi[:-1, None] + np.arange(max_n)[None, :]
        mask = np.arange(max_n)[None, :] < spt[:, 0:1]
        safe = torch.as_tensor(np.where(mask, base, 0).reshape(-1),
                               device=packed_tensor.device)
        gathered = packed_tensor[safe].reshape(b, max_n,
                                               packed_tensor.shape[-1])
        mask = torch.as_tensor(mask, device=packed_tensor.device)
        return torch.where(mask[..., None], gathered,
                           torch.as_tensor(padding_value,
                                           dtype=packed_tensor.dtype,
                                           device=packed_tensor.device))
    tensor_list = packed_to_list(packed_tensor, shape_per_tensor, first_idx)
    return list_to_padded(tensor_list, padding_value, max_shape)[0]


def padded_to_packed(padded_tensor, shape_per_tensor):
    """Padded → packed."""
    spt = host(shape_per_tensor)
    if spt.shape[1] != 1:
        return list_to_packed(padded_to_list(padded_tensor,
                                             shape_per_tensor))[0]
    idx_b = np.concatenate([np.full(int(n), i) for i, n in
                            enumerate(spt[:, 0])])
    idx_n = np.concatenate([np.arange(int(n)) for n in spt[:, 0]])
    dev = padded_tensor.device
    return padded_tensor[torch.as_tensor(idx_b, device=dev),
                         torch.as_tensor(idx_n, device=dev)].reshape(
        -1, padded_tensor.shape[-1])


def packed_segment_ids(shape_per_tensor, total=None, device=None):
    """The item id of each packed row → int32 tensor on ``device``, by
    default ``shape_per_tensor``'s device when it is a tensor, else the
    CUDA device; rows past the items, up to ``total``, get the id B."""
    device = input_device(shape_per_tensor, device, "packed_segment_ids")
    spt = host(shape_per_tensor)
    numel = spt.prod(axis=1) if spt.ndim == 2 else spt
    ids = np.repeat(np.arange(numel.shape[0]), numel)
    if total is not None and total > ids.shape[0]:
        ids = np.concatenate([ids, np.full(total - ids.shape[0],
                                           numel.shape[0])])
    return torch.as_tensor(ids, dtype=torch.int32, device=device)


def tile_to_packed(values, numel_per_tensor):
    """One value per item broadcast to every packed row of the item →
    (total, 1)."""
    numel = host(numel_per_tensor)
    ids = torch.as_tensor(np.repeat(np.arange(numel.shape[0]), numel),
                          device=values.device)
    return values[ids].reshape(-1, 1)


def packed_simple_sum(packed_tensor, numel_per_tensor):
    """Per-item sum over a packed tensor → (B,), by ``index_add_``."""
    numel = host(numel_per_tensor)
    ids = torch.as_tensor(np.repeat(np.arange(numel.shape[0]), numel),
                          device=packed_tensor.device)
    flat = packed_tensor.sum(-1) if packed_tensor.ndim == 2 \
        else packed_tensor
    out = torch.zeros(numel.shape[0], dtype=flat.dtype, device=flat.device)
    return out.index_add(0, ids, flat)
