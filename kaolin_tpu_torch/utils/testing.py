"""Test helpers — shape and dtype checks, seeding, image and container
comparison.

Counterpart of ``kaolin_tpu/utils/testing.py`` for torch tensors. Where
the JAX package returns or passes a PRNG key, :func:`seed_everything` and
:func:`with_seed` seed torch, numpy and Python's ``random`` and return or
pass a ``torch.Generator``, under the same argument name, ``key``.
"""

import functools
import inspect
import random
from collections.abc import Mapping, Sequence

import numpy as np
import torch

from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = [
    "check_tensor",
    "check_packed_tensor",
    "check_padded_tensor",
    "check_spc_octrees",
    "seed_everything",
    "with_seed",
    "assert_images_close",
    "contained_allclose",
    "tensor_info",
]


def _numpy(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _fail(throw, error):
    if throw:
        raise error
    return False


def check_tensor(tensor, shape=None, dtype=None, throw=True):
    """Check a tensor's shape (None entries are wildcards) and torch
    dtype."""
    if shape is not None:
        if len(shape) != tensor.ndim:
            return _fail(throw, ValueError(
                f"tensor rank {tensor.ndim} != expected {len(shape)}"))
        for want, got in zip(shape, tensor.shape):
            if want is not None and want != got:
                return _fail(throw, ValueError(
                    f"tensor shape {tuple(tensor.shape)} != expected "
                    f"{tuple(shape)}"))
    if dtype is not None and tensor.dtype != dtype:
        return _fail(throw, TypeError(
            f"tensor dtype {tensor.dtype} != expected {dtype}"))
    return True


def check_packed_tensor(tensor, total_numel=None, last_dim=None, dtype=None,
                        throw=True):
    """Packed tensors are 2D: (total_numel, last_dim)."""
    if tensor.ndim != 2:
        return _fail(throw, ValueError(
            f"packed tensor must be 2D, got {tensor.ndim}D"))
    return check_tensor(tensor, shape=[total_numel, last_dim], dtype=dtype,
                        throw=throw)


def check_padded_tensor(tensor, padding_value=None, shape_per_tensor=None,
                        batch_size=None, max_shape=None, last_dim=None,
                        dtype=None, throw=True):
    """Padded tensors are (B, *max_shape, last_dim); entries beyond
    shape_per_tensor must equal padding_value."""
    if batch_size is not None and tensor.shape[0] != batch_size:
        return _fail(throw, ValueError(
            f"batch size {tensor.shape[0]} != {batch_size}"))
    if last_dim is not None and tensor.shape[-1] != last_dim:
        return _fail(throw, ValueError(
            f"last dim {tensor.shape[-1]} != {last_dim}"))
    if max_shape is not None:
        for want, got in zip(max_shape, tensor.shape[1:-1]):
            if want is not None and want != got:
                return _fail(throw, ValueError(
                    f"max_shape {tuple(tensor.shape[1:-1])} != {max_shape}"))
    if not check_tensor(tensor, dtype=dtype, throw=throw):
        return False
    if padding_value is not None and shape_per_tensor is not None:
        spt = _numpy(shape_per_tensor)
        arr = _numpy(tensor)
        for i in range(arr.shape[0]):
            sub = arr[i]
            mask = np.ones(sub.shape[:-1], dtype=bool)
            mask[tuple(slice(0, int(s)) for s in spt[i])] = False
            if mask.any() and not np.allclose(sub[mask], padding_value):
                return _fail(throw, ValueError("padding values do not match"))
    return True


def check_spc_octrees(octrees, lengths, batch_size=None, level=None,
                      throw=True):
    """Validate a batch of byte-packed octrees: uint8, as many lengths as
    ``batch_size``, the lengths summing to the bytes."""
    if octrees.dtype != torch.uint8:
        return _fail(throw, TypeError("octrees must be uint8"))
    if batch_size is not None and lengths.shape[0] != batch_size:
        return _fail(throw, ValueError("lengths batch size mismatch"))
    if int(_numpy(lengths).sum()) != octrees.shape[0]:
        return _fail(throw, ValueError("octree length mismatch"))
    return True


def _seed(seed):
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)


def seed_everything(seed, device=None):
    """Seed Python's ``random``, numpy and torch → a ``torch.Generator`` on
    ``device`` (the CUDA device unless named) seeded with ``seed``."""
    device = resolve_device(device, "seed_everything")
    _seed(seed)
    return torch.Generator(device).manual_seed(seed)


def with_seed(seed=0, device=None):
    """Decorator: seed everything before each call and, where the wrapped
    function takes ``key`` and the caller gave none, pass
    ``key=seed_everything(seed, device)``."""
    def decorator(fn):
        takes_key = "key" in inspect.signature(fn).parameters

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if takes_key and "key" not in kwargs:
                kwargs["key"] = seed_everything(seed, device)
            else:
                _seed(seed)
            return fn(*args, **kwargs)
        return wrapper
    return decorator


def assert_images_close(img1, img2, pixel_disagreement_threshold=0.05,
                        max_percent_disagreeing_pixels=1.0):
    """Images match if at most N% of pixels differ by more than the
    threshold (the largest channel difference of a pixel)."""
    a = _numpy(img1).astype(np.float32)
    b = _numpy(img2).astype(np.float32)
    assert a.shape == b.shape, f"image shapes differ: {a.shape} vs {b.shape}"
    diff = np.abs(a - b)
    if diff.ndim == 3:
        diff = diff.max(axis=-1)
    percent = 100.0 * np.mean(diff > pixel_disagreement_threshold)
    assert percent <= max_percent_disagreeing_pixels, (
        f"{percent:.3f}% of pixels disagree "
        f"(> {max_percent_disagreeing_pixels}%)")


def contained_allclose(a, b, rtol=1e-5, atol=1e-8):
    """Recursive dict/list/tensor comparison by allclose."""
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(
            contained_allclose(a[k], b[k], rtol, atol) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            contained_allclose(x, y, rtol, atol) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    if isinstance(a, (str, bool)) or isinstance(b, (str, bool)):
        return a == b
    try:
        return bool(np.allclose(_numpy(a), _numpy(b), rtol=rtol, atol=atol))
    except (TypeError, ValueError):
        return a == b


def tensor_info(t, name="tensor"):
    t = _numpy(t)
    return (f"{name}: shape={t.shape} dtype={t.dtype} "
            f"min={t.min() if t.size else 'NA'} "
            f"max={t.max() if t.size else 'NA'}")


def check_allclose(tensor, other, rtol=1e-5, atol=1e-8, equal_nan=False):
    """Raise with example differences if not allclose."""
    a, b = _numpy(tensor), _numpy(other)
    if not np.allclose(a, b, atol=atol, rtol=rtol, equal_nan=equal_nan):
        diff_idx = np.where(~np.isclose(a, b, atol=atol, rtol=rtol,
                                        equal_nan=equal_nan))
        raise ValueError(
            f"Tensors are not close on indices {diff_idx}: "
            f"Example values: {a[diff_idx][:10]} vs {b[diff_idx][:10]}.")


def contained_torch_equal(elem, other, approximate=False,
                          print_error_context=None, **allclose_args):
    """Deep equality (or allclose, with ``approximate``) of containers that
    may hold tensors; tensors compare by shape and values."""
    def fail(ctx):
        if print_error_context is not None:
            print(f"Mismatch at {print_error_context}.{ctx}")
        return False

    if type(elem).__name__ != type(other).__name__ \
            and not (hasattr(elem, "shape") and hasattr(other, "shape")):
        return fail(f"type {type(elem)} vs {type(other)}")
    if hasattr(elem, "shape") or hasattr(other, "shape"):
        a, b = _numpy(elem), _numpy(other)
        if a.shape != b.shape:
            return fail(f"shape {a.shape} vs {b.shape}")
        if approximate:
            return bool(np.allclose(a, b, **allclose_args)) or fail("values")
        return bool(np.array_equal(a, b)) or fail("values")
    if isinstance(elem, str):
        return elem == other or fail("str")
    if isinstance(elem, Mapping):
        if set(elem.keys()) != set(other.keys()):
            return fail("keys")
        return all(contained_torch_equal(elem[k], other[k], approximate,
                                         print_error_context, **allclose_args)
                   for k in elem)
    if isinstance(elem, Sequence):
        if len(elem) != len(other):
            return fail("length")
        return all(contained_torch_equal(a, b, approximate,
                                         print_error_context, **allclose_args)
                   for a, b in zip(elem, other))
    if approximate and isinstance(elem, float):
        return bool(np.isclose(elem, other, **allclose_args))
    return elem == other or fail("value")


# the array-native name
contained_equal = contained_torch_equal


def check_tensor_attribute_shapes(container, throw=True, **attribute_info):
    """Check the shapes of named attributes of a container (a mapping or
    an object)."""
    result = True
    for k, shape in attribute_info.items():
        value = container[k] if isinstance(container, Mapping) \
            else getattr(container, k)
        if not check_tensor(value, shape=shape, throw=False):
            result = False
            msg = f"attribute {k} failed shape check {shape}, " \
                  f"got {tuple(value.shape)}"
            if throw:
                raise ValueError(msg)
            print(msg)
    return result


def file_contents_equal(file1, file2, exclude_pattern=None):
    """Line-wise file comparison ignoring blank lines (and lines holding
    ``exclude_pattern``)."""
    def get_lines(fname):
        with open(fname) as f:
            lines = [x.strip() for x in f if x.strip()]
        if exclude_pattern is not None:
            lines = [x for x in lines if exclude_pattern not in x]
        return lines
    return get_lines(file1) == get_lines(file2)


def print_dict_attributes(in_dict, name="", prefix="", **tensor_info_kwargs):
    """Print all attributes of a dict, with tensor details."""
    from kaolin_tpu_torch.utils.log import tensor_info as log_info
    if name:
        print(f"Attributes of {name}:")
    for k, v in in_dict.items():
        if hasattr(v, "shape"):
            print(f"  {prefix}{log_info(v, name=k, **tensor_info_kwargs)}")
        else:
            print(f"  {prefix}{k}: ({type(v).__name__}) {v}")


def print_namedtuple_attributes(ntuple, name="", prefix="",
                                **tensor_info_kwargs):
    """Print all fields of a namedtuple, with tensor details."""
    print_dict_attributes(ntuple._asdict(), name=name, prefix=prefix,
                          **tensor_info_kwargs)
