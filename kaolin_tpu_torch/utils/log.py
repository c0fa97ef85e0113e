"""Logging helpers. Counterpart of ``kaolin_tpu/utils/log.py``: the same
strings, for torch tensors (read through numpy, detached, on the host)."""

import logging

import numpy as np
import torch

__all__ = ["default_log_setup", "log_tensor", "tensor_info"]


def default_log_setup(level=logging.INFO):
    """Configure root logging with a sane format."""
    logging.basicConfig(
        level=level,
        format="%(asctime)s|%(levelname)8s| %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")


def _numpy(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def tensor_info(t, name="tensor", print_stats=False, detailed=False):
    """One-line tensor description: shape and dtype, with min, max and mean
    (``print_stats``) and the counts of NaNs and infs (``detailed``)."""
    if t is None:
        return f"{name}: None"
    arr = _numpy(t)
    s = f"{name}: {tuple(arr.shape)} {arr.dtype}"
    if print_stats and arr.size:
        s += (f" min={arr.min():.4g} max={arr.max():.4g}"
              f" mean={arr.mean():.4g}")
    if detailed and arr.size:
        s += f" nans={np.isnan(arr).sum()} infs={np.isinf(arr).sum()}"
    return s


def log_tensor(t, name="tensor", logger=None, level=logging.INFO, **kwargs):
    """Log a tensor description."""
    (logger or logging.getLogger()).log(level, tensor_info(t, name, **kwargs))


def add_log_level_flag(parser):
    """Add a ``--log_level`` argparse flag (int or name)."""
    parser.add_argument(
        "--log_level", type=_str2loglevel, default=logging.INFO,
        help="Logging level: 10 (DEBUG), 20 (INFO), 30 (WARN), 40 (ERROR), "
             "or a level name.")
    return parser


def _str2loglevel(value):
    try:
        return int(value)
    except ValueError:
        level = getattr(logging, str(value).upper(), None)
        if level is None:
            raise ValueError(f"unknown log level {value!r}")
        return level


def print_tensor(t, name="tensor", **kwargs):
    """Print a tensor description (see :func:`tensor_info`)."""
    print(tensor_info(t, name, **kwargs))
