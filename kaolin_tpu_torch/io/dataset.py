"""Dataset utilities: preprocess once, cache on disk.

Counterpart of ``kaolin_tpu/io/dataset.py``. Preprocessing is meant for
the host: its results are cached as pickled numpy trees, and a read turns
the cached tree's arrays into tensors on the dataset's ``device``. A source
and transform run where they put their tensors, so a source that makes its
own (a ``ShapeNetV2``, say) is given ``device="cpu"``. Every read, the first and
the cached ones, goes through that conversion, so every read gives the same
types and values. A namedtuple is rebuilt field by field; the JAX package
rebuilds it from one generator and raises (fault F30).

``num_workers`` > 1 preprocesses in a pool of *spawned* processes, which
import on the CPU and see no CUDA device.
"""

import hashlib
import os
import pickle
import warnings
from collections import namedtuple

import numpy as np
import torch

from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["Cache", "CachedDataset"]


class Cache:
    """Disk-backed memoization of a function by name and key."""

    def __init__(self, func, cache_dir, cache_key=""):
        self.func = func
        self.cache_dir = os.path.abspath(cache_dir)
        self.cache_key = cache_key
        os.makedirs(self.cache_dir, exist_ok=True)

    def _path(self, name):
        h = hashlib.sha1(f"{self.cache_key}:{name}".encode()).hexdigest()[:16]
        return os.path.join(self.cache_dir, f"{h}.pkl")

    def __call__(self, name, *args, **kwargs):
        p = self._path(name)
        if os.path.exists(p):
            with open(p, "rb") as f:
                return pickle.load(f)
        out = self.func(*args, **kwargs)
        with open(p, "wb") as f:
            pickle.dump(out, f)
        return out


def _map_tree(fn, tree):
    """``fn`` on every leaf of nested dicts, lists, tuples and
    namedtuples, the containers rebuilt as they were."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _to_numpy(tree):
    """Tensors → numpy arrays; every other leaf as it is."""
    return _map_tree(lambda x: x.detach().cpu().numpy()
                     if isinstance(x, torch.Tensor) else x, tree)


def _to_device(tree, device):
    """numpy arrays (not of objects or strings) → tensors on ``device``;
    every other leaf as it is."""
    return _map_tree(lambda x: torch.from_numpy(np.array(x)).to(device)
                     if isinstance(x, np.ndarray) and x.dtype.kind in "biuf"
                     else x, tree)


def _preprocess(source, transform, index):
    item = source[index]
    return _to_numpy(item if transform is None else transform(item))


class CachedDataset:
    """Wrap a source dataset with a preprocessing function whose outputs are
    cached to disk on first access (or ahead of time).

    Args:
        source: indexable dataset (len + getitem), read on the host: a
            source that makes its own tensors is given ``device="cpu"``
            (a spawned worker sees no CUDA device).
        preprocessing_transform: applied once, cached.
        transform: applied at read time (not cached), to the item on
            ``device``.
        cache_dir: where to store the cache; None disables caching.
        num_workers: parallel preprocessing workers (0 = lazy, in-process).
        force_overwrite: recompute even if cached.
        device: where the items' tensors land, the CUDA device unless
            named.
    """

    def __init__(self, source, preprocessing_transform=None, transform=None,
                 cache_dir=None, num_workers=0, force_overwrite=False,
                 device=None):
        self.source = source
        self.preprocessing_transform = preprocessing_transform
        self.transform = transform
        self.cache_dir = cache_dir
        self.force_overwrite = force_overwrite
        self.device = resolve_device(device, "CachedDataset")
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
        if num_workers and cache_dir is not None \
                and preprocessing_transform is not None:
            self._preprocess_all(num_workers)

    def _cache_path(self, index):
        return os.path.join(self.cache_dir, f"item_{index:08d}.pkl")

    def _get_preprocessed(self, index):
        """The item's numpy tree, from the cache where there is one."""
        if self.cache_dir is None or self.preprocessing_transform is None:
            return _preprocess(self.source, self.preprocessing_transform,
                               index)
        p = self._cache_path(index)
        if os.path.exists(p) and not self.force_overwrite:
            with open(p, "rb") as f:
                return pickle.load(f)
        item = _preprocess(self.source, self.preprocessing_transform, index)
        with open(p, "wb") as f:
            pickle.dump(item, f)
        return item

    def _preprocess_all(self, num_workers):
        """Preprocess every item not cached yet up front, in a pool of
        spawned processes that write the caches themselves. ``source`` and
        ``preprocessing_transform`` must pickle; where the pool cannot be
        set up, a warning says so and the items are preprocessed here, one
        by one."""
        todo = [i for i in range(len(self))
                if self.force_overwrite
                or not os.path.exists(self._cache_path(i))]
        if not todo:
            return
        if num_workers > 1:
            import multiprocessing as mp
            try:
                ctx = mp.get_context("spawn")
                with ctx.Pool(
                        min(num_workers, len(todo)),
                        initializer=_pool_init,
                        initargs=(self.source, self.preprocessing_transform,
                                  self.cache_dir)) as pool:
                    for _ in pool.imap_unordered(_pool_preprocess, todo,
                                                 chunksize=4):
                        pass
                return
            except Exception as e:  # unpicklable source/transform, etc.
                warnings.warn(f"parallel preprocessing failed ({e!r}); "
                              "falling back to serial")
        for i in todo:
            self._get_preprocessed(i)

    def __len__(self):
        return len(self.source)

    def __getitem__(self, index):
        item = _to_device(self._get_preprocessed(index), self.device)
        if self.transform is not None:
            item = self.transform(item)
        return item


_POOL_STATE = {}


def _pool_init(source, preprocessing_transform, cache_dir):
    # a worker runs on the CPU: no CUDA device is visible to it
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _POOL_STATE["source"] = source
    _POOL_STATE["transform"] = preprocessing_transform
    _POOL_STATE["cache_dir"] = cache_dir


def _pool_preprocess(index):
    item = _preprocess(_POOL_STATE["source"], _POOL_STATE["transform"],
                       index)
    path = os.path.join(_POOL_STATE["cache_dir"], f"item_{index:08d}.pkl")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(item, f)
    os.replace(tmp, path)
    return index


KaolinDatasetItem = namedtuple("KaolinDatasetItem", ["data", "attributes"])


class KaolinDataset:
    """Dataset returning ``KaolinDatasetItem(data, attributes)``; subclasses
    implement ``initialize``, ``get_data``, ``get_attributes``,
    ``__len__``."""

    def __init__(self, *args, **kwargs):
        self.initialize(*args, **kwargs)

    def initialize(self, *args, **kwargs):
        raise NotImplementedError

    def get_data(self, index):
        raise NotImplementedError

    def get_attributes(self, index):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        return KaolinDatasetItem(data=self.get_data(index),
                                 attributes=self.get_attributes(index))


class CombinationDataset(KaolinDataset):
    """Zips several datasets: data is a tuple of each dataset's data,
    attributes a tuple of their attributes."""

    def initialize(self, *datasets):
        if not datasets:
            raise ValueError("at least one dataset required")
        self.len = len(datasets[0])
        if any(len(ds) != self.len for ds in datasets):
            raise ValueError("datasets must have equal length")
        self.datasets = datasets

    def __len__(self):
        return self.len

    def get_data(self, index):
        return tuple(_field(ds[index], 0) for ds in self.datasets)

    def get_attributes(self, index):
        return tuple(_field(ds[index], 1) for ds in self.datasets)


def _field(item, i):
    if isinstance(item, KaolinDatasetItem):
        return item[i]
    return item if i == 0 else {}


class ProcessedDataset(CachedDataset):
    """Deprecated alias of :class:`CachedDataset`."""

    def __init__(self, dataset, preprocessing_transform=None, cache_dir=None,
                 num_workers=None, transform=None, no_progress=False,
                 device=None):
        warnings.warn("ProcessedDataset is deprecated; use CachedDataset",
                      DeprecationWarning)
        super().__init__(dataset,
                         preprocessing_transform=preprocessing_transform,
                         transform=transform, cache_dir=cache_dir,
                         num_workers=num_workers or 0, device=device)
