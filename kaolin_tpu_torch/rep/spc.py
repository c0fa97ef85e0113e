"""Spc container: batched structured point clouds.

Counterpart of ``kaolin_tpu/rep/spc.py``: holds octrees and lengths and
computes (max_level, pyramids, exsum, point_hierarchies) when first read,
caching them on the instance. Every tensor stays on the device of
``octrees``.
"""

import torch

__all__ = ["Spc"]


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


class Spc:
    """Batched byte-packed octrees."""

    KEYS = {"octrees", "lengths", "max_level", "pyramids", "exsum",
            "point_hierarchies"}

    def __init__(self, octrees, lengths, max_level=None, pyramids=None,
                 exsum=None, point_hierarchies=None):
        self.octrees = _tensor(octrees)
        self.lengths = _tensor(lengths).to(self.octrees.device)
        self._max_level = max_level
        self._pyramids = pyramids
        self._exsum = exsum
        self._point_hierarchies = point_hierarchies

    @classmethod
    def from_features(cls, feature_grids, masks=None):
        """Dense feature grids → (Spc, features)."""
        from kaolin_tpu_torch.ops.spc import feature_grids_to_spc
        octrees, lengths, features = feature_grids_to_spc(feature_grids, masks)
        return cls(octrees, lengths), features

    @classmethod
    def from_list(cls, octrees_list):
        """Batch a list of single octree byte tensors."""
        if len(octrees_list) == 0:
            raise ValueError("from_list requires at least one octree")
        octs = [_tensor(o).to(torch.uint8).reshape(-1) for o in octrees_list]
        lengths = torch.tensor([o.shape[0] for o in octs], dtype=torch.int32,
                               device=octs[0].device)
        return cls(torch.cat(octs), lengths)

    @classmethod
    def make_dense(cls, level, device=None):
        """A fully dense octree of ``level`` subdivisions: sum_{l<level}
        8^l bytes of 0xFF, on ``device`` (the CPU when None)."""
        if level <= 0:
            raise ValueError("level must be positive")
        num_nodes = sum(8 ** lv for lv in range(level))
        octree = torch.full((num_nodes,), 0xFF, dtype=torch.uint8,
                            device=device)
        return cls(octree, torch.tensor([num_nodes], dtype=torch.int32,
                                        device=device))

    def _apply_scan_octrees(self):
        from kaolin_tpu_torch.ops.spc import scan_octrees
        self._max_level, self._pyramids, self._exsum = scan_octrees(
            self.octrees, self.lengths)

    def _apply_generate_points(self):
        from kaolin_tpu_torch.ops.spc import generate_points
        self._point_hierarchies = generate_points(self.octrees, self.pyramids,
                                                  self.exsum)

    @property
    def max_level(self):
        if self._max_level is None:
            self._apply_scan_octrees()
        return self._max_level

    @property
    def pyramids(self):
        if self._pyramids is None:
            self._apply_scan_octrees()
        return self._pyramids

    @property
    def exsum(self):
        if self._exsum is None:
            self._apply_scan_octrees()
        return self._exsum

    @property
    def point_hierarchies(self):
        if self._point_hierarchies is None:
            self._apply_generate_points()
        return self._point_hierarchies

    @property
    def batch_size(self):
        return self.lengths.shape[0]

    def __len__(self):
        return self.batch_size

    def to_dict(self, keys=None):
        keys = self.KEYS if keys is None else keys
        return {k: getattr(self, k) for k in keys}

    def num_points(self, lod):
        """Points at a level of detail → (B,)."""
        return self.pyramids[:, 0, lod]

    def __repr__(self):
        return f"Spc(batch_size={self.batch_size}, max_level={self.max_level})"
