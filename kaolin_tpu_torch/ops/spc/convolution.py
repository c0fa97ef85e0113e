"""Sparse octree convolutions (SPC Conv3d / ConvTranspose3d).

Counterpart of ``kaolin_tpu/ops/spc/convolution.py``. The neighbour map
n(i, k) (output point i, kernel vector k → input point index or −1)
depends only on the octree's topology and is built on the host in numpy
by a Morton binary search, as in the JAX package; the convolution is a
masked gather and one einsum, ``Y = Σ_k X[n(:, k)] @ W_k``, on the input's
device. The transpose is the exact adjoint through ``index_add_`` over the
same map, so ⟨conv(X), Y⟩ = ⟨X, convᵀ(Y)⟩ to float precision. A 1x1 kernel
with no jump is one matmul.
"""

import numpy as np
import torch
from torch import nn

from kaolin_tpu_torch.ops.spc.points import host, points_to_morton
from kaolin_tpu_torch.ops.spc.spc import unbatched_get_level_points

__all__ = ["conv3d", "conv_transpose3d", "Conv3d", "ConvTranspose3d"]


def _neighbor_map(point_hierarchies, pyramids, in_level, out_level,
                  kernel_vectors):
    """(Nout, K) indices into the ``in_level`` points (−1 = missing), the
    number of input and of output points."""
    pyramid = host(pyramids)[0]
    ph = host(point_hierarchies)
    in_pts = unbatched_get_level_points(ph, pyramid, in_level).astype(np.int64)
    out_pts = unbatched_get_level_points(ph, pyramid,
                                         out_level).astype(np.int64)
    kv = host(kernel_vectors).astype(np.int64)
    in_morton = points_to_morton(in_pts, "cpu").numpy()
    res = 2 ** in_level
    # output coords scaled to the input level, plus the kernel offsets
    targets = (out_pts[:, None, :] << (in_level - out_level)) + kv[None]
    in_range = np.all((targets >= 0) & (targets < res), axis=-1)
    t_morton = points_to_morton(targets.reshape(-1, 3), "cpu").numpy().reshape(
        targets.shape[:2])
    pos = np.clip(np.searchsorted(in_morton, t_morton), 0,
                  in_morton.shape[0] - 1)
    found = (in_morton[pos] == t_morton) & in_range
    return np.where(found, pos, -1), in_pts.shape[0], out_pts.shape[0]


def conv3d(octrees, point_hierarchies, level, pyramids, exsum, input,
           weight, kernel_vectors, jump=0, bias=None, **kwargs):
    """Y_i = Σ_k W_k · X_{n(i, k)} (+ b), downsampled by ``jump`` levels →
    (outputs, out_level)."""
    del octrees, exsum      # the topology comes from the point hierarchy
    if weight.shape[0] == 1 and jump == 0:
        out = input @ weight[0]
    else:
        out_level = level - jump
        nmap, _, _ = _neighbor_map(point_hierarchies, pyramids, level,
                                   out_level, kernel_vectors)
        nmap = torch.from_numpy(nmap).to(input.device)
        gathered = input[nmap.clamp(min=0)] * (nmap >= 0)[..., None]
        out = torch.einsum("nki,kio->no", gathered, weight)
        level = out_level
    if bias is not None:
        out = out + bias[None]
    return out, int(level)


def conv_transpose3d(octrees, point_hierarchies, level, pyramids, exsum,
                     input, weight, kernel_vectors, jump=0, bias=None,
                     **kwargs):
    """The adjoint of :func:`conv3d`, upsampling by ``jump`` levels →
    (outputs, out_level)."""
    del octrees, exsum
    if weight.shape[0] == 1 and jump == 0:
        out = input @ weight[0]
    else:
        out_level = level + jump
        # the adjoint of the conv from out_level down to level
        nmap, n_fine, _ = _neighbor_map(point_hierarchies, pyramids,
                                        out_level, level, kernel_vectors)
        nmap = torch.from_numpy(nmap).to(input.device)
        contrib = torch.einsum("ni,kio->nko", input, weight)
        flat_idx = torch.where(nmap >= 0, nmap, n_fine).reshape(-1)
        out = contrib.new_zeros((n_fine + 1, contrib.shape[-1])).index_add(
            0, flat_idx, contrib.reshape(-1, contrib.shape[-1]))[:n_fine]
        level = out_level
    if bias is not None:
        out = out + bias[None]
    return out, int(level)


class _ConvBase(nn.Module):
    """``weight`` (K, Cin, Cout) drawn uniformly from ±1/√(Cin·K) with
    ``generator`` (the default generator when None), ``bias`` zeros."""

    def __init__(self, in_channels, out_channels, kernel_vectors, jump=0,
                 bias=True, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_vectors = np.asarray(host(kernel_vectors))
        self.jump = jump
        k = self.kernel_vectors.shape[0]
        scale = 1.0 / np.sqrt(in_channels * k)
        w = torch.rand((k, in_channels, out_channels), generator=generator,
                       device=device, dtype=dtype)
        self.weight = nn.Parameter(w * (2 * scale) - scale)
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device,
                                              dtype=dtype))
                     if bias else None)


class Conv3d(_ConvBase):
    """Sparse Conv3d: ``forward(octrees, point_hierarchies, level,
    pyramids, exsum, input)`` → (outputs, out_level)."""

    def forward(self, octrees, point_hierarchies, level, pyramids, exsum,
                input, **kwargs):
        return conv3d(octrees, point_hierarchies, level, pyramids, exsum,
                      input, self.weight, self.kernel_vectors,
                      jump=self.jump, bias=self.bias)


class ConvTranspose3d(_ConvBase):
    """Sparse ConvTranspose3d: ``forward(...)`` as :class:`Conv3d`'s."""

    def forward(self, octrees, point_hierarchies, level, pyramids, exsum,
                input, **kwargs):
        return conv_transpose3d(octrees, point_hierarchies, level, pyramids,
                                exsum, input, self.weight,
                                self.kernel_vectors, jump=self.jump,
                                bias=self.bias)
