"""Graph convolution (Kipf & Welling style). Counterpart of
``kaolin_tpu/ops/gcn.py``.

A sparse adjacency is the COO tuple ``(indices (2, nnz), values (nnz,),
shape)``; its product with a dense batch gathers the columns, scales them
and sums them into their rows by ``index_add_`` (JAX's ``segment_sum``).
A dense (M, N) adjacency works too.
"""

import torch
from torch import nn

from kaolin_tpu_torch.utils.backend import resolve_device

__all__ = ["sparse_bmm", "normalize_adj", "GraphConv"]


def _is_coo(adj):
    return isinstance(adj, tuple) and len(adj) == 3


def sparse_bmm(sparse_matrix, dense_matrix_batch):
    """(M, N) sparse COO ``(indices, values, (M, N))`` @ (B, N, P) → (B, M,
    P)."""
    indices, values, shape = sparse_matrix
    rows, cols = indices[0].long(), indices[1].long()
    gathered = dense_matrix_batch[:, cols] * values[None, :, None]
    out = gathered.new_zeros((gathered.shape[0], shape[0],
                              gathered.shape[2]))
    return out.index_add(1, rows, gathered)


def normalize_adj(adj):
    """Row-normalize an adjacency matrix (dense tensor or COO tuple)."""
    if _is_coo(adj):
        indices, values, shape = adj
        rows = indices[0].long()
        norm = values.new_zeros(shape[0]).index_add(0, rows, values)
        return indices, values / norm[rows], shape
    return adj / torch.sum(adj, dim=-1, keepdim=True)


# GraphConv.forward's ``normalize_adj`` flag hides the function's name
_normalize_adj = normalize_adj


class GraphConv(nn.Module):
    """Graph convolution ``A H W + b (+ H W_self + b_self)``, with the JAX
    package's parameter names: ``w`` and ``w_self`` (input_dim, output_dim)
    drawn U(−1/√input_dim, 1/√input_dim), ``b`` and ``b_self`` zeros. The
    draws come from ``key``, a ``torch.Generator`` (the module is made on
    its device), or from a generator seeded with 0 on ``device``, the CUDA
    device unless named."""

    def __init__(self, input_dim, output_dim, self_layer=True, bias=True,
                 key=None, device=None):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.self_layer = self_layer
        self.bias = bias
        gen = key if key is not None else torch.Generator(
            resolve_device(device, "GraphConv")).manual_seed(0)
        scale = 1.0 / input_dim ** 0.5

        def weight():
            w = torch.rand((input_dim, output_dim), generator=gen,
                           device=gen.device)
            return nn.Parameter(w * (2 * scale) - scale)

        def zeros():
            return nn.Parameter(torch.zeros(output_dim, device=gen.device))

        self.w = weight()
        self.b = zeros() if bias else None
        self.w_self = weight() if self_layer else None
        self.b_self = zeros() if self_layer and bias else None

    def forward(self, node_feat, adj, normalize_adj=True):
        """(B, N, input_dim) features and an (N, N) adjacency → (B, N,
        output_dim)."""
        if normalize_adj:
            adj = _normalize_adj(adj)
        h = node_feat @ self.w
        if self.b is not None:
            h = h + self.b
        out = sparse_bmm(adj, h) if _is_coo(adj) else \
            torch.einsum("mn,bno->bmo", adj, h)
        if self.self_layer:
            hs = node_feat @ self.w_self
            if self.b_self is not None:
                hs = hs + self.b_self
            out = out + hs
        return out
