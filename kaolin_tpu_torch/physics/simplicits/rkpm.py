"""RKPM skinning weights (NVIDIA's "Freeform" method), for the PyTorch port.

Counterpart of ``kaolin_tpu/physics/simplicits/rkpm.py``: skinning weights
are the eigenvectors of a generalized eigenproblem over mass and elastic
Hessian matrices assembled from a first-order reproducing-kernel particle
method (RKPM) basis,
``phi(x) = (C(x) @ P(nodes)ᵀ) * rbf(x)``, where C solves each point's
moment system. As in the JAX package the basis is built and evaluated on the
host in float64 numpy (``scipy.linalg.eigh``; the matrices are dense,
num_nodes²), with gradients by implicit differentiation of the moment solve.
The nodes come from :func:`kaolin_tpu_torch.ops.pointcloud.
farthest_point_sampling` on the points' device, and the weights and their
gradients are handed back as float32 tensors on the points' device.
"""

import logging

import numpy as np
import torch

from kaolin_tpu_torch.ops.pointcloud import farthest_point_sampling

logger = logging.getLogger(__name__)

__all__ = ["RKPM", "SimplicitsRKPM"]


def _numpy(x):
    """``x`` (a tensor, an array or a list) as a numpy array of its own
    dtype."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host(x):
    """``x`` as a float64 numpy array."""
    return _numpy(x).astype(np.float64)


def _rbf(x, nodes, radius):
    """exp(−(|x − n| / r)²) → (n, N)."""
    d2 = ((x[:, None, :] - nodes[None]) ** 2).sum(-1)
    return np.exp(-d2 / radius[None] ** 2)


def _poly(x):
    return np.concatenate([np.ones_like(x[:, :1]), x], axis=1)


class RKPM:
    """First-order corrected RKPM basis."""

    def __init__(self, num_nodes, polynomial_degree=1):
        if polynomial_degree != 1:
            raise ValueError("only degree 1 is supported")
        self.num_nodes = num_nodes
        self.num_dims = 3
        self.P = 4
        self.nodes = None
        self.radius = None

    def set_kernels(self, nodes, radius):
        self.nodes = _host(nodes)
        self.radius = _host(radius)
        self.num_nodes = self.nodes.shape[0]

    def func_x(self, x):
        return _rbf(_host(x), self.nodes, self.radius)

    def dfunc_dx(self, x):
        x = _host(x)
        disp = x[:, None, :] - self.nodes[None]
        f = self.func_x(x)
        return f[..., None] * (-2.0 / self.radius[None, :, None] ** 2) * disp

    def _moments(self, x, f):
        """The nodes' outer products P Pᵀ (N, P, P), the moment matrices
        M(x) (n, P, P) and the correction C(x) (n, P)."""
        pn = _poly(self.nodes)
        pn_outer = np.einsum("Ni,Nj->Nij", pn, pn)
        mx = np.einsum("nN,Nij->nij", f, pn_outer)
        cx = np.linalg.solve(mx, _poly(x)[..., None])[..., 0]
        return pn, pn_outer, mx, cx

    def phi(self, x):
        """Corrected shape functions (n, N)."""
        x = _host(x)
        f = self.func_x(x)
        pn, _, _, cx = self._moments(x, f)
        return (cx @ pn.T) * f

    def grad_phi(self, x):
        """d phi / dx (n, N, 3), by implicit differentiation of the moment
        solve."""
        x = _host(x)
        f = self.func_x(x)
        df = self.dfunc_dx(x)
        pn, pn_outer, mx, cx = self._moments(x, f)
        dpx = np.zeros((x.shape[0], self.P, 3))        # dP(x)/dx = [0; I]
        dpx[:, 1:, :] = np.eye(3)[None]
        dmx = np.einsum("nNd,Nij->nijd", df, pn_outer)   # (n, P, P, 3)
        rhs = dpx - np.einsum("nijd,nj->nid", dmx, cx)   # (n, P, 3)
        mx3 = np.broadcast_to(mx[:, None], (x.shape[0], 3) + mx.shape[1:])
        dcx = np.linalg.solve(mx3, np.moveaxis(rhs, -1, 1)[..., None])[..., 0]
        dcx = np.moveaxis(dcx, 1, -1)                    # (n, P, 3)
        term1 = np.einsum("npd,Np->nNd", dcx, pn) * f[..., None]
        term2 = (cx @ pn.T)[..., None] * df
        return term1 + term2

    def __call__(self, x, evecs):
        return self.phi(x) @ _host(evecs)


class SimplicitsRKPM:
    """An RKPM skinning-weight field with the skinning module's methods:
    ``__call__`` (the learned handles at normalized points),
    ``compute_skinning_weights`` and ``compute_dwdx`` (at raw points, with
    the constant handle)."""

    def __init__(self, num_handles, num_nodes, radius_scale=1.0,
                 radius_init_kNN=2, radius_min="3x", num_points=None,
                 dtype=np.float64, bb_min=None, bb_max=None):
        self.num_points = num_points
        self.num_handles = num_handles - 1   # the constant handle comes apart
        self.num_nodes = num_nodes
        self.radius_scale = radius_scale
        self.radius_init_kNN = radius_init_kNN
        self.radius_min = radius_min
        self.rkpm = RKPM(num_nodes)
        self.evecs = np.zeros((num_nodes, self.num_handles))
        self.bb_min = np.zeros(3) if bb_min is None else _numpy(bb_min)
        self.bb_max = np.ones(3) if bb_max is None else _numpy(bb_max)

    def _offset_scale(self, pts):
        """Points normalized to the box, in the points' and the box's
        precision (float32 for float32 points and box)."""
        return (_numpy(pts) - self.bb_min) / (self.bb_max - self.bb_min)

    @staticmethod
    def _fps(pts, k, device):
        """FPS of the float64 points ``pts`` in float32 on ``device`` →
        numpy indices."""
        t = torch.as_tensor(pts.astype(np.float32), device=device)
        return farthest_point_sampling(t[None], k)[0].cpu().numpy()

    def init(self, pts, yms, prs, rhos, appx_vol):
        """FPS nodes, their radii, and the generalized eigenanalysis.
        ``pts`` may be a tensor (FPS runs on its device) or an array (on
        the CUDA device)."""
        from scipy.linalg import eigh
        from scipy.spatial import cKDTree

        device = pts.device if torch.is_tensor(pts) else torch.device("cuda")
        pts = self._offset_scale(pts).astype(np.float64)
        yms = _host(yms).reshape(-1)
        prs = _host(prs).reshape(-1)

        if pts.shape[0] < self.num_nodes:
            logger.warning("num_nodes > num_points; using all points")
            self.num_nodes = pts.shape[0]
            node_idx = np.arange(pts.shape[0])
        else:
            node_idx = self._fps(pts, self.num_nodes, device)
        nodes = pts[node_idx]

        dists, _ = cKDTree(nodes).query(nodes, k=self.radius_init_kNN + 1)
        radius = dists[:, -1] * self.radius_scale
        if isinstance(self.radius_min, float):
            radius = np.clip(radius, self.radius_min, None)
        elif isinstance(self.radius_min, str):
            if not self.radius_min.endswith("x"):
                raise ValueError(f"radius_min {self.radius_min!r} is not "
                                 "a float nor '<factor>x'")
            factor = float(self.radius_min[:-1])
            pd, _ = cKDTree(pts).query(pts, k=2)
            radius = np.clip(radius, pd[:, -1].mean() * factor, None)
        self.rkpm.set_kernels(nodes, radius)

        if self.num_points is None:
            sample_idx = np.arange(pts.shape[0])
        else:
            sample_idx = self._fps(pts, self.num_points, device)
        x = pts[sample_idx]
        m = self.get_mass_matrix(x)
        h = self.get_hessian_matrix(x, yms[sample_idx], prs[sample_idx])
        # the smallest num_handles + 1 generalized eigenpairs, without the
        # zero mode
        reg = 1e-10 * np.eye(m.shape[0])
        _, evecs = eigh(h, m + reg, subset_by_index=[0, self.num_handles])
        self.evecs = evecs[:, 1:]
        return self

    def get_mass_matrix(self, x):
        """M = ΦᵀΦ."""
        phi = self.rkpm.phi(x)
        return phi.T @ phi

    def get_hessian_matrix(self, x, yms, prs, reparameterize_lame=True):
        """Stiffness from the basis gradients scaled by λ + 4μ (λ + 3μ
        without ``reparameterize_lame``)."""
        gp = self.rkpm.grad_phi(x)                       # (n, N, 3)
        n, nn, d = gp.shape
        j = np.transpose(gp, (0, 2, 1)).reshape(n * d, nn)
        yms, prs = _host(yms), _host(prs)
        mus = yms / (2 * (1 + prs))
        lams = yms * prs / ((1 + prs) * (1 - 2 * prs))
        coeff = (lams + 4 * mus) if reparameterize_lame else (lams + 3 * mus)
        per_dim = np.repeat(coeff, d)
        return j.T @ (per_dim[:, None] * j)

    @staticmethod
    def _like(a, pts):
        """``a`` as float32 on the device of ``pts`` (the CPU for an
        array)."""
        device = pts.device if torch.is_tensor(pts) else None
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    def __call__(self, norm_pts):
        """The learned handles at normalized points → (n, H−1)."""
        return self._like(self.rkpm.phi(norm_pts) @ self.evecs, norm_pts)

    def compute_skinning_weights(self, pts):
        w = self.rkpm.phi(self._offset_scale(pts)) @ self.evecs
        return self._like(
            np.concatenate([w, np.ones((w.shape[0], 1))], axis=1), pts)

    def compute_dwdx(self, pts):
        gp = self.rkpm.grad_phi(self._offset_scale(pts))  # (n, N, 3)
        grad = np.einsum("nNd,Nc->ncd", gp, self.evecs)
        grad = grad / (self.bb_max - self.bb_min)[None, None, :]
        zeros = np.zeros((grad.shape[0], 1, 3))
        return self._like(np.concatenate([grad, zeros], axis=1), pts)
