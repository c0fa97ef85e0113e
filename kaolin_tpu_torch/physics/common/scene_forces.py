"""Scene potential-energy forces: gravity, floor, boundary pins, in PyTorch.

Counterpart of ``kaolin_tpu/physics/common/scene_forces.py``. Each force
exposes ``energy(dx, x0, coeff)``, ``gradient`` → (N, 3) and ``hessian`` →
(N, 3, 3) over all quadrature points. The energies also take a batch of
displacements (..., N, 3) and return (...), as the line search evaluates
its candidate steps in one batch.
"""

import torch

__all__ = [
    "gravity_energy", "gravity_gradient",
    "floor_energy", "floor_gradient", "floor_hessian",
    "boundary_energy", "boundary_gradient", "boundary_hessian",
    "Gravity", "Floor", "Boundary",
]


# gravity: E = m g·x
def gravity_energy(g, rho, vol, dx, x0):
    return torch.sum((dx + x0) @ g * rho * vol, dim=-1)


def gravity_gradient(g, rho, vol, dx, x0):
    return (rho * vol)[:, None] * g[None, :]


# floor: a one-sided quadratic penalty along an axis
def _floor_pen(floor_height, floor_axis, flip_floor, dx, x0):
    pen = (dx + x0)[..., floor_axis] - floor_height
    return pen, (pen > 0) if flip_floor else (pen < 0)


def floor_energy(floor_height, floor_axis, flip_floor, vol, dx, x0):
    pen, active = _floor_pen(floor_height, floor_axis, flip_floor, dx, x0)
    return torch.sum(torch.where(active, vol * pen ** 2, 0.0), dim=-1)


def floor_gradient(floor_height, floor_axis, flip_floor, vol, dx, x0):
    pen, active = _floor_pen(floor_height, floor_axis, flip_floor, dx, x0)
    sign = -1.0 if flip_floor else 1.0
    out = torch.zeros_like(dx)
    out[:, floor_axis] = torch.where(active, sign * vol * 2.0 * pen, 0.0)
    return out


def floor_hessian(floor_height, floor_axis, flip_floor, vol, dx, x0):
    _, active = _floor_pen(floor_height, floor_axis, flip_floor, dx, x0)
    sign = -1.0 if flip_floor else 1.0
    out = dx.new_zeros(dx.shape[:1] + (3, 3))
    out[:, floor_axis, floor_axis] = torch.where(active, sign * vol * 2.0,
                                                 0.0)
    return out


# boundary pins: a quadratic pull to the pinned positions
def boundary_energy(pin_pos, pin_mask, dx, x0):
    d = dx + x0 - pin_pos
    return torch.sum(pin_mask * torch.sum(d * d, dim=-1), dim=-1)


def boundary_gradient(pin_pos, pin_mask, dx, x0):
    return (2.0 * (dx + x0 - pin_pos)) * pin_mask[:, None]


def boundary_hessian(pin_pos, pin_mask, dx, x0):
    eye = torch.eye(3, dtype=dx.dtype, device=dx.device)
    return 2.0 * pin_mask[:, None, None] * eye


class Gravity:
    """Gravity over all quadrature points: acceleration ``g`` (3,), per-point
    densities and volumes."""

    def __init__(self, g, integration_pt_density, integration_pt_volume):
        self.g = torch.as_tensor(g, dtype=integration_pt_volume.dtype,
                                 device=integration_pt_volume.device)
        self.rho = integration_pt_density.reshape(-1)
        self.vol = integration_pt_volume.reshape(-1)

    def energy(self, dx, x0, coeff=1.0):
        return coeff * gravity_energy(self.g, self.rho, self.vol, dx, x0)

    def gradient(self, dx, x0, coeff=1.0):
        return coeff * gravity_gradient(self.g, self.rho, self.vol, dx,
                                        x0).expand(dx.shape)

    def hessian(self, dx, x0, coeff=1.0):
        return dx.new_zeros(dx.shape[:1] + (3, 3))


class Floor:
    """One-sided floor penalty at ``floor_height`` along ``floor_axis``
    (above it when ``flip_floor``)."""

    def __init__(self, floor_height, floor_axis, flip_floor,
                 integration_pt_volume):
        self.floor_height = float(floor_height)
        self.floor_axis = int(floor_axis)
        self.flip_floor = bool(flip_floor)
        self.vol = integration_pt_volume.reshape(-1)

    def _args(self):
        return self.floor_height, self.floor_axis, self.flip_floor, self.vol

    def energy(self, dx, x0, coeff=1.0):
        return coeff * floor_energy(*self._args(), dx, x0)

    def gradient(self, dx, x0, coeff=1.0):
        return coeff * floor_gradient(*self._args(), dx, x0)

    def hessian(self, dx, x0, coeff=1.0):
        return coeff * floor_hessian(*self._args(), dx, x0)


class Boundary:
    """Pins selected points to fixed positions. A dense per-point {0, 1}
    mask and per-point targets (0 where unpinned) keep the shapes fixed."""

    def __init__(self, integration_pt_volume):
        n = integration_pt_volume.reshape(-1).shape[0]
        self.pin_mask = integration_pt_volume.new_zeros((n,))
        self.pin_pos = integration_pt_volume.new_zeros((n, 3))

    def set_pinned(self, indices, pinned_x):
        """indices (K,) int, pinned_x (K, 3)."""
        indices = torch.as_tensor(indices, device=self.pin_mask.device)
        self.pin_mask = self.pin_mask.index_fill(0, indices, 1.0)
        self.pin_pos = self.pin_pos.index_put(
            (indices,), torch.as_tensor(pinned_x, dtype=self.pin_pos.dtype,
                                        device=self.pin_pos.device))
        return self

    def energy(self, dx, x0, coeff=1.0):
        return coeff * boundary_energy(self.pin_pos, self.pin_mask, dx, x0)

    def gradient(self, dx, x0, coeff=1.0):
        return coeff * boundary_gradient(self.pin_pos, self.pin_mask, dx, x0)

    def hessian(self, dx, x0, coeff=1.0):
        return coeff * boundary_hessian(self.pin_pos, self.pin_mask, dx, x0)
