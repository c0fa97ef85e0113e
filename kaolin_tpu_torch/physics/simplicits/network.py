"""Skinning-weight modules of Simplicits, in PyTorch.

Counterpart of ``kaolin_tpu/physics/simplicits/network.py``. A
:class:`SkinningModule` normalizes points to its bounding box, evaluates its
learned handles and appends the constant handle; :class:`SimplicitsMLP` is
the ELU MLP of the reference (``mlp_apply`` there). Weights trained in the
JAX package come across with
:func:`kaolin_tpu_torch.utils.interop.simplicits_mlp_from_jax`.
:func:`mlp_init` and :func:`mlp_apply` are the same MLP as a list of
``{"w": (in, out), "b": (out,)}`` tensors, for callers that differentiate
the parameters themselves (``kaolin_tpu_torch.parallel``).
"""

import torch
from torch import nn

__all__ = ["SimplicitsMLP", "SkinningFn", "SkinningModule", "mlp_init",
           "mlp_apply"]


def mlp_init(generator, spatial_dimensions, layer_width, num_handles,
             num_layers, dtype=torch.float32, device=None):
    """ELU-MLP parameters: Linear(d, w) → ELU → [Linear(w, w) → ELU] ×
    num_layers → Linear(w, H−1), as a list of ``{"w", "b"}`` dicts. Each
    weight, then its bias, is drawn U(−1/√fan_in, 1/√fan_in) from the
    ``torch.Generator`` ``generator``, on ``device`` (the generator's
    device when None)."""
    device = generator.device if device is None else torch.device(device)
    sizes = ([spatial_dimensions] + [layer_width] * (num_layers + 1)
             + [num_handles - 1])
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bound = fan_in ** -0.5
        layer = {}
        for name, shape in (("w", (fan_in, fan_out)), ("b", (fan_out,))):
            x = torch.empty(shape, dtype=dtype, device=generator.device)
            layer[name] = x.uniform_(-bound, bound,
                                     generator=generator).to(device)
        params.append(layer)
    return params


def mlp_apply(params, x):
    """The MLP of :func:`mlp_init` at ``x`` (N, d) → (N, H−1): the learned
    handles only, no constant handle."""
    h = x
    for layer in params[:-1]:
        h = nn.functional.elu(h @ layer["w"] + layer["b"])
    return h @ params[-1]["w"] + params[-1]["b"]


def _box_corner(value, default):
    v = default if value is None else value
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32),
                              (3,)).clone()


class SkinningModule(nn.Module):
    """Skinning weights of points: ``fcn`` gives the learned handles at
    points normalized to the box [bb_min, bb_max] → (N, H−1), and the
    constant handle (weight 1 everywhere) comes last."""

    def __init__(self, fcn=None, bb_min=None, bb_max=None):
        super().__init__()
        self.fcn = fcn
        self.register_buffer("bb_min", _box_corner(bb_min, 0.0))
        self.register_buffer("bb_max", _box_corner(bb_max, 1.0))

    @staticmethod
    def from_function(function, bb_min=0.0, bb_max=1.0):
        """Wrap an analytic weight function of normalized points."""
        return SkinningModule(fcn=function, bb_min=bb_min, bb_max=bb_max)

    def _offset_scale(self, pts):
        return (pts - self.bb_min) / (self.bb_max - self.bb_min)

    def forward(self, pts):
        """Learned handles at normalized pts (N, d) → (N, H−1)."""
        return self.fcn(pts)

    def compute_skinning_weights(self, pts):
        """Weights at raw pts with the constant handle → (N, H)."""
        w = self(self._offset_scale(pts))
        return torch.cat([w, w.new_ones((pts.shape[0], 1))], dim=1)

    def compute_dwdx(self, pts):
        """Spatial Jacobian of the weights → (N, H, 3), exact through
        ``torch.func.jacrev``."""
        jac_single = torch.func.jacrev(
            lambda p: self.compute_skinning_weights(p[None])[0])
        return torch.func.vmap(jac_single)(pts)


# the JAX package's name for the functional form of the module
SkinningFn = SkinningModule


class SimplicitsMLP(SkinningModule):
    """The reference architecture: Linear(d, w) → ELU → [Linear(w, w) →
    ELU] × num_layers → Linear(w, H−1). Its weights and biases are drawn
    U(−1/√fan_in, 1/√fan_in), torch's default for ``nn.Linear``, from
    ``key``: a ``torch.Generator`` (the module is made on its device) or an
    int seed of a CPU generator (0 when None)."""

    def __init__(self, spatial_dimensions, layer_width, num_handles,
                 num_layers, bb_min=None, bb_max=None, key=None):
        super().__init__(bb_min=bb_min, bb_max=bb_max)
        sizes = ([spatial_dimensions] + [layer_width] * (num_layers + 1)
                 + [num_handles - 1])
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator().manual_seed(0 if key is None else int(key))
        # nn.Linear draws its own initialization from the global generator:
        # keep that one as it was, then draw from ``gen``
        with torch.random.fork_rng(devices=[]):
            self.layers = nn.ModuleList(
                nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.to(gen.device)
        with torch.no_grad():
            for layer in self.layers:
                bound = layer.in_features ** -0.5
                layer.weight.uniform_(-bound, bound, generator=gen)
                layer.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, pts):
        h = pts
        for layer in self.layers[:-1]:
            h = nn.functional.elu(layer(h))
        return self.layers[-1](h)
