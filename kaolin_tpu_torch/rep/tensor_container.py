"""Tensor container base.

Counterpart of ``kaolin_tpu/rep/tensor_container.py`` (reference
``kaolin/rep/tensor_container.py:27``). There ``.to``, ``.cuda`` and
``.cpu`` are no-ops, since JAX places arrays itself; PyTorch placement is
explicit, so here they move every tensor attribute and cast the floating
ones, as the reference does.
"""

import torch

__all__ = ["TensorContainerBase"]


class TensorContainerBase:
    """Base for containers bundling named tensors. Subclasses declare
    ``class_tensor_attributes`` / ``class_other_attributes``."""

    @classmethod
    def class_tensor_attributes(cls):
        return []

    @classmethod
    def class_other_attributes(cls):
        return []

    def get_attributes(self, only_tensors=False):
        names = (self.class_tensor_attributes() if only_tensors else
                 self.class_tensor_attributes() + self.class_other_attributes())
        return [n for n in names if getattr(self, n, None) is not None]

    def float_tensors_to(self, dtype):
        """Cast the floating tensor attributes to ``dtype`` in place →
        self."""
        for a in self.class_tensor_attributes():
            v = getattr(self, a, None)
            if v is not None and v.is_floating_point():
                setattr(self, a, v.to(dtype))
        return self

    def to(self, device=None, dtype=None):
        """Move every tensor attribute to ``device`` and cast the floating
        ones to ``dtype`` (either may be None), in place → self."""
        for a in self.class_tensor_attributes():
            v = getattr(self, a, None)
            if v is None:
                continue
            v = v.to(device) if device is not None else v
            if dtype is not None and v.is_floating_point():
                v = v.to(dtype)
            setattr(self, a, v)
        return self

    def cuda(self, device=None):
        return self.to(torch.device("cuda") if device is None else device)

    def cpu(self):
        return self.to("cpu")
