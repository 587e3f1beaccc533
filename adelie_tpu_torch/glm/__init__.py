"""GLM loss classes: the gaussian one so far.

Counterpart of ``adelie_tpu/glm/__init__.py:40-147``.  ``y`` and the
weights are kept as CPU tensors of the GLM's dtype; weights are normalised
to sum to one at construction (reference glm.py factories).  The solver
moves them to its device.  The gaussian path needs no loss, gradient or
Hessian methods (it solves in closed-form covariance updates); they come
with the other GLMs in ROADMAP.md queue 5.
"""

import numpy as np
import torch

from ..utils import TORCH_DTYPE

__all__ = ["GlmBase", "GlmGaussian", "gaussian"]

def _normalize_weights(n, weights, dtype):
    if weights is None:
        w = np.full(n, 1.0 / n)
    else:
        w = np.asarray(weights, dtype=np.float64)
        s = w.sum()
        if s <= 0:
            raise ValueError("weights must have positive sum")
        w = w / s
    return torch.as_tensor(w.astype(dtype))


class GlmBase:
    """Single-response GLM base (reference glm_base.hpp:19-93)."""

    is_multi = False
    opt = False

    def __init__(self, name, y, weights=None, dtype=None):
        self.name = name
        y = np.asarray(y)
        if dtype is None:
            dtype = y.dtype if y.dtype in (np.float32, np.float64) else np.float64
        self.dtype = np.dtype(dtype)
        self.torch_dtype = TORCH_DTYPE[self.dtype]
        self.y = torch.as_tensor(y.astype(self.dtype))
        self.weights = _normalize_weights(self.y.shape[0], weights, self.dtype)


class GlmGaussian(GlmBase):
    """Weighted least squares: loss(eta) = sum_i w_i (-y_i eta_i + eta_i^2/2)."""

    opt = True

    def __init__(self, y, weights=None, dtype=None, opt: bool = True):
        super().__init__("gaussian", y, weights, dtype)
        self.opt = opt


def gaussian(y, weights=None, *, dtype=None, opt: bool = True, **kwargs):
    """Gaussian GLM (reference glm.py:379)."""
    return GlmGaussian(y, weights, dtype, opt=opt)
