"""Multi-response GLMs: the multigaussian and the multinomial.

Counterpart of ``adelie_tpu/glm/multi.py`` (reference
glm/glm_multigaussian.ipp, glm_multinomial.ipp).  ``y``, ``eta`` and the
gradient and Hessian are (n, K); the per-observation weights are (n,) and
sum to one, and every loss carries a 1/K factor.  ``FlattenedMultiGlm``
shows such a GLM to the single-response drivers as one on the flattened
(n K,) vectors of the problem on ``X (x) I_K`` (``solver/multi.py``).
"""

import numpy as np
import torch

from . import GlmMultiBase

__all__ = ["FlattenedMultiGlm", "GlmMultiGaussian", "GlmMultinomial"]


class GlmMultiGaussian(GlmMultiBase):
    """Least squares over K responses: loss(eta) = sum_i w_i sum_k
    (eta_ik^2 / 2 - y_ik eta_ik) / K."""

    opt = True

    def __init__(self, y, weights=None, dtype=None, opt: bool = True):
        super().__init__("multigaussian", y, weights, dtype)
        self.opt = opt

    def gradient(self, eta):
        K = self.y.shape[1]
        return self.weights[:, None] * (self.y - eta) / K

    def hessian(self, eta, grad):
        K = self.y.shape[1]
        return (self.weights[:, None] / K).expand(self.y.shape)

    def loss(self, eta):
        K = self.y.shape[1]
        return torch.sum(self.weights[:, None]
                         * (0.5 * eta**2 - self.y * eta)) / K

    def loss_full(self):
        K = self.y.shape[1]
        return -0.5 * torch.sum(self.weights[:, None] * self.y**2) / K

    def inv_link(self, eta):
        return eta


class GlmMultinomial(GlmMultiBase):
    """Softmax regression over K classes, ``y`` one-hot (or class
    proportions) (n, K)."""

    def __init__(self, y, weights=None, dtype=None):
        y = np.asarray(y)
        if y.ndim != 2 or y.shape[1] <= 1:
            raise ValueError("y must have at least 2 columns (classes).")
        super().__init__("multinomial", y, weights, dtype)

    def gradient(self, eta):
        K = self.y.shape[1]
        P = torch.softmax(eta, dim=1)
        return self.weights[:, None] * (self.y - P) / K

    def hessian(self, eta, grad):
        """The diagonal upper bound ``2 w P (1 - P)`` / K, from the
        gradient: ``w P / K = w y / K - grad`` (reference
        glm_multinomial.ipp hessian); a zero weight divides by 1."""
        K = self.y.shape[1]
        wP = self.weights[:, None] * self.y / K - grad
        wsafe = (self.weights + (self.weights <= 0).to(self.weights.dtype))
        return 2.0 * wP * (1.0 - K * wP / wsafe[:, None])

    def loss(self, eta):
        K = self.y.shape[1]
        lse = torch.logsumexp(eta, dim=1)
        return torch.sum(
            self.weights * (lse - torch.sum(self.y * eta, dim=1))) / K

    def loss_full(self):
        return torch.zeros((), dtype=self.y.dtype, device=self.y.device)

    def inv_link(self, eta):
        return torch.softmax(eta, dim=1)


class FlattenedMultiGlm:
    """A multi-response GLM on the flattened (n K,) vectors of the problem
    on ``X (x) I_K`` (reference GlmWrap, solver_multiglm_naive.hpp:19-97):
    entry ``i K + k`` is class k of observation i, and the flattened
    weights are ``w_i / K``.  It reshapes to (n, K) and back, so the
    single-response IRLS drivers run it unchanged."""

    is_multi = False

    def __init__(self, mglm):
        self._m = mglm
        self.name = mglm.name
        self.opt = mglm.opt
        self.dtype = mglm.dtype
        self.torch_dtype = mglm.torch_dtype
        self._shape = tuple(mglm.y.shape)
        K = self._shape[1]
        self.y = mglm.y.reshape(-1)
        self.weights = torch.repeat_interleave(mglm.weights / K, K)

    def to(self, device, dtype=None):
        """The same GLM with its tensors on ``device`` (numpy ``dtype``)."""
        return FlattenedMultiGlm(self._m.to(device, dtype))

    def _r(self, v):
        return v.reshape(self._shape)

    def gradient(self, eta):
        return self._m.gradient(self._r(eta)).reshape(-1)

    def hessian(self, eta, grad):
        return self._m.hessian(self._r(eta), self._r(grad)).reshape(-1)

    def inv_hessian_gradient(self, eta, grad, hess):
        return self._m.inv_hessian_gradient(
            self._r(eta), self._r(grad), self._r(hess)).reshape(-1)

    def loss(self, eta):
        return self._m.loss(self._r(eta))

    def loss_full(self):
        return self._m.loss_full()

    def inv_link(self, eta):
        return self._m.inv_link(self._r(eta)).reshape(-1)
