"""GLM loss classes: gaussian, binomial (logit and probit), poisson, cox,
and the multi-response multigaussian and multinomial (``glm/multi.py``).

Counterpart of ``adelie_tpu/glm/__init__.py:40-332``.  Each class provides
plain tensor methods (reference ``glm_base.hpp:19-93``):

* ``gradient(eta)``: the NEGATIVE loss gradient in eta, weights folded in
  (the weighted "residual");
* ``hessian(eta, grad)``: the diagonal Hessian (an upper bound);
* ``inv_hessian_gradient(eta, grad, hess)``: ``grad / max(hess, floor)``
  with the dtype's floor (``configs.hessian_min``, ``hessian_min_f32``);
* ``loss(eta)``, ``loss_full()`` (the saturated loss, a 0-d tensor) and
  ``inv_link(eta)``.

``y`` and the weights are kept as CPU tensors of the GLM's dtype; weights
are normalised to sum to one at construction (reference glm.py factories).
The solver takes a copy on its device and in its dtype (``to``).  Users
can define a GLM by subclassing ``GlmBase`` (alias ``glm_base``), or a
multi-response one, whose ``y`` and ``eta`` are (n, K), by subclassing
``GlmMultiBase`` (alias ``multiglm_base``).
"""

import copy

import numpy as np
import torch

from ..configs import configs
from ..utils import TORCH_DTYPE, types

__all__ = ["GlmBase", "GlmMultiBase", "glm_base", "multiglm_base",
           "gaussian", "binomial", "poisson", "cox", "multigaussian",
           "multinomial"]


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


def hessian_min(dtype):
    """The Hessian floor of the numpy ``dtype``."""
    if np.dtype(dtype) == np.float64:
        return configs.hessian_min
    return configs.hessian_min_f32


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

    def to(self, device, dtype=None):
        """A copy whose tensors live on ``device``, floating ones in
        ``dtype`` (a numpy dtype; default the GLM's)."""
        dtype = self.dtype if dtype is None else np.dtype(dtype)
        tdtype = TORCH_DTYPE[dtype]
        out = copy.copy(self)
        for key, val in vars(self).items():
            if isinstance(val, torch.Tensor):
                setattr(out, key, val.to(
                    device=device,
                    dtype=tdtype if val.is_floating_point() else None))
        out.dtype, out.torch_dtype = dtype, tdtype
        return out

    # -- overridables ------------------------------------------------------
    def gradient(self, eta):
        raise NotImplementedError

    def hessian(self, eta, grad):
        raise NotImplementedError

    def inv_hessian_gradient(self, eta, grad, hess):
        hmin = hessian_min(self.dtype)
        floor = hmin * (hess <= 0).to(hess.dtype)
        return grad / (torch.clamp(hess, min=0.0) + floor)

    def loss(self, eta):
        raise NotImplementedError

    def loss_full(self):
        raise NotImplementedError

    def inv_link(self, eta):
        raise NotImplementedError

    def reweight(self, weights):
        return type(self)(self.y.cpu().numpy(), np.asarray(weights))


class GlmMultiBase(GlmBase):
    """Multi-response GLM base (reference glm_multibase.hpp): ``y`` is
    (n, K), and so are eta, the gradient and the Hessian; the weights are
    (n,), one an observation."""

    is_multi = True

    def __init__(self, name, y, weights=None, dtype=None):
        if np.ndim(y) != 2:
            raise ValueError(f"y must be (n, K), got shape {np.shape(y)}")
        super().__init__(name, y, weights, dtype)


# the reference's names of the user-extension bases (reference glm.py:33,
# 58)
glm_base = GlmBase
multiglm_base = GlmMultiBase


class GlmGaussian(GlmBase):
    """Weighted least squares: loss(eta) = sum_i w_i (-y_i eta_i + eta_i^2/2)."""

    opt = True

    def __init__(self, y, weights=None, dtype=None, opt: bool = True):
        super().__init__("gaussian", y, weights, dtype)
        self.opt = opt

    def gradient(self, eta):
        return self.weights * (self.y - eta)

    def hessian(self, eta, grad):
        return self.weights

    def loss(self, eta):
        return torch.sum(self.weights * (-self.y * eta + 0.5 * eta**2))

    def loss_full(self):
        return -0.5 * torch.sum(self.weights * self.y**2)

    def inv_link(self, eta):
        return eta

    def reweight(self, weights):
        return GlmGaussian(self.y.cpu().numpy(), np.asarray(weights),
                           opt=self.opt)


def _xlogx_binomial(y):
    """sum terms y log y + (1 - y) log(1 - y), 0 log 0 = 0."""
    one = torch.ones((), dtype=y.dtype, device=y.device)
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    term = torch.where(y > 0, y * torch.log(torch.where(y > 0, y, one)), zero)
    return term + torch.where(
        y < 1, (1 - y) * torch.log(torch.where(y < 1, 1 - y, one)), zero)


class GlmBinomialLogit(GlmBase):
    """Bernoulli NLL, logit link (reference glm/glm_binomial.ipp)."""

    def __init__(self, y, weights=None, dtype=None):
        super().__init__("binomial_logit", y, weights, dtype)

    def gradient(self, eta):
        return self.weights * (self.y - torch.sigmoid(eta))

    def hessian(self, eta, grad):
        wp = self.weights * self.y - grad  # W * mu
        denom = self.weights + (self.weights <= 0)
        return wp * (self.weights - wp) / denom

    def loss(self, eta):
        # the numerically stable logistic loss (glm_binomial.ipp loss)
        return torch.sum(
            self.weights
            * (((eta > 0).to(eta.dtype) - self.y) * eta
               + torch.log1p(torch.exp(-torch.abs(eta))))
        )

    def loss_full(self):
        return -torch.sum(self.weights * _xlogx_binomial(self.y))

    def inv_link(self, eta):
        return torch.sigmoid(eta)


class GlmBinomialProbit(GlmBase):
    """Bernoulli NLL, probit link (reference glm/glm_binomial.ipp)."""

    def __init__(self, y, weights=None, dtype=None):
        super().__init__("binomial_probit", y, weights, dtype)

    @staticmethod
    def _cdf(x):
        return 0.5 * (1 + torch.special.erf(x / np.sqrt(2.0)))

    @staticmethod
    def _pdf(x):
        return torch.exp(-0.5 * x * x) / np.sqrt(2.0 * np.pi)

    def gradient(self, eta):
        big = float(np.finfo(self.dtype).max)
        Phi = self._cdf(eta)
        return (
            self.weights
            * self._pdf(eta)
            * (
                self.y * torch.clamp(1.0 / Phi, max=big)
                - (1 - self.y) * torch.clamp(1.0 / (1 - Phi), max=big)
            )
        )

    def hessian(self, eta, grad):
        big = float(np.finfo(self.dtype).max)
        Phi = self._cdf(eta)
        pdf2 = self._pdf(eta) ** 2
        return (
            self.weights
            * (
                self.y * torch.clamp(1.0 / Phi**2, max=big)
                + (1 - self.y) * torch.clamp(1.0 / (1 - Phi) ** 2, max=big)
            )
            * pdf2
            + eta * grad
        )

    def loss(self, eta):
        big = float(np.finfo(self.dtype).max)
        Phi = self._cdf(eta)
        return -torch.sum(
            self.weights
            * (
                self.y * torch.clamp(torch.log(Phi), min=-big)
                + (1 - self.y) * torch.clamp(torch.log1p(-Phi), min=-big)
            )
        )

    def loss_full(self):
        return GlmBinomialLogit.loss_full(self)

    def inv_link(self, eta):
        return self._cdf(eta)


class GlmPoisson(GlmBase):
    """Poisson NLL (reference glm/glm_poisson.{hpp,ipp})."""

    def __init__(self, y, weights=None, dtype=None):
        super().__init__("poisson", y, weights, dtype)

    def gradient(self, eta):
        return self.weights * (self.y - torch.exp(eta))

    def hessian(self, eta, grad):
        return self.weights * self.y - grad  # w * exp(eta)

    def loss(self, eta):
        return torch.sum(self.weights * (torch.exp(eta) - self.y * eta))

    def loss_full(self):
        y = self.y
        one = torch.ones((), dtype=y.dtype, device=y.device)
        ylogy = torch.where(y > 0, y * torch.log(torch.where(y > 0, y, one)),
                            torch.zeros((), dtype=y.dtype, device=y.device))
        return torch.sum(self.weights * (y - ylogy))

    def inv_link(self, eta):
        return torch.exp(eta)


# --------------------------------------------------------------------------- #
# factories (reference adelie/glm.py)                                         #
# --------------------------------------------------------------------------- #


def gaussian(y, weights=None, *, dtype=None, opt: bool = True, **kwargs):
    """Gaussian GLM (reference glm.py:379).  ``opt=False`` fits it by
    IRLS, as the other GLMs."""
    return GlmGaussian(y, weights, dtype, opt=opt)


def binomial(y, weights=None, *, link: str = "logit", dtype=None, **kwargs):
    """Binomial GLM with the logit or probit link (reference
    glm.py:83-199)."""
    link = types.binomial_link(link)
    if link == "logit":
        return GlmBinomialLogit(y, weights, dtype)
    return GlmBinomialProbit(y, weights, dtype)


def poisson(y, weights=None, *, dtype=None, **kwargs):
    """Poisson GLM (reference glm.py:631)."""
    return GlmPoisson(y, weights, dtype)


def cox(start=None, stop=None, status=None, strata=None, weights=None, *,
        tie_method: str = "efron", dtype=None, **kwargs):
    """Cox partial likelihood GLM (reference glm.py:199-330).
    ``start=None`` means no left truncation: every subject enters the
    risk set at -inf (plain right-censored survival data)."""
    from ._cox import GlmCox

    if start is None and stop is not None:
        start = np.full(np.asarray(stop).shape, -np.inf)
    return GlmCox(start=start, stop=stop, status=status, strata=strata,
                  weights=weights, tie_method=tie_method, dtype=dtype)


def multigaussian(y, weights=None, *, dtype=None, opt: bool = True,
                  **kwargs):
    """Multi-response gaussian over the K columns of ``y`` (n, K)
    (reference glm.py:456).  ``opt=False`` fits it by IRLS."""
    from .multi import GlmMultiGaussian

    return GlmMultiGaussian(y, weights, dtype, opt=opt)


def multinomial(y, weights=None, *, dtype=None, **kwargs):
    """Multinomial (softmax) GLM over the K >= 2 classes of ``y`` (n, K),
    one-hot (reference glm.py:541)."""
    from .multi import GlmMultinomial

    return GlmMultinomial(y, weights, dtype)
