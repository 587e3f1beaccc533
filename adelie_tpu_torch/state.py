"""Warm-start state carried into ``grpnet(..., warm_start=...)``.

The system has no weights: what a fit carries across calls is the state
``grpnet`` accepts as ``warm_start``.  ``state_from_numpy`` builds it from
plain numpy arrays, for example those of a state of the JAX package
(``np.asarray`` of each field), so the port never imports that package.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .device import resolve_device

__all__ = ["WarmStart", "state_from_numpy"]


@dataclass
class WarmStart:
    """The fields a fit carries over.  Every fit: the screen set and its
    coefficients, ``lmda``, ``lmda_max``, ``resid``, ``grad`` and
    ``abs_grad``.  The gaussian path also ``X_means``, ``y_mean``,
    ``y_var``, ``rsq`` and ``resid_sum``; a GLM's IRLS path ``eta``,
    ``beta0``, ``loss_null`` and ``loss_full``.  A multi-response fit's
    fields are those of its flattened problem on ``X (x) I_K``: the
    residual, gradient and eta of length n K and p K, the screen over the
    flattened groups, whose first K coefficients are the per-class
    intercepts; it has no ``y_mean`` or ``beta0``."""

    screen_set: np.ndarray
    screen_begins: np.ndarray
    screen_beta: np.ndarray
    screen_is_active: np.ndarray
    lmda: float
    lmda_max: float
    resid: torch.Tensor
    grad: torch.Tensor
    abs_grad: np.ndarray
    X_means: torch.Tensor = None
    y_mean: float = None
    y_var: float = None
    rsq: float = None
    resid_sum: float = None
    eta: torch.Tensor = None
    beta0: float = None
    loss_null: float = None
    loss_full: float = None


_VECTORS = ("resid", "grad", "X_means", "eta")
_SCALARS = ("lmda", "lmda_max", "y_mean", "y_var", "rsq", "resid_sum",
            "beta0", "loss_null", "loss_full")


def state_from_numpy(d, device=None) -> WarmStart:
    """A warm start from a dict of numpy arrays with the keys
    ``screen_set, screen_begins, screen_beta, screen_is_active, lmda,
    lmda_max, resid, grad, abs_grad`` and either the gaussian path's
    ``X_means, y_mean, y_var, rsq, resid_sum`` or a GLM's ``eta, beta0,
    loss_null, loss_full``.  The vectors (``X_means``, ``resid``, ``grad``,
    ``eta``) go to ``device`` (resolved as in ``grpnet``) in the dtype of
    ``screen_beta``."""
    device = resolve_device(device)
    dtype = np.asarray(d["screen_beta"]).dtype
    if dtype not in (np.float32, np.float64):
        dtype = np.dtype(np.float64)
    extra = {}
    for k in _VECTORS:
        if d.get(k) is not None:
            extra[k] = torch.as_tensor(np.array(d[k], dtype), device=device)
    for k in _SCALARS:
        if d.get(k) is not None:
            extra[k] = float(d[k])
    return WarmStart(
        screen_set=np.asarray(d["screen_set"], int),
        screen_begins=np.asarray(d["screen_begins"], int),
        screen_beta=np.asarray(d["screen_beta"], dtype),
        screen_is_active=np.asarray(d["screen_is_active"], bool),
        abs_grad=np.asarray(d["abs_grad"], np.float64),
        **extra,
    )
