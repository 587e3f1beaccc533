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
    screen_set: np.ndarray
    screen_begins: np.ndarray
    screen_beta: np.ndarray
    screen_is_active: np.ndarray
    lmda: float
    lmda_max: float
    X_means: torch.Tensor
    y_mean: float
    y_var: float
    rsq: float
    resid: torch.Tensor
    resid_sum: float
    grad: torch.Tensor
    abs_grad: np.ndarray


def state_from_numpy(d, device=None) -> WarmStart:
    """A warm start from a dict of numpy arrays with the keys
    ``screen_set, screen_begins, screen_beta, screen_is_active, lmda,
    lmda_max, X_means, y_mean, y_var, rsq, resid, resid_sum, grad,
    abs_grad``.  ``X_means``, ``resid`` and ``grad`` go to ``device``
    (resolved as in ``grpnet``) in the dtype of ``screen_beta``."""
    device = resolve_device(device)
    dtype = np.asarray(d["screen_beta"]).dtype
    if dtype not in (np.float32, np.float64):
        dtype = np.dtype(np.float64)

    def dev(k):
        return torch.as_tensor(np.array(d[k], dtype), device=device)

    return WarmStart(
        screen_set=np.asarray(d["screen_set"], int),
        screen_begins=np.asarray(d["screen_begins"], int),
        screen_beta=np.asarray(d["screen_beta"], dtype),
        screen_is_active=np.asarray(d["screen_is_active"], bool),
        lmda=float(d["lmda"]),
        lmda_max=float(d["lmda_max"]),
        X_means=dev("X_means"),
        y_mean=float(d["y_mean"]),
        y_var=float(d["y_var"]),
        rsq=float(d["rsq"]),
        resid=dev("resid"),
        resid_sum=float(d["resid_sum"]),
        grad=dev("grad"),
        abs_grad=np.asarray(d["abs_grad"], np.float64),
    )
