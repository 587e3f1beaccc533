"""Bounded-variable least squares (reference solver.py:961-1117,
solver_bvls.hpp).

    minimize_b  1/2 ||y - X b||_W^2   s.t.  lower <= b <= upper

Counterpart of ``adelie_tpu/solver/_bvls.py``.  The host drives the
screening rounds: each round adds up to ``kappa`` KKT violators, ranked by
their violation (a stable sort), and stops when none is left or the loss
stops falling.  Each fit gathers the screened columns of any naive matrix
(dense, SNP in device memory) once, forms their weighted Gram with one
product and runs the whole screen / active-set refinement as one call of
``screened_cd_fit`` (K7 on the card).  A KKT round costs one ``X^T W r``.
"""

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import matrix as matrix_mod
from ..configs import configs, matmul_precision
from ..exceptions import SolverError
from ..utils import Stopwatch, bucket
from .screened_cd import padded, screened_cd_fit


@dataclass
class StateBVLS:
    """Result state (reference state/state_bvls.hpp fields)."""

    X: Any = None
    y_var: float = 0.0
    X_vars: np.ndarray = None
    lower: np.ndarray = None
    upper: np.ndarray = None
    weights: np.ndarray = None
    kappa: int = 0
    max_iters: int = 0
    tol: float = 0.0
    screen_set: np.ndarray = None
    is_screen: np.ndarray = None
    active_set: np.ndarray = None
    is_active: np.ndarray = None
    beta: np.ndarray = None
    resid: np.ndarray = None
    grad: np.ndarray = None
    loss: float = 0.0
    iters: int = 0
    n_kkt: int = 0
    benchmark_fit: list = field(default_factory=list)
    benchmark_kkt: list = field(default_factory=list)
    total_time: float = 0.0

    @property
    def screen_set_size(self):
        return len(self.screen_set)

    @property
    def active_set_size(self):
        return len(self.active_set)


def bvls(
    X,
    y,
    lower,
    upper,
    *,
    weights=None,
    kappa: int = None,
    max_iters: int = int(1e5),
    tol: float = 1e-7,
    n_threads: int = 1,
    warm_start=None,
    dtype=None,
    device=None,
):
    """Solve BVLS (reference solver.py:961).  Returns :class:`StateBVLS`.

    ``X`` a naive matrix of the port or an (n, p) array, which becomes a
    dense matrix on ``device`` (default ``"cuda"``; ``device="cpu"`` for
    the CPU).  ``n_threads`` is accepted for the JAX package's signature
    and ignored."""
    sw = Stopwatch().start()
    if not isinstance(X, matrix_mod.MatrixNaiveBase):
        X = matrix_mod.dense(np.asarray(X), dtype=dtype, device=device)
    dtype = np.dtype(X.dtype)
    like = dict(dtype=X.torch_dtype, device=X.device)
    n, p = X.rows(), X.cols()

    y = np.asarray(y, dtype)
    if weights is None:
        weights = np.full(n, 1.0 / n, dtype)
    else:
        weights = np.asarray(weights, dtype)
    if kappa is None:
        kappa = min(n, p)
    kappa = int(kappa)

    lower = np.maximum(np.asarray(lower, dtype), -configs.max_solver_value)
    upper = np.minimum(np.asarray(upper, dtype), configs.max_solver_value)

    w_dev = torch.as_tensor(weights, **like)
    y_var = float(np.sum(y * y * weights))

    if warm_start is None:
        beta = np.where(np.abs(lower) < np.abs(upper), lower, upper) \
            .astype(dtype)
        screen_idx = []
        is_screen = np.zeros(p, bool)
        is_active_full = np.zeros(p, bool)
    else:
        beta = np.asarray(warm_start.beta, dtype).copy()
        screen_idx = list(np.asarray(warm_start.active_set, int))
        is_screen = np.zeros(p, bool)
        is_screen[screen_idx] = True
        is_active_full = np.asarray(warm_start.is_active, bool).copy()

    X_vars_dev = X.sq_mul(w_dev)
    X_vars = X_vars_dev.cpu().numpy()

    with matmul_precision():
        resid = torch.as_tensor(y, **like) - X.tmul(beta)
        loss = float((w_dev @ (resid * resid)) * 0.5)

    iters = 0
    n_kkt = 0
    tol_scale = tol * y_var

    state = StateBVLS(
        X=X, y_var=y_var, X_vars=X_vars, lower=lower, upper=upper,
        weights=weights, kappa=kappa, max_iters=max_iters, tol=tol,
    )

    while True:
        loss_prev = loss

        # ---- fit over the current screen set (one K7 call) ---- #
        if screen_idx:
            sw_fit = Stopwatch().start()
            cols = np.asarray(screen_idx, np.int64)
            S_val = len(cols)
            S_cap = bucket(S_val, configs.screen_cap_min)
            cols_dev = torch.as_tensor(cols, device=X.device)

            Xs = torch.zeros((n, S_cap), **like)
            Xs[:, :S_val] = X.gather(cols_dev)
            with matmul_precision():
                # the Gram's transpose, so that its column i, which the
                # update of slot i reads, is contiguous
                Q = ((Xs * w_dev[:, None]).T @ Xs).T
                grad_s = (w_dev * resid) @ Xs
            diag = padded(X_vars_dev[cols_dev], S_cap, like)
            lo = padded(lower[cols], S_cap, like)
            hi = padded(upper[cols], S_cap, like)
            b0 = padded(beta[cols], S_cap, like)
            valid = torch.arange(S_cap, device=X.device) < S_val
            act0 = padded(is_active_full[cols], S_cap,
                           dict(dtype=torch.bool, device=X.device), False)

            beta_s, _, act_s, loss, iters, done = screened_cd_fit(
                Q, diag, b0, grad_s, lo, hi, valid, act0, loss, tol_scale,
                max_iters, iters, mode="box")
            if not done:
                raise SolverError("bvls: max iterations reached!")
            with matmul_precision():
                resid = resid - Xs @ (beta_s - b0)
            beta[cols] = beta_s[:S_val].cpu().numpy()
            is_active_full[cols] = act_s[:S_val].cpu().numpy()
            state.benchmark_fit.append(sw_fit.elapsed())

        # ---- convergence on a loss plateau (solver_bvls.hpp solve) ---- #
        if n_kkt > 0 and abs(loss - loss_prev) < 1e-6 * abs(y_var):
            break

        # ---- KKT screening round ---- #
        sw_kkt = Stopwatch().start()
        grad_full = X.mul(resid, w_dev).cpu().numpy()
        n_kkt += 1
        viols = (
            np.maximum(grad_full, 0) * (beta < upper)
            - np.minimum(grad_full, 0) * (beta > lower)
        )
        viols[is_screen] = 0.0
        order = np.argsort(-viols, kind="stable")
        new = [int(k) for k in order[:kappa] if viols[k] > 0]
        state.benchmark_kkt.append(sw_kkt.elapsed())
        if not new:
            break
        for k in new:
            is_screen[k] = True
        screen_idx.extend(new)

    state.screen_set = np.asarray(screen_idx, int)
    state.is_screen = is_screen
    state.active_set = np.nonzero(is_active_full)[0]
    state.is_active = is_active_full
    state.beta = beta
    state.resid = resid.cpu().numpy()
    state.grad = X.mul(resid, w_dev).cpu().numpy()
    state.loss = loss
    state.iters = iters
    state.n_kkt = n_kkt
    state.total_time = sw.elapsed()
    return state
