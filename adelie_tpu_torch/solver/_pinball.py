"""Pinball (asymmetric-penalty) least squares (reference
solver.py:1119-1273, solver_pinball.hpp).

    minimize_b  1/2 || S^{-1/2} v - S^{1/2} A^T b ||_2^2
                + penalty_neg' b_-  +  penalty_pos' b_+

Counterpart of ``adelie_tpu/solver/_pinball.py``, with BVLS's structure:
the host drives the screening rounds of up to ``kappa`` KKT violators;
each fit forms the Gram ``A_s S A_s^T`` of the screened rows of ``A`` with
two products and runs as one ``screened_cd_fit`` call (K7 on the card).
``y_var = v' S^+ v`` takes the minimum-norm least-squares solution of
``S x = v`` (numpy's ``lstsq`` with its default cutoff), right for a
singular ``S``: the pseudo-inverse by SVD, singular values below
``max(m, n) eps`` of the largest dropped.
"""

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import matrix as matrix_mod
from ..configs import configs, matmul_precision
from ..exceptions import SolverError
from ..matrix.dense import _as_tensor
from ..utils import Stopwatch, bucket
from .screened_cd import padded, screened_cd_fit


@dataclass
class StatePinball:
    """Result state (reference state/state_pinball.hpp fields)."""

    A: Any = None
    y_var: float = 0.0
    S: np.ndarray = None
    penalty_neg: np.ndarray = None
    penalty_pos: np.ndarray = None
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


def lstsq_quad(S, v):
    """``v' x`` for the minimum-norm least-squares ``x`` of ``S x = v``
    (numpy's ``lstsq(S, v, rcond=None)``): ``x = pinv(S) v`` by SVD, which
    a singular ``S`` does not break (``torch.linalg.lstsq`` on the card has
    only a full-rank driver)."""
    with matmul_precision():
        return float(v @ (torch.linalg.pinv(S) @ v))


def pinball(
    A,
    S,
    v,
    penalty_neg,
    penalty_pos,
    *,
    kappa: int = None,
    max_iters: int = int(1e5),
    tol: float = 1e-7,
    n_threads: int = 1,
    warm_start=None,
    dtype=None,
    device=None,
):
    """Solve pinball LS (reference solver.py:1119).  Returns
    :class:`StatePinball`.

    ``A`` a constraint matrix of the port, or an (m, d) array or tensor,
    which goes to ``device`` (default ``"cuda"``; ``device="cpu"`` for
    the CPU).  ``n_threads`` is accepted for the JAX package's signature
    and ignored."""
    sw = Stopwatch().start()
    if isinstance(A, matrix_mod.MatrixConstraintBase):
        A_dev, dtype = _as_tensor(A.dense(), dtype, A.device,
                                  default=np.float64)
    else:
        A_dev, dtype = _as_tensor(A, dtype, device, default=np.float64)
    like = dict(dtype=A_dev.dtype, device=A_dev.device)
    m, d = A_dev.shape

    S = np.asarray(S.cpu() if isinstance(S, torch.Tensor) else S, dtype)
    v = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v, dtype)
    S_dev = torch.as_tensor(S, **like)
    v_dev = torch.as_tensor(v, **like)
    if kappa is None:
        kappa = min(m, d)
    kappa = int(kappa)
    y_var = lstsq_quad(S_dev, v_dev)

    pn = np.minimum(np.asarray(penalty_neg, dtype), configs.max_solver_value)
    pp = np.minimum(np.asarray(penalty_pos, dtype), configs.max_solver_value)

    if warm_start is None:
        beta = np.zeros(m, dtype)
        screen_idx = []
        is_screen = np.zeros(m, bool)
        is_active_full = np.zeros(m, bool)
        resid = v_dev.clone()
        loss = 0.5 * y_var
    else:
        beta = np.asarray(warm_start.beta, dtype).copy()
        screen_idx = list(np.asarray(warm_start.active_set, int))
        is_screen = np.zeros(m, bool)
        is_screen[screen_idx] = True
        is_active_full = np.asarray(warm_start.is_active, bool).copy()
        with matmul_precision():
            resid = v_dev - S_dev @ (A_dev.T @ torch.as_tensor(beta, **like))
        loss = 0.5 * lstsq_quad(S_dev, resid)

    iters = 0
    n_kkt = 0
    tol_scale = tol * y_var

    state = StatePinball(
        A=A, y_var=y_var, S=S, penalty_neg=pn, penalty_pos=pp, kappa=kappa,
        max_iters=max_iters, tol=tol,
    )

    while True:
        loss_prev = loss

        if screen_idx:
            sw_fit = Stopwatch().start()
            rows = np.asarray(screen_idx, np.int64)
            S_val = len(rows)
            S_cap = bucket(S_val, configs.screen_cap_min)

            As = torch.zeros((S_cap, d), **like)
            As[:S_val] = A_dev[torch.as_tensor(rows, device=A_dev.device)]
            with matmul_precision():
                AsS = As @ S_dev                                  # (cap, d)
                # Q = AsS As^T, formed as its transpose so that its column
                # i, which the update of slot i reads, is contiguous
                Q = (As @ AsS.T).T
                grad_s = As @ resid
            diag = torch.clamp(torch.diagonal(Q), min=0.0).contiguous()
            lo = padded(pn[rows], S_cap, like)
            hi = padded(pp[rows], S_cap, like)
            b0 = padded(beta[rows], S_cap, like)
            valid = torch.arange(S_cap, device=A_dev.device) < S_val
            act0 = padded(is_active_full[rows], S_cap,
                           dict(dtype=torch.bool, device=A_dev.device), False)
            grad_s = torch.where(valid, grad_s, 0.0)

            beta_s, _, act_s, loss, iters, done = screened_cd_fit(
                Q, diag, b0, grad_s, lo, hi, valid, act0, loss, tol_scale,
                max_iters, iters, mode="pinball")
            if not done:
                raise SolverError("pinball: max iterations reached!")
            with matmul_precision():
                # resid -= sum_k dbeta_k (S A^T)_k
                resid = resid - AsS.T @ (beta_s - b0)
            beta[rows] = beta_s[:S_val].cpu().numpy()
            is_active_full[rows] = act_s[:S_val].cpu().numpy()
            state.benchmark_fit.append(sw_fit.elapsed())

        if n_kkt > 0 and abs(loss - loss_prev) < 1e-6 * abs(y_var):
            break

        # ---- KKT: grad = A resid; viols = max(g - pp, -pn - g) ---- #
        sw_kkt = Stopwatch().start()
        with matmul_precision():
            grad_full = (A_dev @ resid).cpu().numpy()
        n_kkt += 1
        viols = np.maximum(grad_full - pp, -pn - grad_full)
        viols[is_screen] = -np.inf
        order = np.argsort(-viols, kind="stable")
        new = [int(k) for k in order[:kappa] if viols[k] > 0]
        state.benchmark_kkt.append(sw_kkt.elapsed())
        if not new:
            break
        for k in new:
            is_screen[k] = True
        screen_idx.extend(new)

    with matmul_precision():
        state.grad = (A_dev @ resid).cpu().numpy()
    state.screen_set = np.asarray(screen_idx, int)
    state.is_screen = is_screen
    state.active_set = np.nonzero(is_active_full)[0]
    state.is_active = is_active_full
    state.beta = beta
    state.resid = resid.cpu().numpy()
    state.loss = loss
    state.iters = iters
    state.n_kkt = n_kkt
    state.total_time = sw.elapsed()
    return state
