"""The per-lambda step of the gaussian path, and the lambda-chunk loop.

Counterpart of ``adelie_tpu/solver/fused.py`` and of the optimistic scan of
``adelie_tpu/solver/streamed.py``.  The JAX package fuses a whole chunk of
lambdas into one jitted ``lax.scan``; PyTorch runs eagerly, so the scan is a
Python loop with the same carry semantics.  Each lambda runs ``screen_fit``
(screen gradient, pin solve, residual update) and then, on a matrix in
device memory, ``full_kkt`` (full gradient, group norms, KKT verdict).  The
loop advances through accepted lambdas and freezes at the first lambda
that fails KKT or the pin solve, at the deviance early exit, or once the
chunk's sweep budget is spent.  The host-streamed driver runs the same
loop without ``full_kkt`` and certifies the chunk afterwards with one pass
over the panel (``streamed.py``).
"""

from dataclasses import dataclass

import torch

from ..configs import matmul_precision
from .pin import pin_cov_solve
from .state_core import abs_grad_kernel


@dataclass
class ScreenFit:
    """One lambda's fit against the screened columns.  Tensors stay on the
    device; ``rsq``, ``iters`` and ``done`` were read to the host."""

    beta: torch.Tensor       # (S_cap,)
    active: torch.Tensor     # (G_cap,) bool
    resid: torch.Tensor      # (n,)
    resid_sum: torch.Tensor  # 0-d
    rsq: float
    iters: int
    done: bool


def screen_fit(cache, beta, active, resid, rsq, w, lmda, alpha, tol,
               max_iters, intercept, dbeta_tol, newton_tol, newton_max_iters):
    """Screen gradient, pin solve and residual update at one lambda."""
    Xs = cache.Xs
    with matmul_precision():
        resid_sum0 = w @ resid
        grad_s = (w * resid) @ Xs
    if intercept:
        grad_s = grad_s - cache.means_s * resid_sum0

    beta_n, _, active_n, rsq_n, iters, done = pin_cov_solve(
        cache.A, grad_s, beta, cache.slot_begin, cache.slot_size,
        cache.eigvals, cache.eigvecs, cache.penalty_slots, active, lmda,
        alpha, tol, dbeta_tol, newton_tol, newton_max_iters, max_iters, rsq,
    )

    with matmul_precision():
        resid_n = resid - Xs @ (beta_n - beta)
        resid_sum = w @ resid_n
    return ScreenFit(beta_n, active_n, resid_n, resid_sum, rsq_n, iters, done)


def full_kkt(X, cache, *, w, X_means, group_cols, penalty_cols,
             penalty_groups, is_screen, alpha, intercept):
    """The KKT check of a matrix in device memory: ``check(fit, lmda)``
    forms the full gradient, the group norms and the verdict (reference
    solver_base.hpp:410-433) and returns ``(abs_grad, kkt, resid_sum)``
    with the last two read to the host in one copy."""

    def check(fit, lmda):
        grad = X.mul(fit.resid, w)
        if intercept:
            grad = grad - fit.resid_sum * X_means
        abs_grad = abs_grad_kernel(
            grad, cache.cols_padded, fit.beta, penalty_cols, group_cols,
            (1.0 - alpha) * min(lmda, 1e30),
        )
        viol = abs_grad > lmda * alpha * penalty_groups
        kkt = ~torch.any(viol & ~is_screen)
        kkt_h, resid_sum_h = torch.stack(
            [kkt.to(fit.resid_sum.dtype), fit.resid_sum]).tolist()
        return abs_grad, bool(kkt_h), resid_sum_h

    return check


@dataclass
class ChunkCarry:
    beta: torch.Tensor
    active: torch.Tensor
    resid: torch.Tensor
    rsq: float
    abs_grad: torch.Tensor
    prev_dev: float
    have_prev: bool
    early_seen: bool = False


@dataclass
class Emit:
    """What one processed lambda of a chunk reports.  ``resid_sum`` is a
    float after a KKT check, else the fit's 0-d device tensor."""

    beta: torch.Tensor
    active: torch.Tensor
    rsq: float
    resid_sum: object
    accept: bool
    kkt: bool
    done: bool
    dev: float
    iters: int


def gaussian_chunk_step(cache, carry: ChunkCarry, lmdas, *, w, alpha, tol,
                        max_iters, y_var, adev_tol, ddev_tol, early_exit,
                        sweep_budget, intercept, dbeta_tol, newton_tol,
                        newton_max_iters, kkt=None):
    """Fit the lambdas of a chunk in order from ``carry``.

    ``kkt`` is a ``full_kkt`` check, or None for the optimistic loop of the
    host-streamed driver, which accepts every converged fit.  Returns the
    carry after the last processed lambda and one ``Emit`` per processed
    lambda; the loop stops after a lambda that is not accepted (pin
    failure or KKT failure), after the early exit, or when the chunk's
    sweeps reach ``sweep_budget``.
    """
    emits = []
    cum_iters = 0
    for lmda in lmdas:
        f = screen_fit(cache, carry.beta, carry.active, carry.resid,
                       carry.rsq, w, lmda, alpha, tol, max_iters, intercept,
                       dbeta_tol, newton_tol, newton_max_iters)
        if kkt is None:
            abs_grad, ok, resid_sum = None, True, f.resid_sum
        else:
            abs_grad, ok, resid_sum = kkt(f, lmda)
        accept = f.done and ok
        dev = f.rsq / y_var if y_var > 0 else 0.0
        early = early_exit and accept and (
            dev >= adev_tol
            or (carry.have_prev and abs(dev - carry.prev_dev) < ddev_tol)
        )
        cum_iters += f.iters
        carry = ChunkCarry(
            f.beta, f.active, f.resid, f.rsq, abs_grad,
            dev if accept else carry.prev_dev,
            carry.have_prev or accept,
            carry.early_seen or early,
        )
        emits.append(Emit(f.beta, f.active, f.rsq, resid_sum, accept, ok,
                          f.done, dev, f.iters))
        if not accept or early or cum_iters >= sweep_budget:
            break
    return carry, emits
