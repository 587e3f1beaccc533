"""The per-lambda step of the gaussian path, and the lambda-chunk loop.

Counterpart of ``adelie_tpu/solver/fused.py``.  The JAX package fuses a whole
chunk of lambdas into one jitted ``lax.scan``; PyTorch runs eagerly, so the
scan is a Python loop over ``gaussian_step`` with the same carry semantics:
it advances through accepted lambdas and freezes at the first lambda that
fails KKT or the pin solve, at the deviance early exit, or once the chunk's
sweep budget is spent.
"""

from dataclasses import dataclass

import torch

from ..configs import matmul_precision
from .pin import pin_cov_solve
from .state_core import abs_grad_kernel


@dataclass
class StepResult:
    """One lambda's fit.  Tensors stay on the device; the scalars were read
    to the host."""

    beta: torch.Tensor       # (S_cap,)
    active: torch.Tensor     # (G_cap,) bool
    resid: torch.Tensor      # (n,)
    abs_grad: torch.Tensor   # (G,)
    rsq: float
    resid_sum: float
    kkt: bool
    done: bool
    iters: int


def gaussian_step(X, cache, beta, active, resid, rsq, w, X_means,
                  group_ids, penalty_cols, penalty_groups, is_screen,
                  lmda, alpha, tol, max_iters, intercept, num_groups):
    """Screen gradient, pin solve, residual update, full gradient, group
    norms and the KKT verdict at one lambda."""
    Xs = cache.Xs
    with matmul_precision():
        resid_sum0 = w @ resid
        grad_s = (w * resid) @ Xs
    if intercept:
        grad_s = grad_s - cache.means_s * resid_sum0

    beta_n, _, active_n, rsq_n, iters, done = pin_cov_solve(
        cache.A, grad_s, beta, cache.slot_begin, cache.slot_size,
        cache.eigvals, cache.penalty_slots, active, lmda, alpha, tol,
        max_iters, rsq,
    )

    with matmul_precision():
        resid_n = resid - Xs @ (beta_n - beta)
        resid_sum = w @ resid_n
    grad = X.mul(resid_n, w)
    if intercept:
        grad = grad - resid_sum * X_means

    abs_grad = abs_grad_kernel(
        grad, cache.cols_padded, beta_n, penalty_cols, group_ids,
        (1.0 - alpha) * min(lmda, 1e30), num_groups,
    )

    # KKT verdict (reference solver_base.hpp:410-433)
    viol = abs_grad > lmda * alpha * penalty_groups
    kkt = ~torch.any(viol & ~is_screen)
    kkt_h, resid_sum_h = torch.stack(
        [kkt.to(resid_sum.dtype), resid_sum]).tolist()
    return StepResult(beta_n, active_n, resid_n, abs_grad, rsq_n,
                      resid_sum_h, bool(kkt_h), done, iters)


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
    """What one processed lambda of a chunk reports."""

    beta: torch.Tensor
    rsq: float
    resid_sum: float
    accept: bool
    kkt: bool
    done: bool
    dev: float
    iters: int


def gaussian_chunk_step(X, cache, carry: ChunkCarry, lmdas, *, w, X_means,
                        group_ids, penalty_cols, penalty_groups, is_screen,
                        alpha, tol, max_iters, y_var, adev_tol, ddev_tol,
                        early_exit, sweep_budget, intercept, num_groups):
    """Fit the lambdas of a chunk in order from ``carry``.

    Returns the carry after the last processed lambda and one ``Emit`` per
    processed lambda; the loop stops after a lambda that is not accepted
    (pin failure or KKT failure), after the early exit, or when the
    chunk's sweeps reach ``sweep_budget``.
    """
    emits = []
    cum_iters = 0
    for lmda in lmdas:
        r = gaussian_step(
            X, cache, carry.beta, carry.active, carry.resid, carry.rsq, w,
            X_means, group_ids, penalty_cols, penalty_groups, is_screen,
            lmda, alpha, tol, max_iters, intercept, num_groups,
        )
        accept = r.done and r.kkt
        dev = r.rsq / y_var if y_var > 0 else 0.0
        early = early_exit and accept and (
            dev >= adev_tol
            or (carry.have_prev and abs(dev - carry.prev_dev) < ddev_tol)
        )
        cum_iters += r.iters
        carry = ChunkCarry(
            r.beta, r.active, r.resid, r.rsq, r.abs_grad,
            dev if accept else carry.prev_dev,
            carry.have_prev or accept,
            carry.early_seen or early,
        )
        emits.append(Emit(r.beta, r.rsq, r.resid_sum, accept, r.kkt, r.done,
                          dev, r.iters))
        if not accept or early or cum_iters >= sweep_budget:
            break
    return carry, emits
