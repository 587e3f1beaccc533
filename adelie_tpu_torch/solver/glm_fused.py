"""The IRLS fit at one lambda, and the lambda-chunk loop of the GLM path.

Counterpart of ``adelie_tpu/solver/glm_fused.py`` (``_make_irls_fit``,
``_kkt_block``, ``build_glm_chunk_step``) and of the optimistic scan of
``adelie_tpu/solver/streamed.py`` (``build_streamed_glm_chunk_step``).
The JAX package runs a chunk as one jitted ``lax.scan`` of
``lax.while_loop``s; PyTorch runs eagerly, so both are Python loops with
the same carry semantics (reference ``solver_glm_naive.hpp`` fit
:241-459).

One IRLS iteration: the floored Hessian and the working weights
``irls_w = hess / sum(hess)``, the working response and the intercept's
shift, the screen Gram and its ``eigh`` under ``irls_w``
(``ScreenCache.rebuild_weighted``), the screen gradient, the pin solve at
``lmda / sum(hess)`` (K1, K2 or K6), the working-residual update, the new
intercept, eta and gradient, and the criterion ``|<resid_n - resid, eta_n -
eta>|``.  The pin kernels take lambda as a scalar argument, so the host
must know ``sum(hess)`` before each launch: each iteration computes the
next iteration's Hessian at its end and reads its sum with the solve's
``info`` and the criterion, in ONE host copy an iteration.  A lambda adds
one more (its KKT verdict, loss and intercept).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..configs import matmul_precision
from ..glm import hessian_min
from .pin import pin_cov_launch, pin_info
from .state_core import abs_grad_kernel


@dataclass
class IrlsCarry:
    """An iterate of the GLM path; ``hess`` (floored) and its sum
    ``hess_sum`` (read to the host, in the fit's dtype) belong to its
    ``eta`` and ``resid``."""

    beta: torch.Tensor       # (S_cap,)
    active: torch.Tensor     # (G_cap,) bool
    eta: torch.Tensor        # (n,)
    resid: torch.Tensor      # (n,) glm.gradient(eta)
    b0: torch.Tensor         # 0-d
    hess: torch.Tensor
    hess_sum: float


def floored_hessian(glm, eta, resid, hmin):
    hess = glm.hessian(eta, resid)
    return torch.clamp(hess, min=0.0) + hmin * (hess <= 0).to(hess.dtype)


def irls_start(glm, beta, active, eta, resid, b0, dt):
    """An ``IrlsCarry`` with its Hessian, read with one host copy."""
    hess = floored_hessian(glm, eta, resid, hessian_min(dt))
    return IrlsCarry(beta, active, eta, resid, b0, hess,
                     float(torch.sum(hess)))


@dataclass
class IrlsFit:
    carry: IrlsCarry
    iters: int               # IRLS iterations
    converged: bool
    pin_ok: bool


def irls_fit(cache, glm, carry: IrlsCarry, offsets, lmda, *, alpha, tol_base,
             irls_tol, irls_max_iters, dbeta_tol, newton_tol,
             newton_max_iters, max_iters, intercept, dt, pin_caps):
    """The proximal-Newton fit at ``lmda`` over the screen block of
    ``cache``, from ``carry``.  Runs while the criterion exceeds
    ``irls_tol``, every pin solve converged and fewer than
    ``irls_max_iters`` iterations ran; a non-finite criterion (float32
    overflow in a saturating GLM) ends the loop as if the cap were reached.
    Returns the last iterate whatever the outcome; the caller rolls back.
    ``pin_caps`` gets each pin solve's screen capacity."""
    hmin = hessian_min(dt)
    grouped = cache.qmax > 1
    irls_tol_d = float(dt(irls_tol))
    lmda_d, tol_base_d = dt(lmda), dt(tol_base)
    zero = dt(0.0)
    it, converged, pin_ok = 0, False, True
    while not converged and pin_ok and it < irls_max_iters:
        beta, eta, resid, b0 = carry.beta, carry.eta, carry.resid, carry.b0
        hess = carry.hess
        hess_sum = dt(carry.hess_sum)
        irls_resid = glm.inv_hessian_gradient(eta, resid, hess)
        irls_w = hess / torch.sum(hess)
        irls_y = irls_resid + eta - offsets
        with matmul_precision():
            y_mean = irls_w @ irls_y
        if intercept:
            irls_resid = irls_resid + (b0 - y_mean)
        with matmul_precision():
            resid_sum = irls_w @ irls_resid
        lmda_adj = float(lmda_d / hess_sum)
        tol_adj = float(tol_base_d / hess_sum)

        # the Gram and its eigh under the new weights (reference
        # solver_glm_naive.hpp:361-385)
        cache.rebuild_weighted(irls_w, intercept)
        with matmul_precision():
            grad_s = cache.screen_grad(irls_w * irls_resid)
        if intercept:
            grad_s = grad_s - cache.means_s * resid_sum
        beta_n, _, active_n, info = pin_cov_launch(
            cache.A, grad_s, beta, cache.slot_begin, cache.slot_size,
            cache.eigvals, cache.eigvecs, cache.penalty_slots, carry.active,
            lmda_adj, alpha, tol_adj, dbeta_tol, newton_tol,
            newton_max_iters, max_iters, zero)
        pin_caps.append(cache.S_cap)

        with matmul_precision():
            irls_resid = irls_resid - cache.screen_apply(beta_n - beta)
            resid_sum_n = irls_w @ irls_resid
        if intercept:
            b0_n = y_mean + resid_sum_n
        else:
            b0_n = torch.zeros((), dtype=eta.dtype, device=eta.device)
        eta_n = irls_y + offsets - irls_resid
        if intercept:
            eta_n = eta_n + (b0_n - y_mean)
        resid_n = glm.gradient(eta_n)
        with matmul_precision():
            crit = torch.abs((resid_n - resid) @ (eta_n - eta))
        hess_n = floored_hessian(glm, eta_n, resid_n, hmin)
        # one host copy: the solve's info, the criterion, the next sum
        host = torch.cat([info.to(torch.float64),
                          torch.stack([crit, torch.sum(hess_n)])
                          .to(torch.float64)]).tolist()
        done = pin_info(host[:-2], grouped)[2]
        crit_h = host[-2]
        carry = IrlsCarry(beta_n, active_n, eta_n, resid_n, b0_n, hess_n,
                          host[-1])
        it = it + 1 if np.isfinite(crit_h) else irls_max_iters
        converged = crit_h <= irls_tol_d
        pin_ok = done
    return IrlsFit(carry, it, converged, pin_ok)


def glm_kkt(X, cache, *, group_cols, penalty_cols, penalty_groups, is_screen,
            alpha):
    """The KKT check of a GLM on a matrix in device memory (reference
    solver_base.hpp:21-110, 410-433): ``check(carry, lmda)`` forms the
    full gradient ``X^T resid`` (no centering: the intercept is a
    coordinate of eta), the group norms and the verdict, and returns
    ``(abs_grad, kkt)`` with ``kkt`` a 0-d device tensor."""

    def check(carry, lmda):
        ones = torch.ones_like(carry.resid)
        grad = X.mul(carry.resid, ones)
        abs_grad = abs_grad_kernel(
            grad, cache.cols_padded, carry.beta, penalty_cols, group_cols,
            (1.0 - alpha) * min(lmda, 1e30))
        viol = abs_grad > lmda * alpha * penalty_groups
        return abs_grad, ~torch.any(viol & ~is_screen)

    return check


@dataclass
class GlmEmit:
    """What one processed lambda of a chunk reports (host values read in
    one copy after its IRLS fit)."""

    carry: IrlsCarry         # the fit's last iterate
    b0: float
    accept: bool
    kkt: bool
    fit_ok: bool
    pin_ok: bool
    dev: float
    early: bool
    irls_iters: int


def glm_chunk_step(cache, glm, carry: IrlsCarry, lmdas, *, offsets, alpha,
                   tol_base, irls_tol, irls_max_iters, dbeta_tol, newton_tol,
                   newton_max_iters, max_iters, intercept, dt, loss_null,
                   loss_full, adev_tol, ddev_tol, early_exit, prev_dev,
                   have_prev, sweep_budget, pin_caps, kkt=None):
    """Fit the lambdas of a chunk in order from ``carry``.

    ``kkt`` is a ``glm_kkt`` check, or None for the optimistic loop of the
    host-streamed driver, which accepts every converged fit.  A fit that
    fails (IRLS at its cap or a pin solve at ``max_iters``) does not
    advance the iterate.  The loop stops after a lambda that is not
    accepted, after the deviance early exit or when the chunk's IRLS
    iterations reach ``sweep_budget``.  Returns ``(carry, abs_grad,
    prev_dev, have_prev, early_seen, emits)``: the iterate after the last
    processed lambda, the group norms of the last KKT check, and one
    ``GlmEmit`` per processed lambda.
    """
    emits = []
    cum_irls = 0
    abs_grad = None
    early_seen = False
    loss_null_d, loss_full_d = dt(loss_null), dt(loss_full)
    adev_d, ddev_d = dt(adev_tol), dt(ddev_tol)
    for lmda in lmdas:
        f = irls_fit(cache, glm, carry, offsets, lmda, alpha=alpha,
                     tol_base=tol_base, irls_tol=irls_tol,
                     irls_max_iters=irls_max_iters, dbeta_tol=dbeta_tol,
                     newton_tol=newton_tol,
                     newton_max_iters=newton_max_iters, max_iters=max_iters,
                     intercept=intercept, dt=dt, pin_caps=pin_caps)
        fit_ok = f.converged and f.pin_ok
        c = f.carry
        loss = glm.loss(c.eta)
        if kkt is None:
            loss_h, b0_h = torch.stack([loss, c.b0]).tolist()
            ok = True
        else:
            abs_grad, ok_t = kkt(c, lmda)
            ok_h, loss_h, b0_h = torch.stack(
                [ok_t.to(loss.dtype), loss, c.b0]).tolist()
            ok = bool(ok_h)
        accept = fit_ok and ok
        dev = float((loss_null_d - dt(loss_h)) / (loss_null_d - loss_full_d))
        dev_d = dt(dev)
        early = bool(early_exit) and accept and bool(
            dev_d >= adev_d
            or (have_prev and abs(dev_d - dt(prev_dev)) < ddev_d))
        cum_irls += f.iters
        emits.append(GlmEmit(c, b0_h, accept, ok, fit_ok, f.pin_ok, dev,
                             early, f.iters))
        if fit_ok:
            carry = c
            stopped = not accept or early or cum_irls >= sweep_budget
            if accept:
                prev_dev, have_prev = dev, True
            early_seen = early_seen or early
        else:
            stopped = True
        if stopped:
            break
    return carry, abs_grad, prev_dev, have_prev, early_seen, emits
