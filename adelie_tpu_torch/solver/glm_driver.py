"""GLM path solver: the proximal-Newton (IRLS) outer loop.

Counterpart of ``adelie_tpu/solver/glm_driver.py`` (reference
``solver_glm_naive.hpp``: fit :241-459, update_loss_null :166-232).  The
path loop is the gaussian driver's (``GaussianNaiveDriver.solve_path``:
the dry fit at ``large_lmda``, ``lmda_max``, the path, BASIL's screen a
chunk); a chunk runs ``glm_fused.glm_chunk_step``, whose every IRLS
iteration refreshes the screen Gram under the new weights and solves with
K1, K2 or K6.  A failed fit leaves the state as it was before that lambda
and raises after the state has advanced through the chunk, so the caller
keeps a valid partial path (reference py_state.cpp:83-89).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..configs import configs
from ..exceptions import MaxCDsError, SolverError
from ..glm import hessian_min
from ..utils import Stopwatch
from .gaussian import GaussianNaiveDriver
from .glm_fused import (IrlsCarry, floored_hessian, glm_chunk_step, glm_kkt,
                        irls_start)
from .state_core import NaiveStateBase


@dataclass
class GlmNaiveState(NaiveStateBase):
    glm: object = None           # the GLM on the state's device and dtype
    offsets: object = None       # device (n,)
    beta0: float = 0.0
    eta: object = None           # device (n,)
    resid: object = None         # device (n,) = glm.gradient(eta)
    loss_null: float = None
    loss_full: float = None
    irls_max_iters: int = int(1e4)
    irls_tol: float = 1e-7


class GlmNaiveDriver(GaussianNaiveDriver):
    """The GLM (IRLS) BASIL driver on a matrix in device memory: the
    gaussian driver's path loop with the IRLS chunk."""

    def __init__(self, state: GlmNaiveState):
        super().__init__(state)
        self._start = None     # the IrlsCarry of the state's eta, if known

    # -- intercept-only IRLS for loss_null (reference :166-232) ----------- #
    def update_loss_null(self):
        """The null model's loss: without an intercept ``loss(offsets)``;
        with one, the intercept-only IRLS fit to ``irls_tol`` within
        ``irls_max_iters`` (one host copy an iteration)."""
        s = self.s
        if s.loss_null is not None:
            return
        glm = s.glm
        if not s.intercept:
            s.loss_null = float(glm.loss(s.offsets))
            return
        hmin = hessian_min(s.dtype)
        tol = float(s.dtype.type(s.irls_tol))
        eta, resid = s.eta, s.resid
        it, done = 0, False
        while not done and it < s.irls_max_iters:
            hess = floored_hessian(glm, eta, resid, hmin)
            irls_y_work = glm.inv_hessian_gradient(eta, resid, hess)
            beta0 = (torch.sum(hess * (irls_y_work + eta - s.offsets))
                     / torch.sum(hess))
            eta_n = beta0 + s.offsets
            resid_n = glm.gradient(eta_n)
            crit = torch.abs(torch.sum((resid_n - resid) * (eta_n - eta)))
            eta, resid = eta_n, resid_n
            it += 1
            done = float(crit) <= tol
        if not done:
            raise SolverError("Maximum IRLS iterations reached (loss_null).")
        s.loss_null = float(glm.loss(eta))

    def _carry(self, cache):
        """The state's iterate as an ``IrlsCarry`` on the screen's slots;
        its Hessian comes from the last chunk when its eta is the state's,
        else with one host copy."""
        s = self.s
        beta = cache.pad_screen_values(s.screen_beta, s)
        active = cache.pad_group_bools(s.screen_is_active, s.device)
        b0 = torch.as_tensor(s.beta0, dtype=s.torch_dtype, device=s.device)
        st = self._start
        if st is not None and st.eta is s.eta:
            return IrlsCarry(beta, active, s.eta, s.resid, b0, st.hess,
                             st.hess_sum)
        return irls_start(s.glm, beta, active, s.eta, s.resid, b0, s.dtype)

    def _loop_args(self):
        s = self.s
        return dict(
            offsets=s.offsets, alpha=s.alpha,
            tol_base=s.tol * (s.loss_null - s.loss_full),
            irls_tol=s.irls_tol, irls_max_iters=int(s.irls_max_iters),
            dbeta_tol=configs.dbeta_tol, newton_tol=s.newton_tol,
            newton_max_iters=s.newton_max_iters, max_iters=s.max_iters,
            intercept=s.intercept, dt=s.dtype.type, loss_null=s.loss_null,
            loss_full=s.loss_full, adev_tol=s.adev_tol, ddev_tol=s.ddev_tol,
            early_exit=bool(s.early_exit), prev_dev=self._prev_dev,
            have_prev=self._have_prev_dev,
            sweep_budget=configs.chunk_sweep_budget,
            pin_caps=s.benchmark["pin_caps"])

    def _record_fit(self, lmda, screen_beta, b0, dev, cache, active_size):
        s = self.s
        self._append_beta(screen_beta, cache)
        s.intercepts.append(float(b0) if s.intercept else 0.0)
        s.lmdas.append(float(lmda))
        s.devs.append(float(dev))
        s.n_valid_solutions.append(True)
        s.active_sizes.append(int(active_size))
        s.screen_sizes.append(len(s.screen_set))

    def _advance(self, carry, cache):
        s = self.s
        s.screen_beta = carry.beta.cpu().numpy()[: cache.S_val].copy()
        s.screen_is_active = \
            carry.active.cpu().numpy()[: len(s.screen_set)].copy()
        s.eta = carry.eta
        s.resid = carry.resid
        s.beta0 = float(carry.b0)
        self._start = carry

    def _run_chunk(self, lmdas, record):
        """Fit a chunk of lambdas.  Returns ``(n_accepted, early_stopped,
        kkt_clean)``; the state advances through the last processed lambda,
        a failed fit leaving the iterate before it (reference
        solver_glm_naive.hpp:315-322), and a failure raises after that."""
        s = self.s
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()
        lmdas = np.asarray(lmdas, float)
        check = glm_kkt(
            s.X, cache, group_cols=s._group_cols,
            penalty_cols=s._penalty_cols,
            penalty_groups=self._penalty_groups_dev,
            is_screen=s.screen_mask_dev(), alpha=s.alpha)
        carry, abs_grad, prev_dev, have_prev, early, emits = glm_chunk_step(
            cache, s.glm, self._carry(cache), lmdas, kkt=check,
            **self._loop_args())
        n_proc = len(emits)
        n_acc = sum(e.accept for e in emits)
        # every processed lambda accepted: the chunk froze at the budget
        # or the early exit, not at a KKT failure
        kkt_clean = n_acc == n_proc
        s.benchmark["irls_iters"].extend(e.irls_iters for e in emits)

        if n_proc:
            self._advance(carry, cache)
            s.abs_grad = abs_grad.cpu().numpy()
            if record:
                # dry fits must not seed the ddev early-exit comparison
                self._prev_dev, self._have_prev_dev = prev_dev, have_prev
            s.lmda = float(lmdas[n_proc - 1])

        if record and emits:
            # the JAX package records the chunk's final active count
            active_size = int(s.screen_is_active.sum())
            betas_h = torch.stack([e.carry.beta for e in emits]).cpu().numpy()
            for i, (lm, e) in enumerate(zip(lmdas, emits)):
                if e.accept:
                    self._record_fit(lm, betas_h[i][: cache.S_val], e.b0,
                                     e.dev, cache, active_size)
                else:
                    s.n_valid_solutions.append(False)

        s.benchmark["fit_screen"].append(sw.elapsed())
        bad = [e for e in emits if not e.fit_ok]
        if bad:
            if not bad[0].pin_ok:
                raise MaxCDsError()
            raise SolverError("Maximum IRLS iterations reached.")
        return n_acc, early, kkt_clean

    def solve_path(self, progress_bar=False, exit_cond=None):
        """The null loss, then the gaussian driver's chunked BASIL loop
        with the IRLS chunk."""
        self.update_loss_null()
        return super().solve_path(progress_bar=progress_bar,
                                  exit_cond=exit_cond)
