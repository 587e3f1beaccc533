"""Gaussian naive path solver (no IRLS).

Counterpart of ``adelie_tpu/solver/gaussian.py``: the chunked BASIL loop.
The host screens once per chunk of lambdas (``basil.screen``), and the
chunk is fitted by ``fused.gaussian_chunk_step``; the screen set grows and
the chunk resumes at the first unaccepted lambda until the path is done.
"""

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..configs import configs
from ..exceptions import MaxCDsError
from ..utils import Stopwatch, large_lmda
from .basil import chunked_path
from .fused import ChunkCarry, full_kkt, gaussian_chunk_step
from .state_core import NaiveStateBase


@dataclass
class GaussianNaiveState(NaiveStateBase):
    weights: object = None       # device (n,), sums to 1
    X_means: object = None       # device (p,)
    y_mean: float = 0.0
    y_var: float = 1.0
    rsq: float = 0.0
    resid: object = None         # device (n,)
    resid_sum: float = 0.0
    rsqs: list = None

    def __post_init__(self):
        super().__post_init__()
        if self.rsqs is None:
            self.rsqs = []


class GaussianNaiveDriver:
    def __init__(self, state: GaussianNaiveState):
        self.s = state
        self._prev_dev = 0.0
        self._have_prev_dev = False
        self._penalty_groups_dev = torch.as_tensor(
            state.penalty.astype(state.dtype), device=state.device
        )

    def large_lmda(self):
        return large_lmda(self.s.dtype)

    # pin mode (``state.gaussian_pin_naive``): the screen set is fixed, so
    # every group counts as screened, the KKT verdict is vacuous and the
    # chunk loop accepts every converged fit (JAX package
    # ``solver/gaussian.py:67-77``)
    pin_mode = False
    _all_screened = None

    def _screen_mask(self):
        s = self.s
        if not self.pin_mode:
            return s.screen_mask_dev()
        if self._all_screened is None:
            self._all_screened = torch.ones(len(s.groups), dtype=torch.bool,
                                            device=s.device)
        return self._all_screened

    def _append_beta(self, screen_beta, cache):
        """Append the screen's coefficients as a sparse row of length p."""
        s = self.s
        nz = np.abs(screen_beta) > 0
        s.betas.append(sp.csr_matrix(
            (screen_beta[nz], (np.zeros(int(nz.sum()), int), cache.cols[nz])),
            shape=(1, s.p),
        ))

    def _record(self, lmda, screen_beta, rsq, resid_sum, cache):
        s = self.s
        self._append_beta(screen_beta, cache)
        s.intercepts.append(
            float(s.intercept) * (s.y_mean + resid_sum) if s.intercept else 0.0
        )
        s.lmdas.append(float(lmda))
        s.rsqs.append(float(rsq))
        s.devs.append(float(rsq) / s.y_var if s.y_var > 0 else 0.0)

    def _loop_args(self):
        """The chunk loop's arguments that do not change within a path."""
        s = self.s
        return dict(w=s.weights, alpha=s.alpha, tol=s.tol,
                    max_iters=s.max_iters, y_var=s.y_var,
                    adev_tol=s.adev_tol, ddev_tol=s.ddev_tol,
                    early_exit=bool(s.early_exit),
                    sweep_budget=configs.chunk_sweep_budget,
                    intercept=s.intercept, dbeta_tol=configs.dbeta_tol,
                    newton_tol=s.newton_tol,
                    newton_max_iters=s.newton_max_iters)

    def _run_chunk(self, lmdas, record):
        """Fit a chunk of lambdas.

        Returns ``(n_accepted, early_stopped, kkt_clean)``.  ``kkt_clean``
        is True when no processed lambda failed KKT: a chunk frozen by the
        sweep budget or the early exit with every processed lambda accepted
        is not a KKT failure for the next ``screen`` call.  The state
        advances through the last processed lambda (a KKT-failed fit keeps
        its iterate, as in the reference retry loop).
        """
        s = self.s
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()
        if cache.A is None:
            cache.rebuild_weighted(s.weights, s.intercept)

        lmdas = np.asarray(lmdas, float)
        carry = ChunkCarry(
            beta=cache.pad_screen_values(s.screen_beta, s),
            active=cache.pad_group_bools(s.screen_is_active, s.device),
            resid=s.resid, rsq=float(s.rsq),
            abs_grad=None, prev_dev=self._prev_dev,
            have_prev=self._have_prev_dev,
        )
        check = full_kkt(
            s.X, cache, w=s.weights, X_means=s.X_means,
            group_cols=s._group_cols, penalty_cols=s._penalty_cols,
            penalty_groups=self._penalty_groups_dev,
            is_screen=self._screen_mask(), alpha=s.alpha,
            intercept=s.intercept,
        )
        carry, emits = gaussian_chunk_step(
            cache, carry, lmdas, kkt=check, **self._loop_args())
        n_proc = len(emits)
        s.benchmark["pin_caps"].extend([cache.S_cap] * n_proc)
        # accepts are a prefix
        n_acc = sum(e.accept for e in emits)
        kkt_clean = n_acc == n_proc
        pin_fail = [i for i, e in enumerate(emits) if not e.done]
        active_h = carry.active.cpu().numpy()
        betas_h = torch.stack([e.beta for e in emits]).cpu().numpy()

        if record:
            S_val = cache.S_val
            G_s = len(s.screen_set)
            for i, e in enumerate(emits):
                if e.accept:
                    self._record(lmdas[i], betas_h[i][:S_val], e.rsq,
                                 e.resid_sum, cache)
                    s.n_valid_solutions.append(True)
                    s.active_sizes.append(int(active_h.sum()))
                    s.screen_sizes.append(len(s.screen_set))
                else:
                    s.n_valid_solutions.append(False)
                s.benchmark["cd_iters"].append(e.iters)
                s.benchmark["cd_updates"].append(e.iters * G_s)

        # advance the state through the last processed lambda
        s.screen_beta = betas_h[-1][: cache.S_val].copy()
        s.screen_is_active = active_h[: len(s.screen_set)].copy()
        s.prune_inactive_zeros()
        s.resid = carry.resid
        s.rsq = carry.rsq
        s.resid_sum = emits[-1].resid_sum
        s.abs_grad = carry.abs_grad.cpu().numpy()
        s.lmda = float(lmdas[n_proc - 1])
        if record:
            # dry fits must not seed the ddev early-exit comparison
            self._prev_dev = carry.prev_dev
            self._have_prev_dev = carry.have_prev
        s.benchmark["fit_screen"].append(sw.elapsed())
        if pin_fail:
            raise MaxCDsError(pin_fail[0])
        return n_acc, carry.early_seen, kkt_clean

    def solve_path(self, progress_bar=False, exit_cond=None):
        """Chunked BASIL loop (replaces basil.solve_core for gaussian)."""
        return chunked_path(self, exit_cond)
