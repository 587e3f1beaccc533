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
from .basil import compute_lmda_max, compute_lmda_path, screen
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

    def _record(self, lmda, screen_beta, rsq, resid_sum, cache):
        s = self.s
        nz = np.abs(screen_beta) > 0
        beta_row = sp.csr_matrix(
            (screen_beta[nz], (np.zeros(int(nz.sum()), int), cache.cols[nz])),
            shape=(1, s.p),
        )
        s.betas.append(beta_row)
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
            is_screen=s.screen_mask_dev(), alpha=s.alpha,
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
        s = self.s
        sw = Stopwatch().start()
        if exit_cond is not None:
            # user exit conditions are evaluated per lambda
            s.lmda_chunk = 1
        exit_cond = exit_cond or (lambda *a: False)

        # --- lmda_max setup ---
        if s.setup_lmda_max and s.lmda_max is None:
            self._run_chunk([self.large_lmda()], record=False)
            s.lmda_max = compute_lmda_max(s.abs_grad, s.alpha, s.penalty)

        if s.setup_lmda_path and s.lmda_path is None:
            if s.lmda_path_size <= 0:
                s.total_time = sw.elapsed()
                return s
            s.lmda_path = compute_lmda_path(
                s.lmda_max, s.min_ratio, s.lmda_path_size
            )
        path = np.asarray(s.lmda_path, float)

        # --- lambdas above lmda_max (all-accept fits; record them) ---
        large_count = int(np.searchsorted(-path, -s.lmda_max))
        if large_count or s.setup_lmda_max:
            # record the path entries above lmda_max, then position the
            # state at lmda_max without recording (solver_base.hpp:540-595)
            seg = list(path[:large_count])
            Cc = int(s.lmda_chunk)
            for i in range(0, len(seg), Cc):
                _, early, _ = self._run_chunk(seg[i:i + Cc], record=True)
                if early or exit_cond(s):
                    s.total_time = sw.elapsed()
                    return s
            self._run_chunk([s.lmda_max], record=False)

        idx = large_count
        kkt_passed = True
        n_new_active = 0
        current_active = s.active_set_size

        # --- chunked BASIL iterations ---
        while idx < len(path):
            C = min(int(s.lmda_chunk), len(path) - idx)
            chunk = path[idx:idx + C]
            lmda_prev = path[idx + C - 2] if C > 1 else s.lmda
            sw_p = Stopwatch().start()
            screen(s, chunk[-1], kkt_passed, n_new_active,
                   lmda_prev=lmda_prev, lmda_fallback=chunk[0],
                   chunk_size=C)
            s.benchmark["screen"].append(sw_p.elapsed())

            n_acc, early, kkt_clean = self._run_chunk(chunk, record=True)
            idx += n_acc
            # budget-frozen chunks with every processed lambda accepted are
            # not KKT failures: screening must not union in the strong set
            kkt_passed = kkt_clean
            if n_acc:
                n_new_active = s.active_set_size - current_active
                current_active = s.active_set_size
            if early or exit_cond(s):
                break

        s.total_time = sw.elapsed()
        return s
