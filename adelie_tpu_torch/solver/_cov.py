"""The covariance method: the gaussian path from ``A = X^T W X`` and
``v = X^T W y`` (reference solver.py:39-351, solver_gaussian_cov.hpp:372).

Counterpart of ``adelie_tpu/solver/_cov.py``.  It solves

    min_b  1/2 b'Ab - v'b + lmda sum_g p_g (alpha ||b_g|| + (1-alpha)/2 ||b_g||^2)

over a lambda path with BASIL screening.  The pin solve already runs in
covariance form, so this method feeds it blocks of ``A``: at every screen
change ``CovScreenCache`` gathers ``A[screen, screen]`` anew and
eigendecomposes the groups' diagonal blocks; K1, K2 and K6 carry the
solves as in ``grpnet``.

* A dense ``A`` (``MatrixCovDense``) runs in chunks of lambdas
  (``basil.chunked_path``, the naive gaussian driver's loop, with
  ``GaussianCovDriver._run_chunk``): a Python loop over the chunk with the
  JAX package's scan carry.  Each lambda forms the screen gradient
  ``v_s - A_s beta``, runs one pin solve, the invariance
  ``grad = v - A[:, screen] beta`` (one GEMV of the screen's columns, which
  the cache gathers once a screen), the group norms and the KKT and rdev
  verdicts, and reads them to the host in one copy with the solve's
  ``(rsq, iters, done)``.
* Any other covariance matrix (lazy, block-diagonal, sparse) runs
  ``basil.solve_core`` a lambda at a time.
"""

from dataclasses import dataclass
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch

from .. import matrix as matrix_mod
from ..configs import configs, matmul_precision
from ..device import resolve_device
from ..exceptions import MaxCDsError
from ..logger import logger
from ..utils import Stopwatch, large_lmda, types
from .basil import chunked_path, solve_core
from .pin import pin_cov_launch, pin_cov_solve, pin_info, screen_eigh
from .state_core import (NaiveStateBase, ScreenCache, abs_grad_kernel,
                         screen_layout)


class CovScreenCache:
    """``A[screen, screen]`` on the device, zero-padded to the screen
    capacity, with the slot buffers and the groups' eigendecompositions;
    for a dense ``A`` also ``A[:, screen]`` (p, S_cap), the columns the
    invariance multiplies."""

    def __init__(self):
        self.version = -1
        self.cols = None
        self.S_val = 0
        self.S_cap = 0
        self.G_cap = 0
        self.qmax = 1
        self.A = None
        self.A_cols = None
        self.cols_padded = None
        self.slot_begin = None
        self.slot_size = None
        self.penalty_slots = None
        self.eigvals = None
        self.eigvecs = None

    # the slot buffers and their padding are the naive screen cache's
    _slot_buffers = ScreenCache._slot_buffers
    pad_screen_values = ScreenCache.pad_screen_values
    pad_group_bools = ScreenCache.pad_group_bools

    def rebuild_structure(self, state):
        begins, gs, S_val, cols, qmax, S_cap, G_cap = screen_layout(state)
        like = dict(dtype=state.torch_dtype, device=state.device)
        A_s = torch.zeros((S_cap, S_cap), **like)
        cols_dev = torch.as_tensor(cols, device=state.device)
        if isinstance(state.A, matrix_mod.MatrixCovDense):
            self.A_cols = torch.zeros((state.p, S_cap), **like)
            if S_val:
                self.A_cols[:, :S_val] = state.A.cols_block(cols_dev)
                A_s[:S_val, :S_val] = self.A_cols[cols_dev, :S_val]
        elif S_val:
            A_s[:S_val, :S_val] = state.A.block(cols_dev, cols_dev)
        self.cols = cols
        self.S_val, self.S_cap, self.G_cap, self.qmax = S_val, S_cap, G_cap, qmax
        self.A = A_s
        self._slot_buffers(state, begins, gs, S_cap, G_cap, cols)
        self.eigvals, self.eigvecs = screen_eigh(
            A_s, self.slot_begin, self.slot_size, qmax)
        self.v_s = torch.zeros(S_cap, **like)
        self.v_s[:S_val] = state.v_dev[cols_dev]


@dataclass
class GaussianCovState(NaiveStateBase):
    """State of the covariance method (reference state.py:1128): ``v``
    on the host, ``v_dev`` on the device."""

    A: Any = None
    v: np.ndarray = None
    rdev_tol: float = 1e-3
    rsq: float = 0.0
    rsqs: list = None

    def __post_init__(self):
        super().__post_init__()
        if self.rsqs is None:
            self.rsqs = []
        self._cache = CovScreenCache()
        self.benchmark.setdefault("invariance", [])
        self.v_dev = torch.as_tensor(self.v, dtype=self.torch_dtype,
                                     device=self.device)


def early_exit_cov(state) -> bool:
    """The rdev rule (reference solver_gaussian_cov.hpp:186-200)."""
    if not state.early_exit or len(state.devs) < 2:
        return False
    dev_u = state.devs[-1]
    dev_m = state.devs[-2]
    return bool(dev_u - dev_m <= state.rdev_tol * dev_u)


class GaussianCovDriver:
    def __init__(self, state: GaussianCovState):
        self.s = state
        self._penalty_groups_dev = torch.as_tensor(
            state.penalty.astype(state.dtype), device=state.device)
        self._prev_dev = 0.0
        self._have_prev_dev = False

    def large_lmda(self):
        return large_lmda(self.s.dtype)

    def _append_beta(self, screen_beta, cols):
        s = self.s
        nz = np.abs(screen_beta) > 0
        s.betas.append(sp.csr_matrix(
            (screen_beta[nz], (np.zeros(int(nz.sum()), int), cols[nz])),
            shape=(1, s.p)))

    # ---- the chunked path (dense A) ---- #

    def _run_chunk(self, lmdas, record):
        """Fit a chunk of lambdas from the state (reference scan carry:
        the loop stops after a lambda that fails the pin solve or KKT, or
        at the rdev early exit).  Returns ``(n_accepted, early_stopped,
        kkt_clean)`` for ``basil.chunked_path``; a failed pin solve raises
        ``MaxCDsError`` before the state moves."""
        s = self.s
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()
        grouped = cache.qmax > 1
        dt = s.dtype.type
        alpha = s.alpha
        is_screen = s.screen_mask_dev()
        beta = cache.pad_screen_values(s.screen_beta, s)
        active = cache.pad_group_bools(s.screen_is_active, s.device)
        rsq = float(s.rsq)
        prev_dev, have_prev = self._prev_dev, self._have_prev_dev
        abs_grad = None
        stopped = False
        emits = []   # (beta, rsq, accept, done)
        for lmda in np.asarray(lmdas, float):
            with matmul_precision():
                grad_s = cache.v_s - cache.A @ beta
            beta_n, _, active_n, info = pin_cov_launch(
                cache.A, grad_s, beta, cache.slot_begin, cache.slot_size,
                cache.eigvals, cache.eigvecs, cache.penalty_slots, active,
                lmda, alpha, s.tol, configs.dbeta_tol, s.newton_tol,
                s.newton_max_iters, s.max_iters, rsq)
            # the invariance: grad = v - A[:, screen] beta
            with matmul_precision():
                grad = s.v_dev - cache.A_cols @ beta_n
            abs_grad = abs_grad_kernel(
                grad, cache.cols_padded, beta_n, s._penalty_cols,
                s._group_cols, (1.0 - alpha) * min(lmda, 1e30))
            viol = abs_grad > lmda * alpha * self._penalty_groups_dev
            kkt = ~torch.any(viol & ~is_screen)
            h = torch.cat([info, kkt.to(info.dtype).reshape(1)]).tolist()
            rsq_n, iters, done = pin_info(h[:-1], grouped)
            accept = done and bool(h[-1])
            dev = rsq_n
            # the rdev rule in the problem's dtype, as the JAX scan has it
            early = (bool(s.early_exit) and accept and have_prev
                     and dt(dev) - dt(prev_dev) <= dt(s.rdev_tol) * dt(dev))
            stopped = (not accept) or early
            beta, active, rsq = beta_n, active_n, rsq_n
            if accept:
                prev_dev = dev
            have_prev = have_prev or accept
            emits.append((beta_n, rsq_n, accept, done))
            s.benchmark["cd_iters"].append(iters)
            s.benchmark["pin_caps"].append(cache.S_cap)
            if stopped:
                break
        if not emits[-1][3]:
            raise MaxCDsError(len(s.lmdas) + len(emits) - 1)

        n_proc = len(emits)
        n_acc = sum(e[2] for e in emits)
        betas_h = torch.stack([e[0] for e in emits]).cpu().numpy()
        active_h = active.cpu().numpy()
        s.screen_beta = betas_h[-1][:cache.S_val].copy()
        s.screen_is_active = active_h[:len(s.screen_set)].copy()
        s.rsq = rsq
        s.grad = grad
        s.abs_grad = abs_grad.cpu().numpy()
        s.lmda = float(lmdas[n_proc - 1])
        if record:
            # dry fits (lmda_max positioning) must not seed the early-exit
            # deviance comparison (the reference compares recorded
            # solutions only, solver_gaussian_cov.hpp:193)
            self._prev_dev, self._have_prev_dev = prev_dev, have_prev
            for i, (_, rsq_i, accept, _) in enumerate(emits):
                if accept:
                    self._append_beta(betas_h[i][:cache.S_val], cache.cols)
                    s.intercepts.append(0.0)
                    s.lmdas.append(float(lmdas[i]))
                    s.rsqs.append(float(rsq_i))
                    s.devs.append(float(rsq_i))
                    s.n_valid_solutions.append(True)
                    s.active_sizes.append(int(active_h.sum()))
                    s.screen_sizes.append(len(s.screen_set))
                else:
                    s.n_valid_solutions.append(False)
        early_stopped = stopped and emits[-1][2]
        s.benchmark["fit_screen"].append(sw.elapsed())
        return n_acc, early_stopped, n_acc == n_proc

    # ---- basil.solve_core's driver interface (any other A) ---- #

    def update_loss_null(self):
        pass

    def fit(self, lmda):
        s = self.s
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()
        beta0 = cache.pad_screen_values(s.screen_beta, s)
        active0 = cache.pad_group_bools(s.screen_is_active, s.device)
        # the screen gradient at the current beta: v_s - A_s beta_s
        with matmul_precision():
            grad_s = cache.v_s - cache.A @ beta0
        beta, _, active, rsq, iters, done = pin_cov_solve(
            cache.A, grad_s, beta0, cache.slot_begin, cache.slot_size,
            cache.eigvals, cache.eigvecs, cache.penalty_slots, active0,
            lmda, s.alpha, s.tol, configs.dbeta_tol, s.newton_tol,
            s.newton_max_iters, s.max_iters, s.rsq)
        s.benchmark["cd_iters"].append(iters)
        s.benchmark["pin_caps"].append(cache.S_cap)
        if not done:
            raise MaxCDsError()
        s.screen_beta = beta[:cache.S_val].cpu().numpy()
        s.screen_is_active = active[:len(s.screen_set)].cpu().numpy()
        s.rsq = float(rsq)
        return sw.elapsed()

    def update_invariance(self, lmda):
        s = self.s
        cache = s.ensure_screen_cache()
        s.lmda = lmda
        if cache.S_val:
            Ab = s.A.mul(torch.as_tensor(cache.cols, device=s.device),
                         torch.as_tensor(s.screen_beta, dtype=s.torch_dtype,
                                         device=s.device))
            s.grad = s.v_dev - Ab
        else:
            s.grad = s.v_dev.clone()
        s.update_abs_grad(lmda)

    def kkt(self, lmda) -> bool:
        """Reference solver_base.hpp:410-433."""
        s = self.s
        is_screen = np.zeros(len(s.groups), bool)
        is_screen[s.screen_set] = True
        viol = s.abs_grad > lmda * s.alpha * s.penalty
        return not bool(np.any(viol & ~is_screen))

    def update_solutions(self, lmda):
        s = self.s
        cache = s.ensure_screen_cache()
        self._append_beta(s.screen_beta, cache.cols)
        s.intercepts.append(0.0)
        s.lmdas.append(float(lmda))
        s.rsqs.append(float(s.rsq))
        s.devs.append(float(s.rsq))


def gaussian_cov(
    A,
    v,
    *,
    constraints=None,
    groups=None,
    alpha: float = 1.0,
    penalty=None,
    lmda_path=None,
    max_iters: int = int(1e5),
    tol: float = 1e-7,
    rdev_tol: float = 1e-3,
    newton_tol: float = 1e-12,
    newton_max_iters: int = 1000,
    n_threads: int = 1,
    early_exit: bool = True,
    screen_rule: str = "pivot",
    min_ratio: float = 1e-2,
    lmda_path_size: int = 100,
    max_screen_size: int = None,
    max_active_size: int = None,
    pivot_subset_ratio: float = 0.1,
    pivot_subset_min: int = 1,
    pivot_slack_ratio: float = 1.25,
    check_state: bool = False,
    progress_bar: bool = False,
    warm_start=None,
    exit_cond=None,
    device=None,
):
    """Covariance-method group elastic net (reference solver.py:39).

    ``A`` a covariance matrix of the port (``matrix.dense(...,
    method="cov")``, ``eager_cov``, ``lazy_cov``, ``block_diag(...,
    method="cov")``, ``sparse(..., method="cov")``) or a (p, p) array,
    which becomes a dense one on ``device`` (default ``"cuda"``;
    ``device="cpu"`` for the CPU).  ``intercepts`` are all 0 and ``devs``
    are the ``rsqs``.  Accepted for the JAX package's signature and
    ignored: ``n_threads`` and ``progress_bar``.  ``check_state=True``
    audits the finished state (``state.check_state``); constraints raise
    ``NotImplementedError`` until they are ported (ROADMAP.md:
    constraints)."""
    from . import finalize_state

    screen_rule = types.screen_rule(screen_rule)
    if constraints is not None and any(c is not None for c in constraints):
        raise NotImplementedError(
            "constraints are not ported yet (ROADMAP.md: constraints)")

    if not isinstance(A, matrix_mod.MatrixCovBase):
        if isinstance(A, matrix_mod.MatrixNaiveBase):
            raise TypeError(
                "gaussian_cov expects a covariance matrix; got a naive "
                f"(n x p) matrix {type(A).__name__}. Construct it with "
                "method='cov' (e.g. matrix.block_diag(mats, method='cov')).")
        A = matrix_mod.dense(A, method="cov", device=device)
    elif device is not None and resolve_device(device) != A.device:
        raise ValueError(f"A lives on {A.device}, but device="
                         f"{str(device)!r} was asked")
    dtype = np.dtype(A.dtype)
    p = A.cols()
    v = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v, dtype)

    if lmda_path is not None:
        lmda_path = np.array(np.flip(np.sort(lmda_path)), dtype=float)

    if groups is None:
        groups = np.arange(p, dtype=int)
    groups = np.asarray(groups, int)
    group_sizes = np.diff(np.concatenate([groups, [p]])).astype(int)
    G = len(groups)
    if penalty is None:
        penalty = np.sqrt(group_sizes).astype(float)
    else:
        penalty = np.asarray(penalty, float)

    if warm_start is None:
        if p + int(group_sizes.max()) <= configs.screen_all_max:
            # a small problem: screen every group up front
            screen_set = np.arange(G)
        else:
            screen_set = np.arange(G)[(penalty <= 0) | (alpha <= 0)]
        gs = group_sizes[screen_set]
        screen_begins = np.concatenate([[0], np.cumsum(gs)])[:-1].astype(int)
        screen_beta = np.zeros(int(gs.sum()), dtype)
        screen_is_active = (penalty[screen_set] <= 0) | (alpha <= 0)
        lmda = np.inf
        lmda_max = None
        rsq = 0.0
    else:
        screen_set = np.asarray(warm_start.screen_set)
        screen_begins = np.asarray(warm_start.screen_begins)
        screen_beta = np.asarray(warm_start.screen_beta)
        screen_is_active = np.asarray(warm_start.screen_is_active)
        lmda = warm_start.lmda
        lmda_max = warm_start.lmda_max
        rsq = warm_start.rsq

    state = GaussianCovState(
        A=A, v=v, X=None, groups=groups, group_sizes=group_sizes,
        alpha=float(alpha), penalty=penalty, intercept=False, dtype=dtype,
        device=A.device, n=0, p=p,
        max_iters=int(max_iters), tol=float(tol), rdev_tol=float(rdev_tol),
        newton_tol=float(newton_tol), newton_max_iters=int(newton_max_iters),
        early_exit=bool(early_exit), min_ratio=float(min_ratio),
        lmda_path_size=int(lmda_path_size), max_screen_size=max_screen_size,
        max_active_size=max_active_size,
        pivot_subset_ratio=float(pivot_subset_ratio),
        pivot_subset_min=int(pivot_subset_min),
        pivot_slack_ratio=float(pivot_slack_ratio),
        screen_rule=screen_rule, lmda_path=lmda_path,
        setup_lmda_path=lmda_path is None,
        screen_set=screen_set, screen_begins=screen_begins,
        screen_beta=screen_beta, screen_is_active=screen_is_active,
        lmda=lmda, lmda_max=lmda_max, setup_lmda_max=lmda_max is None,
        rsq=rsq,
    )

    driver = GaussianCovDriver(state)
    driver.update_invariance(
        min(state.lmda, 1e30) if np.isfinite(state.lmda) else 1e30)

    try:
        if isinstance(A, matrix_mod.MatrixCovDense):
            chunked_path(driver, exit_cond)
        else:
            solve_core(state, driver, progress_bar=False,
                       exit_cond=exit_cond, early_exit_fn=early_exit_cov)
    except Exception as exc:  # a valid partial state (py_state.cpp:83-89)
        import traceback

        state.error = str(exc)
        logger.error(f"gaussian_cov: {exc}\n{traceback.format_exc()}")
    state = finalize_state(state)
    if check_state:
        from ..state import check_state as _check

        _check(state)
    return state
