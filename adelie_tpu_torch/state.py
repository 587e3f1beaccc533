"""Solver states: the factories, the state audit, warm starts.

Counterpart of ``adelie_tpu/state.py``.  The factories mirror the
reference's state constructors and return an object whose ``solve()``
runs the solver (``grpnet``, ``gaussian_cov``, ``bvls``, ``pinball``,
``css_cov``); the pin states ``gaussian_pin_naive`` and
``gaussian_pin_cov`` fit every lambda of a path on a screen set the
caller fixes, with the pin kernels K1, K2 and K6 and no KKT check.
``check_state`` audits a state's invariants (reference ``check()``).

The system has no weights: what a fit carries across calls is the warm
start ``grpnet`` accepts as ``warm_start``.  ``state_from_numpy`` builds
it from plain numpy arrays, for example those of a state of the JAX
package (``np.asarray`` of each field), so the port never imports that
package; ``save_state`` writes a state's warm-start fields to an ``.npz``
and ``load_warm_start`` reads one, written by either package, back as a
``WarmStart``.
"""

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from . import glm as glm_mod
from . import matrix as matrix_mod
from .device import resolve_device
from .logger import logger
from .utils import host as _host

__all__ = [
    "WarmStart",
    "base",
    "bvls",
    "check_state",
    "css_cov",
    "gaussian_cov",
    "gaussian_naive",
    "gaussian_pin_cov",
    "gaussian_pin_naive",
    "glm_naive",
    "load_warm_start",
    "multigaussian_naive",
    "multiglm_naive",
    "pinball",
    "save_state",
    "state_from_numpy",
]


@dataclass
class WarmStart:
    """The fields a fit carries over.  Every fit: the screen set and its
    coefficients, ``lmda``, ``lmda_max``, ``resid``, ``grad`` and
    ``abs_grad``.  The gaussian path also ``X_means``, ``y_mean``,
    ``y_var``, ``rsq`` and ``resid_sum``; a GLM's IRLS path ``eta``,
    ``beta0``, ``loss_null`` and ``loss_full``.  A multi-response fit's
    fields are those of its flattened problem on ``X (x) I_K``: the
    residual, gradient and eta of length n K and p K, the screen over the
    flattened groups, whose first K coefficients are the per-class
    intercepts; it has no ``y_mean`` or ``beta0``."""

    screen_set: np.ndarray
    screen_begins: np.ndarray
    screen_beta: np.ndarray
    screen_is_active: np.ndarray
    lmda: float
    lmda_max: float
    resid: torch.Tensor
    grad: torch.Tensor
    abs_grad: np.ndarray
    X_means: torch.Tensor = None
    y_mean: float = None
    y_var: float = None
    rsq: float = None
    resid_sum: float = None
    eta: torch.Tensor = None
    beta0: float = None
    loss_null: float = None
    loss_full: float = None


_VECTORS = ("resid", "grad", "X_means", "eta")
_SCALARS = ("lmda", "lmda_max", "y_mean", "y_var", "rsq", "resid_sum",
            "beta0", "loss_null", "loss_full")


def state_from_numpy(d, device=None) -> WarmStart:
    """A warm start from a dict of numpy arrays with the keys
    ``screen_set, screen_begins, screen_beta, screen_is_active, lmda,
    lmda_max, resid, grad, abs_grad`` and either the gaussian path's
    ``X_means, y_mean, y_var, rsq, resid_sum`` or a GLM's ``eta, beta0,
    loss_null, loss_full``.  The vectors (``X_means``, ``resid``, ``grad``,
    ``eta``) go to ``device`` (resolved as in ``grpnet``) in the dtype of
    ``screen_beta``."""
    device = resolve_device(device)
    dtype = np.asarray(d["screen_beta"]).dtype
    if dtype not in (np.float32, np.float64):
        dtype = np.dtype(np.float64)
    extra = {}
    for k in _VECTORS:
        if d.get(k) is not None:
            extra[k] = torch.as_tensor(np.array(d[k], dtype), device=device)
    for k in _SCALARS:
        if d.get(k) is not None:
            extra[k] = float(d[k])
    return WarmStart(
        screen_set=np.asarray(d["screen_set"], int),
        screen_begins=np.asarray(d["screen_begins"], int),
        screen_beta=np.asarray(d["screen_beta"], dtype),
        screen_is_active=np.asarray(d["screen_is_active"], bool),
        abs_grad=np.asarray(d["abs_grad"], np.float64),
        **extra,
    )


# --------------------------------------------------------------------------- #
# the state audit                                                              #
# --------------------------------------------------------------------------- #


def check_state(state, method: str = "assert"):
    """Audit solver-state invariants (reference state.py check(), e.g. the
    gaussian_pin validator at state.py:180-400), with the JAX package's
    failure messages; tensors on any device are read as numpy arrays.

    Validates, when the corresponding fields are present:

    * problem structure: groups strictly increasing from 0 with positive
      sizes tiling [0, p); penalty nonnegative of length G; alpha in
      [0, 1]; weights nonnegative summing to ~1;
    * screen bookkeeping: screen_set unique, in-range; screen_begins the
      cumulative sizes; screen_beta sized to the screened value count and
      finite; screen_is_active one flag per screen group;
    * invariance quantities: abs_grad (G,) finite and nonnegative; grad
      (p,) finite;
    * outputs: betas/lmdas/intercepts/devs lengths agree; lmdas strictly
      decreasing; devs at most 1 (but for the covariance method) and
      nondecreasing, to 1e-6; off-screen beta columns exactly zero;
    * screen/active consistency: a screened group carrying a nonzero
      coefficient is flagged active; screen_sizes and active_sizes one
      entry per solution, active <= screen, screen_sizes nondecreasing
      (BASIL only grows the screen set within a path);
    * duals (constrained paths): one record per solution, each of a
      constrained group and of its dual dimension;
    * benchmark fields: finite nonnegative timings and counters;
    * residual state: resid/rsq/resid_sum finite when present;
    * configuration sanity: tol/newton_tol positive, max sizes >= current.

    The port's drivers record one ``n_valid_solutions`` flag and at least
    one ``benchmark["cd_iters"]`` entry for every lambda they fit, a
    rejected (KKT-failed) fit included: the audit asks for one True flag
    and at least one ``cd_iters`` entry a solution.

    ``configs.debug_check_state = True`` runs this audit inside the
    streamed drivers after every certified chunk.
    """
    failures = []

    def ensure(cond, msg):
        if not cond:
            failures.append(msg)

    if not hasattr(state, "groups"):
        # the standalone solvers' states (BVLS, pinball, CSS)
        return _check_aux_state(state, method)

    # --- problem structure ---
    groups = np.asarray(state.groups)
    gsizes = np.asarray(state.group_sizes)
    G = len(groups)
    p = int(getattr(state, "p", groups[-1] + gsizes[-1] if G else 0))
    ensure(np.all(gsizes > 0), "group_sizes must be positive")
    ensure(np.array_equal(groups,
                          np.concatenate([[0], np.cumsum(gsizes)])[:-1]),
           "groups must tile [0, p) contiguously")
    ensure(G == 0 or int(groups[-1] + gsizes[-1]) == p,
           "groups/group_sizes must cover exactly p columns")
    penalty = np.asarray(getattr(state, "penalty", np.zeros(0)))
    if penalty.size:
        ensure(len(penalty) == G, "penalty must be (G,)")
        ensure(np.all(penalty >= 0), "penalty must be >= 0")
    alpha = getattr(state, "alpha", 1.0)
    ensure(0.0 <= float(alpha) <= 1.0, "alpha must be in [0, 1]")
    w = getattr(state, "weights", None)
    if w is not None:
        w = _host(w)
        ensure(np.all(w >= 0), "weights must be >= 0")
        ensure(abs(float(w.sum()) - 1.0) < 1e-6, "weights must sum to 1")

    # --- configs ---
    ensure(float(getattr(state, "tol", 1.0)) > 0, "tol must be > 0")
    ensure(float(getattr(state, "newton_tol", 1.0)) >= 0,
           "newton_tol must be >= 0")
    mss = getattr(state, "max_screen_size", None)
    if mss is not None:
        ensure(len(state.screen_set) <= mss,
               "screen_set exceeds max_screen_size")

    # --- screen bookkeeping ---
    ss = np.asarray(state.screen_set)
    ensure(len(np.unique(ss)) == len(ss), "screen_set must be unique")
    ensure(np.all((ss >= 0) & (ss < G)), "screen_set out of range")
    in_range = ss[(ss >= 0) & (ss < G)]
    gs = gsizes[in_range] if len(in_range) else np.zeros(0, int)
    begins = (np.concatenate([[0], np.cumsum(gs)])[:-1] if len(gs)
              else np.zeros(0, int))
    ensure(np.array_equal(np.asarray(state.screen_begins), begins),
           "screen_begins inconsistent with screen_set")
    sbeta = _host(state.screen_beta)
    ensure(len(sbeta) == int(gs.sum()), "screen_beta size inconsistent")
    ensure(np.all(np.isfinite(sbeta)), "screen_beta must be finite")
    ensure(len(state.screen_is_active) == len(ss),
           "screen_is_active size inconsistent")

    # --- invariance quantities ---
    if getattr(state, "abs_grad", None) is not None:
        ag = _host(state.abs_grad)
        ensure(len(ag) == G, "abs_grad must be (G,)")
        ensure(np.all(np.isfinite(ag)), "abs_grad must be finite")
        ensure(np.all(ag >= 0), "abs_grad must be >= 0")
    grad = getattr(state, "grad", None)
    if grad is not None:
        ga = _host(grad)
        ensure(ga.shape == (p,), "grad must be (p,)")
        ensure(np.all(np.isfinite(ga)), "grad must be finite")

    # --- outputs ---
    n_sols = (len(state.betas) if isinstance(state.betas, list)
              else state.betas.shape[0])
    lmdas = np.asarray(state.lmdas, float)
    ensure(n_sols == len(lmdas), "betas/lmdas length mismatch")
    intercepts = np.asarray(getattr(state, "intercepts", np.zeros(n_sols)))
    ensure(len(intercepts) == n_sols, "intercepts/betas length mismatch")
    if len(lmdas) > 1:
        ensure(np.all(np.diff(lmdas) < 0), "lmdas must be strictly decreasing")
    devs = np.asarray(getattr(state, "devs", np.zeros(0)), float)
    if devs.size:
        ensure(len(devs) == n_sols, "devs/betas length mismatch")
        # the covariance method (a state with A) scales devs by no
        # y-variance, so they may pass 1 (reference rdev semantics)
        if not hasattr(state, "A"):
            ensure(np.all(devs <= 1.0 + 1e-6), "devs must be <= 1")
        ensure(np.all(np.diff(devs) >= -1e-6), "devs must be nondecreasing")
    if (not isinstance(state.betas, list) and n_sols and len(ss) < G
            and state.betas.shape[1] == p):
        # off-screen columns must be exactly zero (a multi-response state
        # leaves its intercept columns out of betas, so there
        # betas.shape[1] < p)
        in_screen = np.zeros(p, bool)
        for g in in_range:
            in_screen[groups[g]:groups[g] + gsizes[g]] = True
        off = sp.csr_matrix(state.betas)[:, ~in_screen]
        ensure(off.nnz == 0, "nonzero coefficients outside the screen set")

    # --- screen/active consistency ---
    if len(ss) and len(sbeta) == int(gs.sum()):
        act = np.asarray(state.screen_is_active, bool)
        if len(act) == len(ss):
            for k in range(len(gs)):
                seg = sbeta[begins[k]:begins[k] + gs[k]]
                if np.any(seg != 0) and not bool(act[k]):
                    ensure(False, (
                        f"screened group {int(ss[k])} carries nonzero "
                        "coefficients but is not flagged active"))
                    break

    # --- per-solution bookkeeping ---
    for name in ("screen_sizes", "active_sizes"):
        vals = getattr(state, name, None)
        if vals is not None and len(vals):
            ensure(len(vals) == n_sols, f"{name}/betas length mismatch")
    nvs = getattr(state, "n_valid_solutions", None)
    if nvs is not None and len(nvs):
        ensure(int(np.sum(np.asarray(nvs, bool))) == n_sols,
               "n_valid_solutions/betas length mismatch")
    ssz_raw = getattr(state, "screen_sizes", None)
    ssz = np.asarray(ssz_raw if ssz_raw is not None else [], int)
    if ssz.size:
        ensure(np.all((ssz >= 0) & (ssz <= G)), "screen_sizes out of range")
        ensure(np.all(np.diff(ssz) >= 0),
               "screen_sizes must be nondecreasing within a path")
    asz_raw = getattr(state, "active_sizes", None)
    asz = np.asarray(asz_raw if asz_raw is not None else [], int)
    if asz.size and asz.size == ssz.size:
        ensure(np.all(asz <= ssz), "active_sizes must be <= screen_sizes")

    # --- duals (constrained paths) ---
    duals = getattr(state, "duals", None)
    cons = getattr(state, "constraints", None)
    if duals is not None:
        ensure(len(duals) == n_sols, "duals/betas length mismatch")
        for dd in duals:
            for g, mu in dd.items():
                g = int(g)
                has_c = (cons is not None and 0 <= g < len(cons)
                         and cons[g] is not None)
                ensure(has_c, f"dual recorded for unconstrained group {g}")
                mu = _host(mu)
                ensure(np.all(np.isfinite(mu)),
                       f"dual for group {g} must be finite")
                if has_c:
                    m = cons[g].duals
                    m = int(m() if callable(m) else m)
                    ensure(mu.size == m, (
                        f"dual for group {g} has size {mu.size}, "
                        f"constraint expects {m}"))

    # --- benchmark fields ---
    bm = getattr(state, "benchmark", None)
    if isinstance(bm, dict):
        for kf, vals in bm.items():
            flat = []
            for v in vals:
                flat.extend(np.ravel(_host(v)).tolist())
            arr = np.asarray(flat, float)
            ensure(np.all(np.isfinite(arr)) and np.all(arr >= 0),
                   f"benchmark[{kf!r}] entries must be finite and >= 0")
        ci = bm.get("cd_iters")
        if ci:
            ensure(len(ci) >= n_sols,
                   "benchmark['cd_iters'] must have one entry per solution")

    # --- residual state ---
    for name in ("rsq", "resid_sum"):
        v = getattr(state, name, None)
        if v is not None and np.ndim(_host(v)) == 0:
            ensure(np.isfinite(float(v)), f"{name} must be finite")
    lmda = getattr(state, "lmda", None)
    if lmda is not None and np.ndim(lmda) == 0:
        # +inf is the legal pre-fit sentinel (reference large_lmda)
        ensure(not np.isnan(float(lmda)), "lmda must not be NaN")
    resid = getattr(state, "resid", None)
    if resid is not None:
        ensure(bool(np.all(np.isfinite(_host(resid)))),
               "resid must be finite")

    return _report(failures, method)


def _report(failures, method):
    if failures:
        msg = "state check failed: " + "; ".join(failures)
        if method == "assert":
            raise AssertionError(msg)
        logger.warning(msg)
    return failures


def _check_aux_state(state, method: str = "assert"):
    """The audit of the standalone solvers' states (BVLS, pinball, CSS),
    whose fields differ from the path states': finite iterates,
    screen/active bookkeeping, the bounds (BVLS) and the subset (CSS)."""
    failures = []

    def ensure(cond, msg):
        if not cond:
            failures.append(msg)

    for name in ("beta", "resid", "grad"):
        v = getattr(state, name, None)
        if v is not None:
            ensure(bool(np.all(np.isfinite(_host(v).astype(float)))),
                   f"{name} must be finite")
    loss = getattr(state, "loss", None)
    if loss is not None and not isinstance(loss, str):
        ensure(np.isfinite(float(loss)), "loss must be finite")

    is_screen = getattr(state, "is_screen", None)
    ss = getattr(state, "screen_set", None)
    if is_screen is not None and ss is not None:
        is_screen = _host(is_screen).astype(bool)
        p = len(is_screen)
        ss = _host(ss).astype(int)
        ensure(len(np.unique(ss)) == len(ss), "screen_set must be unique")
        ok = (ss >= 0) & (ss < p)
        ensure(bool(np.all(ok)), "screen_set out of range")
        ensure(bool(np.all(is_screen[ss[ok]]))
               and int(is_screen.sum()) == len(ss),
               "is_screen inconsistent with screen_set")
        act = getattr(state, "active_set", None)
        is_act = getattr(state, "is_active", None)
        if act is not None and is_act is not None:
            act = _host(act).astype(int)
            is_act = _host(is_act).astype(bool)
            ok = (act >= 0) & (act < p)
            ensure(bool(np.all(ok)), "active_set out of range")
            ensure(bool(np.all(is_screen[act[ok]])),
                   "active_set must be a subset of the screen set")
            ensure(bool(np.all(is_act[act[ok]]))
                   and int(is_act.sum()) == len(act),
                   "is_active inconsistent with active_set")

    lower = getattr(state, "lower", None)
    upper = getattr(state, "upper", None)
    beta = getattr(state, "beta", None)
    if lower is not None and upper is not None:
        lower = _host(lower).astype(float)
        upper = _host(upper).astype(float)
        ensure(bool(np.all(lower <= upper)), "lower must be <= upper")
        if beta is not None:
            b = _host(beta).astype(float)
            ensure(bool(np.all((b >= lower - 1e-9) & (b <= upper + 1e-9))),
                   "beta violates the [lower, upper] bounds")

    subset = getattr(state, "subset", None)
    if subset is not None:
        S = _host(state.S)
        ensure(S.ndim == 2 and S.shape[0] == S.shape[1], "S must be square")
        subset = np.asarray(subset, int)
        ensure(len(np.unique(subset)) == len(subset), "subset must be unique")
        ensure(bool(np.all((subset >= 0) & (subset < S.shape[0]))),
               "subset out of range")
        n_sub = getattr(state, "subset_size", None)
        if n_sub:
            ensure(len(subset) == int(n_sub),
                   "subset length must equal subset_size")

    return _report(failures, method)


# --------------------------------------------------------------------------- #
# the factories                                                                #
# --------------------------------------------------------------------------- #


class _BoundState:
    """A state and the run that solves it (the reference's ``solve()``),
    with the state's fields as attributes."""

    def __init__(self, state, run):
        self._state = state
        self._run = run

    def __getattr__(self, name):
        return getattr(self._state, name)

    def check(self, method: str = "assert"):
        return check_state(self._state, method)

    def solve(self, progress_bar: bool = False, exit_cond=None):
        return self._run(progress_bar, exit_cond)


# the reference's names (reference state.py:79,179,401,723,1421): its
# audits live in a hierarchy of per-solver bases, here all in check_state
base = _BoundState
gaussian_pin_base = _BoundState
gaussian_pin_naive_base = _BoundState
gaussian_pin_cov_base = _BoundState
gaussian_naive_base = _BoundState


class _Solver:
    """A factory's state: ``solve()`` runs its solver on the arguments the
    factory was given; ``check(result)`` audits a result."""

    def __init__(self, run):
        self._run = run

    def solve(self, *args, **kwargs):
        return self._run(*args, **kwargs)

    @staticmethod
    def check(state, method="assert"):
        return check_state(state, method)


def _path_solver(X, glm, kwargs):
    """A ``grpnet`` state; a wrapped streamed ``X`` raises up front."""
    from .solver import grpnet

    matrix_mod.wrappers.refuse_wrapped_stream(X)

    def run(progress_bar=False, exit_cond=None):
        return grpnet(X, glm, progress_bar=progress_bar, exit_cond=exit_cond,
                      **kwargs)

    return _Solver(run)


def gaussian_naive(*, X, y=None, glm=None, weights=None, **kwargs):
    """Gaussian naive solver state (reference state.py:1677)."""
    if glm is None:
        glm = glm_mod.gaussian(np.asarray(y), weights)
    return _path_solver(X, glm, kwargs)


def glm_naive(*, X, glm, **kwargs):
    """GLM naive (IRLS) solver state (reference state.py:2407)."""
    return _path_solver(X, glm, kwargs)


def multigaussian_naive(*, X, y, weights=None, **kwargs):
    """Multi-response gaussian state (reference state.py multigaussian)."""
    return _path_solver(X, glm_mod.multigaussian(np.asarray(y), weights),
                        kwargs)


def multiglm_naive(*, X, glm, **kwargs):
    """Multi-response GLM state (reference state.py multiglm)."""
    return _path_solver(X, glm, kwargs)


def gaussian_cov(*, A, v, **kwargs):
    """Covariance-method solver state (reference state.py:1128)."""
    from .solver import gaussian_cov as solve

    return _Solver(lambda progress_bar=False, exit_cond=None: solve(
        A, v, progress_bar=progress_bar, exit_cond=exit_cond, **kwargs))


def bvls(*, X, y, lower, upper, **kwargs):
    """BVLS solver state (reference state.py bvls): K7 fits."""
    from .solver import bvls as solve

    return _Solver(lambda: solve(X, y, lower, upper, **kwargs))


def pinball(*, A, S, v, penalty_neg, penalty_pos, **kwargs):
    """Pinball solver state (reference state.py pinball): K7 fits."""
    from .solver import pinball as solve

    return _Solver(lambda: solve(A, S, v, penalty_neg, penalty_pos,
                                 **kwargs))


def css_cov(*, S, subset_size=None, **kwargs):
    """CSS solver state (reference state.py css_cov)."""
    from .solver import css_cov as solve

    return _Solver(lambda: solve(S, subset_size, **kwargs))


def _screen_values(groups, group_sizes, screen_set, dtype, screen_beta,
                   screen_is_active):
    """The fixed screen's begins, columns and starting values."""
    gs = group_sizes[screen_set]
    begins = (np.concatenate([[0], np.cumsum(gs)])[:-1].astype(int)
              if len(screen_set) else np.zeros(0, int))
    cols = (np.concatenate([np.arange(groups[g], groups[g] + group_sizes[g])
                            for g in screen_set]).astype(np.int64)
            if int(gs.sum()) else np.zeros(0, np.int64))
    beta = (np.zeros(len(cols), dtype) if screen_beta is None
            else np.asarray(_host(screen_beta), dtype))
    active = (np.ones(len(screen_set), bool) if screen_is_active is None
              else np.asarray(_host(screen_is_active), bool))
    return begins, cols, beta, active


def _groups_penalty(groups, penalty, p):
    groups = np.arange(p, dtype=int) if groups is None \
        else np.asarray(groups, int)
    group_sizes = np.diff(np.concatenate([groups, [p]])).astype(int)
    penalty = (np.sqrt(group_sizes).astype(float) if penalty is None
               else np.asarray(penalty, float))
    return groups, group_sizes, penalty


def _decreasing(lmda_path, name):
    if lmda_path is None:
        raise ValueError(f"{name} requires lmda_path")
    return np.array(np.flip(np.sort(np.asarray(lmda_path, float))))


def gaussian_pin_naive(
    *, X, y=None, groups=None, alpha: float = 1.0, penalty=None,
    weights=None, screen_set=None, lmda_path=None,
    resid=None, screen_beta=None, screen_is_active=None, rsq: float = 0.0,
    intercept: bool = True, max_iters: int = int(1e5), tol: float = 1e-7,
    newton_tol: float = 1e-12, newton_max_iters: int = 1000,
    y_or_resid=None, device=None, **kwargs,
):
    """Pin solver over a fixed screen set (reference state.py:1677
    ``gaussian_pin_naive`` / StateGaussianPinNaive).

    Unlike the path solver, the screen set never grows and no KKT check
    decides: every lambda of ``lmda_path`` is fitted on exactly the groups
    of ``screen_set`` (default: all groups), by the gaussian driver in pin
    mode, whose chunks launch K1 (q = 1, S <= 1024), K2 (past 1024) or K6
    (groups of size > 1) a lambda.  ``resid``/``screen_beta``/
    ``screen_is_active``/``rsq`` take a warm iterate whose invariants the
    caller keeps (reference py_state.cpp:481).  ``X`` must live in device
    memory: a host-streamed matrix raises ``NotImplementedError``, as in
    the JAX package.  An array ``X`` becomes a dense matrix on ``device``
    (default ``"cuda"``).
    """
    from .solver import _as_matrix, finalize_state
    from .solver.gaussian import GaussianNaiveDriver, GaussianNaiveState

    if y is None:
        y = y_or_resid
    X = _as_matrix(X, device)
    if getattr(X, "is_streaming", False):
        raise NotImplementedError(
            "gaussian_pin_naive takes a matrix in device memory, not a "
            "host-streamed one")
    dtype = np.dtype(X.dtype)
    n, p = X.rows(), X.cols()
    like = dict(dtype=X.torch_dtype, device=X.device)
    groups, group_sizes, penalty = _groups_penalty(groups, penalty, p)
    weights = (np.full(n, 1.0 / n) if weights is None
               else np.asarray(weights, float))
    weights = weights / weights.sum()
    screen_set = (np.arange(len(groups)) if screen_set is None
                  else np.asarray(screen_set, int))
    screen_begins, cols, screen_beta, screen_is_active = _screen_values(
        groups, group_sizes, screen_set, dtype, screen_beta,
        screen_is_active)
    lmda_path = _decreasing(lmda_path, "gaussian_pin_naive")

    w_dev = torch.as_tensor(weights, **like)
    y_dev = torch.as_tensor(y, **like)
    X_means = X.mul(torch.ones(n, **like), w_dev)
    y_mean = float(w_dev @ y_dev) if intercept else 0.0
    yc = y_dev - y_mean
    y_var = float(w_dev @ (yc * yc))
    if resid is None:
        resid = (yc - X.gather(torch.as_tensor(cols, device=X.device))
                 @ torch.as_tensor(screen_beta, **like)) if len(cols) else yc
    if not isinstance(resid, torch.Tensor):
        resid = np.array(resid, dtype)
    resid = torch.as_tensor(resid, **like)
    resid_sum = float(w_dev @ resid)

    state = GaussianNaiveState(
        X=X, groups=groups, group_sizes=group_sizes, alpha=float(alpha),
        penalty=penalty, intercept=bool(intercept), dtype=dtype,
        device=X.device, n=n, p=p, max_iters=int(max_iters), tol=float(tol),
        newton_tol=float(newton_tol), newton_max_iters=int(newton_max_iters),
        early_exit=False, setup_lmda_max=False, setup_lmda_path=False,
        lmda_path=lmda_path, lmda_max=float(lmda_path[0]),
        screen_set=screen_set, screen_begins=screen_begins,
        screen_beta=screen_beta, screen_is_active=screen_is_active,
        lmda=np.inf, weights=w_dev, X_means=X_means, y_mean=y_mean,
        y_var=y_var, rsq=float(rsq), resid=resid, resid_sum=resid_sum,
    )
    state.grad = X.mul(resid, w_dev)
    driver = GaussianNaiveDriver(state)
    driver.pin_mode = True

    def run(progress_bar=False, exit_cond=None):
        path = np.asarray(state.lmda_path, float)
        C = int(state.lmda_chunk)
        i = 0
        while i < len(path):
            n_acc, early, _ = driver._run_chunk(path[i:i + C], record=True)
            # pin mode accepts every processed lambda
            i += max(n_acc, 1)
            if early or (exit_cond and exit_cond(state)):
                break
        return finalize_state(state)

    return _BoundState(state, run)


class _PinCovState:
    """The result of ``gaussian_pin_cov``'s ``solve()``: the path's
    ``lmdas``, ``betas`` (scipy.sparse, (L, p)) and zero ``intercepts``,
    and the final iterate's ``screen_beta``, ``screen_is_active`` and
    ``rsq`` (reference StateGaussianPinCov members)."""

    def __init__(self, run, screen_set, screen_begins, groups, group_sizes):
        self._run = run
        self.screen_set = screen_set
        self.screen_begins = screen_begins
        self.groups = groups
        self.group_sizes = group_sizes
        self.lmdas = []
        self.betas = []
        self.intercepts = []
        self.error = ""

    def solve(self, progress_bar=False, exit_cond=None):
        return self._run(self)


def gaussian_pin_cov(*, A, v, groups=None, alpha: float = 1.0, penalty=None,
                     screen_set=None, lmda_path=None, screen_beta=None,
                     screen_is_active=None, max_iters: int = int(1e5),
                     tol: float = 1e-7, newton_tol: float = 1e-12,
                     newton_max_iters: int = 1000, device=None, **kwargs):
    """Covariance-form pin solver over a fixed screen set (reference
    state.py gaussian_pin_cov / StateGaussianPinCov): fit each lambda on
    exactly ``screen_set`` against the PSD matrix ``A`` and the linear term
    ``v``: one pin solve a lambda (K1, K2 or K6) on the screen's block of
    ``A``, which the covariance method's screen cache gathers once, from
    the screen gradient ``v_s - A_s beta``.  An array ``A`` becomes a dense
    covariance matrix on ``device`` (default ``"cuda"``)."""
    from .configs import configs, matmul_precision
    from .solver._cov import GaussianCovState
    from .solver.pin import pin_cov_solve

    if not isinstance(A, matrix_mod.MatrixCovBase):
        A = matrix_mod.dense(np.asarray(_host(A)), method="cov",
                             device=device)
    p = A.cols()
    dtype = np.dtype(A.dtype)
    groups, group_sizes, penalty = _groups_penalty(groups, penalty, p)
    screen_set = (np.arange(len(groups)) if screen_set is None
                  else np.asarray(screen_set, int))
    lmda_path = _decreasing(lmda_path, "gaussian_pin_cov")
    begins, cols, beta0, active0 = _screen_values(
        groups, group_sizes, screen_set, dtype, screen_beta,
        screen_is_active)
    cs = GaussianCovState(
        A=A, v=np.asarray(_host(v), np.float64).astype(dtype), X=None,
        groups=groups, group_sizes=group_sizes, alpha=float(alpha),
        penalty=penalty, intercept=False, dtype=dtype, device=A.device, n=0,
        p=p, screen_set=screen_set, screen_begins=begins, screen_beta=beta0,
        screen_is_active=active0, lmda_path=lmda_path)
    cache = cs.ensure_screen_cache()
    S_val = cache.S_val

    def run(out):
        beta = cache.pad_screen_values(beta0, cs)
        active = cache.pad_group_bools(active0, cs.device)
        rsq = 0.0
        rows = []
        for lm in lmda_path:
            with matmul_precision():
                grad_s = cache.v_s - cache.A @ beta
            beta, _, active, rsq, _, _ = pin_cov_solve(
                cache.A, grad_s, beta, cache.slot_begin, cache.slot_size,
                cache.eigvals, cache.eigvecs, cache.penalty_slots, active,
                float(lm), float(alpha), float(tol), configs.dbeta_tol,
                float(newton_tol), int(newton_max_iters), int(max_iters),
                rsq)
            rows.append(beta[:S_val])
        B = torch.stack(rows).cpu().numpy() if rows else \
            np.zeros((0, S_val), dtype)
        L = len(lmda_path)
        out.betas = sp.csr_matrix(
            (B.ravel(), (np.repeat(np.arange(L), S_val), np.tile(cols, L))),
            shape=(L, p))
        out.betas.eliminate_zeros()
        out.lmdas = np.asarray(lmda_path, float)
        out.intercepts = np.zeros(L)
        out.screen_beta = B[-1].copy() if L else beta0
        out.screen_is_active = active.cpu().numpy()[:len(screen_set)]
        out.rsq = float(rsq)
        return out

    return _PinCovState(run, screen_set, begins, groups, group_sizes)


# --------------------------------------------------------------------------- #
# checkpointing (beyond the reference, which keeps states in memory only)     #
# --------------------------------------------------------------------------- #

_WS_FIELDS = [
    "screen_set", "screen_begins", "screen_beta", "screen_is_active",
    "lmda", "lmda_max", "abs_grad",
]
_WS_GAUSSIAN = ["y_mean", "y_var", "rsq", "resid_sum"]
_WS_ARRAYS = ["resid", "grad", "X_means", "weights", "eta"]


def save_state(state, path):
    """Write the warm-start fields of a solved state to ``.npz`` (the JAX
    package's fields and layout, so either package reads the file back);
    ``grpnet(..., warm_start=load_warm_start(path))`` resumes the path."""
    out = {}
    for f in _WS_FIELDS + _WS_GAUSSIAN + _WS_ARRAYS + [
        "beta0", "loss_null", "loss_full",
    ]:
        v = getattr(state, f, None)
        if v is None:
            continue
        out[f] = _host(v)
    np.savez(path, **out)
    return path


def load_warm_start(path, device=None) -> WarmStart:
    """A ``WarmStart`` from an ``.npz`` that ``save_state`` of either
    package wrote (``state_from_numpy``: its vectors on ``device``,
    default ``"cuda"``)."""
    p = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
    with np.load(p, allow_pickle=False) as data:
        d = {k: data[k] for k in data.files}
    return state_from_numpy(d, device=device)
