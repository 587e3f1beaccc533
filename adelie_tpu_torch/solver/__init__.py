"""Solver entry point: ``grpnet``.

Counterpart of ``adelie_tpu/solver/__init__.py``.  The gaussian loss with
``opt=True`` runs in covariance form: ``GaussianNaiveDriver`` on a matrix
in device memory, ``StreamedGaussianDriver`` on a host-streamed SNP
matrix.  Every other GLM (binomial, poisson, cox, a user's ``GlmBase``, the
gaussian with ``opt=False``) runs the IRLS path: ``GlmNaiveDriver`` or
``StreamedGlmDriver``.  A multi-response GLM (``multigaussian``,
``multinomial``) becomes one flattened problem on ``X (x) I_K``
(``solver/multi.py``) that the same drivers run.  Constraints are a later
slice of ROADMAP.md and raise ``NotImplementedError``.

The covariance method (``gaussian_cov``, ``_cov.py``) runs the same pin
solves on blocks of a covariance matrix; the standalone solvers are
``bvls`` and ``pinball`` (``_bvls.py``, ``_pinball.py``: K7 of
``screened_cd_kernels``) and ``css_cov`` (``_css.py``).
"""

import traceback

import numpy as np
import scipy.sparse as sp
import torch

from .. import matrix as matrix_mod
from ..matrix.wrappers import refuse_wrapped_stream
from ..configs import configs
from ..device import resolve_device
from ..logger import logger
from ..utils import types
from ._bvls import bvls
from ._cov import gaussian_cov
from ._css import css_cov
from ._pinball import pinball
from .gaussian import GaussianNaiveDriver, GaussianNaiveState
from .glm_driver import GlmNaiveDriver, GlmNaiveState
from .multi import build_multi_problem, finalize_multi
from .streamed import StreamedGaussianDriver, StreamedGlmDriver

__all__ = ["bvls", "css_cov", "finalize_state", "gaussian_cov", "grpnet",
           "pinball"]


def _as_matrix(X, device):
    if isinstance(X, matrix_mod.MatrixNaiveBase):
        if device is not None and resolve_device(device) != X.device:
            raise ValueError(
                f"X lives on {X.device}, but device={str(device)!r} was asked"
            )
        return X
    return matrix_mod.dense(X, device=device)


def grpnet(
    X,
    glm,
    *,
    constraints=None,
    groups=None,
    alpha: float = 1.0,
    penalty=None,
    offsets=None,
    lmda_path=None,
    irls_max_iters: int = int(1e4),
    irls_tol: float = 1e-7,
    max_iters: int = int(1e5),
    tol: float = 1e-7,
    adev_tol: float = 0.9,
    ddev_tol: float = 0.0,
    newton_tol: float = 1e-12,
    newton_max_iters: int = 1000,
    n_threads: int = 1,
    early_exit: bool = True,
    intercept: bool = True,
    screen_rule: str = "pivot",
    min_ratio: float = 1e-2,
    lmda_path_size: int = 100,
    max_screen_size: int = None,
    max_active_size: int = None,
    pivot_subset_ratio: float = 0.1,
    pivot_subset_min: int = 1,
    pivot_slack_ratio: float = 1.25,
    screen_cap_active_mult: float = None,
    check_state: bool = False,
    progress_bar: bool = False,
    warm_start=None,
    exit_cond=None,
    device=None,
):
    """Group elastic net path (reference solver.py:354-958).

    Minimizes  loss(X b + b0 + offsets) + lmda sum_g p_g (alpha ||b_g||_2 +
    (1-alpha)/2 ||b_g||_2^2)  over a decreasing lambda path with BASIL
    screening, for the loss of ``glm``: gaussian in covariance form, any
    other single-response GLM by IRLS (``irls_max_iters`` iterations to
    ``irls_tol`` a lambda).  A multi-response GLM (``y`` (n, K)) fits one
    coefficient a class for every column, a group of g columns penalized as
    one group of g K coefficients, and K intercepts: ``betas`` (L, p K),
    column ``j K + k`` for class k, and ``intercepts`` (L, K).

    ``device``: where every tensor of the fit lives; ``None`` means the
    device of a matrix ``X`` or, for an array, ``"cuda"``, which raises
    without a GPU: pass ``device="cpu"`` to fit on the CPU.

    ``groups`` (the first column of each group, ascending; default one
    column a group) may give groups of any size: each group's update is
    the block update of ``bcd.newton_solver`` in its eigenbasis, to
    ``newton_tol`` within ``newton_max_iters`` steps.

    ``check_state=True`` audits the finished state with
    ``state.check_state`` (an ``AssertionError`` names what failed).  A
    wrapper of a host-streamed matrix but a column concatenation or
    ``matrix.kronecker_eye`` raises ``NotImplementedError``, as in the JAX
    package.  Accepted for the JAX package's signature and ignored:
    ``n_threads`` and ``progress_bar``.
    """
    screen_rule = types.screen_rule(screen_rule)
    if constraints is not None and any(c is not None for c in constraints):
        raise NotImplementedError(
            "constraints are not ported yet (ROADMAP.md: constraints)")
    is_gaussian_opt = glm.name in ("gaussian", "multigaussian") and glm.opt

    X = _as_matrix(X, device)
    refuse_wrapped_stream(X)
    if (not glm.is_multi and intercept
            and isinstance(X, matrix_mod.MatrixNaiveKroneckerEye)):
        # its screen block forms no centered Gram: the multi-response
        # problem carries its intercepts as columns
        raise NotImplementedError(
            "a single-response fit on a Kronecker matrix "
            "(matrix.kronecker_eye) with intercept=True is not ported: "
            "pass intercept=False with a column of ones in X, or fit a "
            "multi-response GLM")
    streaming = getattr(X, "is_streaming", False)
    dev = X.device
    dtype = X.dtype
    p = X.cols()

    y_arr = glm.y.cpu().numpy()
    if offsets is None:
        offsets_np = np.zeros(y_arr.shape, dtype)
    else:
        offsets_np = np.asarray(offsets, dtype)
        if offsets_np.shape != y_arr.shape:
            raise RuntimeError("offsets must be same shape as y if not None.")

    if lmda_path is not None:
        lmda_path = np.array(np.flip(np.sort(lmda_path)), dtype=float)

    if groups is None:
        groups = np.arange(p, dtype=int)
    groups = np.asarray(groups, int)

    common = dict(
        alpha=float(alpha), intercept=bool(intercept), dtype=dtype,
        device=dev, max_iters=int(max_iters), tol=float(tol),
        newton_tol=float(newton_tol), newton_max_iters=int(newton_max_iters),
        adev_tol=float(adev_tol), ddev_tol=float(ddev_tol),
        early_exit=bool(early_exit), min_ratio=float(min_ratio),
        lmda_path_size=int(lmda_path_size),
        max_screen_size=max_screen_size, max_active_size=max_active_size,
        pivot_subset_ratio=float(pivot_subset_ratio),
        pivot_subset_min=int(pivot_subset_min),
        pivot_slack_ratio=float(pivot_slack_ratio),
        screen_cap_active_mult=(None if screen_cap_active_mult is None
                                else float(screen_cap_active_mult)),
        screen_rule=screen_rule, lmda_path=lmda_path,
        setup_lmda_path=lmda_path is None,
    )

    if glm.is_multi:
        state, driver = build_multi_problem(
            X, glm, groups, penalty, offsets_np, warm_start, common,
            is_gaussian_opt, irls_max_iters, irls_tol)
    else:
        state, driver = _single_problem(
            X, glm, groups, penalty, y_arr, offsets_np, warm_start,
            streaming, common, is_gaussian_opt, irls_max_iters, irls_tol)

    if warm_start is not None:
        # restore the KKT invariance quantities carried by the warm start
        state.abs_grad = getattr(warm_start, "abs_grad", None)
        if state.abs_grad is None and np.isfinite(state.lmda):
            state.update_abs_grad(state.lmda)
        elif state.abs_grad is not None:
            state.abs_grad = np.asarray(state.abs_grad)

    try:
        driver.solve_path(progress_bar=progress_bar, exit_cond=exit_cond)
    except Exception as exc:  # return a valid partial state (py_state.cpp:83-89)
        state.error = str(exc)
        logger.error(f"solver: {exc}\n{traceback.format_exc()}")

    state = finalize_state(state)
    if glm.is_multi:
        state = finalize_multi(state)
    if check_state:
        from ..state import check_state as _check

        _check(state)
    return state


def _single_problem(X, glm, groups, penalty, y_arr, offsets_np, warm_start,
                    streaming, common, is_gaussian_opt, irls_max_iters,
                    irls_tol):
    """A single-response problem's state and driver."""
    n, p = X.rows(), X.cols()
    dtype = np.dtype(X.dtype)
    alpha = common["alpha"]
    group_sizes = np.diff(np.concatenate([groups, [p]])).astype(int)
    G = len(groups)
    if penalty is None:
        penalty = np.sqrt(group_sizes).astype(float)
    else:
        penalty = np.asarray(penalty, float)
    common.update(X=X, groups=groups, group_sizes=group_sizes,
                  penalty=penalty, n=n, p=p)

    if warm_start is None:
        if p + int(group_sizes.max()) <= configs.screen_all_max:
            # small problem: the whole Gram fits K1, so screen every group
            # up front (no KKT retries)
            screen_set = np.arange(G)
        else:
            screen_set = np.arange(G)[(penalty <= 0) | (alpha <= 0)]
        gs = group_sizes[screen_set]
        screen_begins = np.concatenate([[0], np.cumsum(gs)])[:-1].astype(int)
        screen_beta = np.zeros(int(gs.sum()), dtype)
        # unpenalized groups start active (reference solver.py:856-862)
        screen_is_active = (penalty[screen_set] <= 0) | (alpha <= 0)
        lmda = np.inf
        lmda_max = None
    else:
        screen_set = np.asarray(warm_start.screen_set)
        screen_begins = np.asarray(warm_start.screen_begins)
        screen_beta = np.asarray(warm_start.screen_beta)
        screen_is_active = np.asarray(warm_start.screen_is_active)
        lmda = warm_start.lmda
        lmda_max = warm_start.lmda_max
        if (
            (len(screen_set) and screen_set.max() >= G)
            or len(screen_beta) != int(group_sizes[screen_set].sum())
        ):
            raise ValueError(
                "warm_start is inconsistent with the requested groups: "
                f"it was fitted with a different grouping (G={G}, "
                f"screen value size {len(screen_beta)})."
            )

    common.update(
        screen_set=screen_set, screen_begins=screen_begins,
        screen_beta=screen_beta, screen_is_active=screen_is_active,
        lmda=lmda, lmda_max=lmda_max, setup_lmda_max=lmda_max is None,
    )

    like = dict(dtype=X.torch_dtype, device=X.device)
    if is_gaussian_opt:
        state = _gaussian_state(X, glm, y_arr, offsets_np, warm_start,
                                streaming, like, common)
        driver = (StreamedGaussianDriver if streaming
                  else GaussianNaiveDriver)(state)
    else:
        state = _glm_state(X, glm, offsets_np, warm_start, like, common,
                           irls_max_iters, irls_tol)
        driver = (StreamedGlmDriver if streaming else GlmNaiveDriver)(state)
    return state, driver


def _gaussian_state(X, glm, y_arr, offsets_np, warm_start, streaming, like,
                    common):
    n = X.rows()
    intercept = common["intercept"]
    y = torch.as_tensor(y_arr, **like)
    weights = glm.weights.to(**like)
    offs = torch.as_tensor(offsets_np, **like)
    if warm_start is None:
        ones = torch.ones(n, **like)
        y_off = y - offs
        y_mean = float(weights @ y_off)
        yc = y_off - y_mean if intercept else y_off
        y_var = float(weights @ (yc * yc))
        resid = yc
        resid_sum = float(weights @ resid)
        if streaming:
            # one pass over the host-streamed bytes for both full-p setup
            # products
            both = X.mul_many(torch.stack([weights * ones, weights * resid]))
            X_means, grad = both[:, 0].contiguous(), both[:, 1].contiguous()
        else:
            X_means = X.mul(ones, weights)
            grad = X.mul(resid, weights)
        rsq = 0.0
    else:
        X_means = torch.as_tensor(warm_start.X_means, **like)
        y_mean = float(warm_start.y_mean)
        y_var = float(warm_start.y_var)
        rsq = float(warm_start.rsq)
        resid = torch.as_tensor(warm_start.resid, **like)
        resid_sum = float(warm_start.resid_sum)
        grad = torch.as_tensor(warm_start.grad, **like)
    state = GaussianNaiveState(
        weights=weights, X_means=X_means, y_mean=y_mean, y_var=y_var,
        rsq=rsq, resid=resid, resid_sum=resid_sum, **common,
    )
    state.grad = grad
    return state


def _glm_state(X, glm, offsets_np, warm_start, like, common, irls_max_iters,
               irls_tol):
    """The IRLS path's state (reference solver/__init__.py:268-304): eta
    starts at the offsets, ``loss_null`` comes from the driver."""
    glm = glm.to(like["device"], common["dtype"])
    offs = torch.as_tensor(offsets_np.ravel(), **like)
    if warm_start is None:
        eta = offs
        resid = glm.gradient(eta)
        grad = X.mul(resid, torch.ones(X.rows(), **like))
        loss_null = None
        loss_full = float(glm.loss_full())
        beta0 = 0.0
    else:
        eta = torch.as_tensor(warm_start.eta, **like)
        resid = torch.as_tensor(warm_start.resid, **like)
        grad = torch.as_tensor(warm_start.grad, **like)
        loss_null = float(warm_start.loss_null)
        loss_full = float(warm_start.loss_full)
        beta0 = float(warm_start.beta0)
    state = GlmNaiveState(
        glm=glm, offsets=offs, beta0=beta0, eta=eta, resid=resid,
        loss_null=loss_null, loss_full=loss_full,
        irls_max_iters=int(irls_max_iters), irls_tol=float(irls_tol),
        **common,
    )
    state.grad = grad
    return state


def finalize_state(state):
    """Convert the output lists to arrays (reference state.py)."""
    if len(state.betas):
        state.betas = sp.vstack(state.betas).tocsr()
    else:
        state.betas = sp.csr_matrix((0, state.p))
    state.intercepts = np.asarray(state.intercepts)
    state.lmdas = np.asarray(state.lmdas)
    state.devs = np.asarray(state.devs)
    return state
