"""Solver entry point: ``grpnet``, the single-response gaussian path.

Counterpart of ``adelie_tpu/solver/__init__.py``.  A matrix in device
memory runs ``GaussianNaiveDriver``, a host-streamed SNP matrix
``StreamedGaussianDriver``.  GLMs other than the gaussian, multi-response
and constrained inputs are later slices of ROADMAP.md and raise
``NotImplementedError``.
"""

import traceback

import numpy as np
import scipy.sparse as sp
import torch

from .. import matrix as matrix_mod
from ..configs import configs
from ..device import resolve_device
from ..logger import logger
from ..utils import types
from .gaussian import GaussianNaiveDriver, GaussianNaiveState
from .streamed import StreamedGaussianDriver

__all__ = ["grpnet", "finalize_state"]


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
    """Group elastic net path, gaussian loss (reference solver.py:354-958).

    Minimizes  1/2 sum_i w_i (y_i - x_i^T b - b0)^2 + lmda sum_g p_g
    (alpha ||b_g||_2 + (1-alpha)/2 ||b_g||_2^2)  over a decreasing lambda
    path with BASIL screening.

    ``device``: where every tensor of the fit lives; ``None`` means the
    device of a matrix ``X`` or, for an array, ``"cuda"``, which raises
    without a GPU: pass ``device="cpu"`` to fit on the CPU.

    ``groups`` (the first column of each group, ascending; default one
    column a group) may give groups of any size: each group's update is
    the block update of ``bcd.newton_solver`` in its eigenbasis, to
    ``newton_tol`` within ``newton_max_iters`` steps.

    Accepted for the JAX package's signature and ignored: ``n_threads``
    and ``progress_bar``; ``irls_max_iters`` and ``irls_tol`` until GLMs
    are ported (ROADMAP.md queue 1 item 3).  ``check_state=True``
    raises ``NotImplementedError`` until the state checks are ported
    (ROADMAP.md queue 1 item 7).
    """
    if check_state:
        raise NotImplementedError(
            "check_state=True is not ported yet (ROADMAP.md queue 1 item 7: "
            "the model-selection layer)")
    screen_rule = types.screen_rule(screen_rule)
    if glm.is_multi:
        raise NotImplementedError(
            "multi-response GLMs are not ported yet (ROADMAP.md queue 5)")
    if not (glm.name == "gaussian" and glm.opt):
        raise NotImplementedError(
            f"glm {glm.name!r} is not ported yet (ROADMAP.md queue 5: GLMs)")
    if constraints is not None and any(c is not None for c in constraints):
        raise NotImplementedError(
            "constraints are not ported yet (ROADMAP.md queue 7)")

    X = _as_matrix(X, device)
    streaming = getattr(X, "is_streaming", False)
    dev = X.device
    dtype = X.dtype
    tdtype = X.torch_dtype
    n, p = X.rows(), X.cols()

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
    group_sizes = np.diff(np.concatenate([groups, [p]])).astype(int)
    G = len(groups)
    if penalty is None:
        penalty = np.sqrt(group_sizes).astype(float)
    else:
        penalty = np.asarray(penalty, float)

    common = dict(
        X=X, groups=groups, group_sizes=group_sizes, alpha=float(alpha),
        penalty=penalty, intercept=bool(intercept), dtype=dtype, n=n, p=p,
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

    like = dict(dtype=tdtype, device=dev)
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
    driver = (StreamedGaussianDriver if streaming
              else GaussianNaiveDriver)(state)

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

    return finalize_state(state)


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
