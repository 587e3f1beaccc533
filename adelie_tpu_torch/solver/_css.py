"""Column subset selection by the covariance method (reference
solver.py:1274-1430, solver_css_cov.hpp).

Counterpart of ``adelie_tpu/solver/_css.py``, as float64 tensor operations
on the device of ``S`` (the JAX package's is numpy):

* greedy: from the empty set, add the column of largest score and
  residualize the covariance on it by a rank-1 downdate; the whole pass
  stays on the device;
* swapping: cycle through the subset's positions; for each, the residual
  covariance given the subset without it comes from a Cholesky factor of
  the subset's block (``cholesky_ex``) and a triangular solve, and the
  position takes the best-scoring candidate if it beats the column there.
  One host read a position carries its verdicts.

The scores (reference compute_*_scores, solver_css_cov.hpp:18-137) are
one vectorized pass over all candidates; the subset factor's is one
(p, p) pass where the JAX package loops over the candidates, with the
same ``inf`` and early-exit semantics.  Its sums add in another order than
numpy's, so a score within a few ulps of another may rank the other way.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..exceptions import SolverError
from ..utils import Stopwatch, types

_EPS = 1e-10


@dataclass
class StateCSSCov:
    """Result state (reference state/state_css_cov.hpp).  ``S`` is the
    float64 tensor on the device the solver ran on."""

    S: torch.Tensor = None
    subset_size: int = 0
    subset: np.ndarray = None
    method: str = "swapping"
    loss: str = "least_squares"
    max_iters: int = 1000
    n_threads: int = 1
    benchmark_init: float = 0.0
    total_time: float = 0.0


def _scores_least_squares(S_resid, in_subset):
    """out[j] = ||S_resid[:, j]||^2 / S_jj (0 if selected or S_jj <= 0)."""
    diag = torch.diagonal(S_resid)
    bad = in_subset | (diag <= 0)
    out = torch.where(
        bad, 0.0,
        (S_resid * S_resid).sum(dim=0) / torch.where(diag <= 0, 1.0, diag))
    return out, torch.zeros((), dtype=torch.bool, device=S_resid.device)


def _scores_subset_factor(S_resid, in_subset):
    """out[j] = -log S_jj - sum_{i not in T, i != j} log(S_ii - S_ij^2/S_jj)
    for every candidate j at once; ``inf`` (and an early exit) where
    S_jj <= 0 or a term's argument is <= eps; ``-inf`` for selected j."""
    p = S_resid.shape[0]
    diag = torch.diagonal(S_resid)
    free = ~in_subset
    pos = diag > 0
    safe = torch.where(pos, diag, 1.0)
    # R[i, j] = S_ii - S_ij^2 / S_jj
    R = diag[:, None] - S_resid * S_resid / safe[None, :]
    mask = free[:, None] & ~torch.eye(p, dtype=torch.bool,
                                      device=S_resid.device)
    small = (mask & (R <= _EPS)).any(dim=0)
    logs = torch.where(mask & (R > _EPS), torch.log(torch.where(
        R > _EPS, R, 1.0)), 0.0).sum(dim=0)
    inf = torch.full_like(diag, np.inf)
    out = torch.where(~pos | small, inf, -torch.log(safe) - logs)
    out = torch.where(free, out, -np.inf)
    return out, (free & (~pos | small)).any()


def _scores_min_det(S_resid, in_subset):
    diag = torch.diagonal(S_resid)
    out = -torch.clamp(diag, min=0.0)
    near = (~in_subset) & (out >= -_EPS)
    return torch.where(near, 0.0, out), near.any()


_SCORES = {"least_squares": _scores_least_squares,
           "subset_factor": _scores_subset_factor,
           "min_det": _scores_min_det}


def _downdate(S_resid, i):
    """Rank-1 residualization on column ``i`` (a 0-d device index;
    reference update_cov_resid_fwd); unchanged where S_ii <= 0."""
    i = i.reshape(1)
    col = S_resid.index_select(1, i).reshape(-1)
    S_ii = col.index_select(0, i).reshape(())
    down = S_resid - torch.outer(col, col) / torch.where(S_ii > 0, S_ii, 1.0)
    return torch.where(S_ii > 0, down, S_resid)


def _resid_given(S, subset):
    """Residual covariance ``S - S[:, T] S[T, T]^{-1} S[T, :]`` by a
    Cholesky factor, and a 0-d bool: the factor exists and its diagonal
    is above eps."""
    if len(subset) == 0:
        return S.clone(), torch.ones((), dtype=torch.bool, device=S.device)
    T = torch.as_tensor(np.asarray(subset, np.int64), device=S.device)
    L, info = torch.linalg.cholesky_ex(S[T][:, T])
    ok = (info == 0) & (torch.diagonal(L) > _EPS).all()
    B = torch.linalg.solve_triangular(L, S[T], upper=False)     # (k, p)
    return S - B.T @ B, ok


def _solve_greedy(S, subset_size, score):
    p = S.shape[0]
    S_resid = S.clone()
    in_subset = torch.zeros(p, dtype=torch.bool, device=S.device)
    subset = []
    for _ in range(int(subset_size)):
        scores, _ = score(S_resid, in_subset)
        i_star = torch.argmax(torch.where(in_subset, -np.inf, scores))
        subset.append(i_star)
        in_subset.index_fill_(0, i_star.reshape(1), True)
        S_resid = _downdate(S_resid, i_star)
    if not subset:
        return np.zeros(0, int)
    return torch.stack(subset).cpu().numpy().astype(int)


def _solve_swapping(S, subset, score, max_iters):
    p = S.shape[0]
    k = len(subset)
    if k <= 0 or k >= p:
        return np.asarray(subset, int)
    subset = [int(j) for j in subset]
    in_subset = torch.zeros(p, dtype=torch.bool, device=S.device)
    in_subset[torch.as_tensor(subset, device=S.device)] = True

    # the initial subset's columns are independent (reference :254-280)
    if not bool(_resid_given(S, subset)[1]):
        raise SolverError(
            "Initial subset are not linearly independent columns.")

    n_consec_keep = 0
    for _ in range(int(max_iters)):
        for jj in range(k):
            j = subset[jj]
            S_resid_U, ok = _resid_given(S, subset[:jj] + subset[jj + 1:])
            in_subset[j] = False
            scores, early = score(S_resid_U, in_subset)
            j_star = torch.argmax(torch.where(in_subset, -np.inf, scores))
            ok_h, jj_pos, swap, early_h, j_star_h = torch.stack([
                ok.double(), (S_resid_U[j, j] > 0).double(),
                (scores[j] < scores[j_star]).double(), early.double(),
                j_star.double()]).tolist()
            if not ok_h or not jj_pos:
                # numerically unstable: stop (reference :371-373)
                return np.asarray(subset, int)
            if swap:
                subset[jj] = int(j_star_h)
                n_consec_keep = 0
            else:
                n_consec_keep += 1
            in_subset[subset[jj]] = True
            if n_consec_keep >= k or early_h:
                return np.asarray(subset, int)
    raise SolverError("Maximum swapping cycles reached!")


def css_cov(
    S,
    subset_size: int = None,
    *,
    subset=None,
    method: str = "swapping",
    loss: str = "least_squares",
    max_iters: int = int(1e3),
    n_threads: int = 1,
    device=None,
):
    """Solve CSS by the covariance method (reference solver.py:1274).

    ``S`` (p, p) an array or a tensor, taken in float64 on ``device``
    (default: a tensor's own device, else ``"cuda"``; ``device="cpu"`` for
    the CPU).  ``n_threads`` is accepted for the JAX package's signature
    and ignored."""
    sw = Stopwatch().start()
    if isinstance(S, torch.Tensor):
        dev = S.device if device is None else resolve_device(device)
        S = S.to(device=dev, dtype=torch.float64)
    else:
        S = torch.as_tensor(np.asarray(S, np.float64),
                            device=resolve_device(device))
    loss = types.css_loss(loss, param="loss")
    method = types.css_method(method, param="method")
    score = _SCORES[loss]

    if method == "greedy":
        if not isinstance(subset_size, (int, np.integer)):
            raise ValueError(
                "subset_size must be an integer for the greedy method.")
        if not (0 <= int(subset_size) <= S.shape[0]):
            raise ValueError(
                f"subset_size must be in [0, {S.shape[0]}] (p = number of "
                f"features); got {subset_size}.")
        result = _solve_greedy(S, subset_size, score)
    else:
        if subset is None:
            subset = _solve_greedy(S, subset_size, score)
        result = _solve_swapping(S, list(np.asarray(subset, int)), score,
                                 max_iters)

    state = StateCSSCov(
        S=S, subset_size=len(result), subset=np.asarray(result, int),
        method=method, loss=loss, max_iters=max_iters, n_threads=n_threads,
    )
    state.total_time = sw.elapsed()
    return state
