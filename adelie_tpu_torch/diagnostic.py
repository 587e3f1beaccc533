"""Diagnostics (reference adelie/diagnostic.py).

Counterpart of ``adelie_tpu/diagnostic.py``: ``predict``, ``objective``,
``residuals``, ``gradients``, ``gradient_norms``, ``gradient_scores``,
``coefficient``, the plots and the diagnostic classes.  The products run on
the matrix's device through the port's matrices (``sp_tmul``, ``mul``; a
multi-response fit's etas and gradients through ``matrix.kronecker_eye``),
the losses and gradients of a GLM on the GLM's device; every result comes
back as a numpy array of the JAX package's shape: (L, n) or (L, n, K).
An array ``X`` becomes a dense matrix on ``device`` (default ``"cuda"``).
The plots import matplotlib when they are called.
"""

from dataclasses import dataclass
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch

from . import matrix as matrix_mod
from .logger import logger
from .solver import _as_matrix
from .utils import host as _host

__all__ = ["DiagnosticCov", "DiagnosticNaive", "coefficient", "diagnostic",
           "gradient_norms", "gradient_scores", "gradients", "objective",
           "plot_benchmark", "plot_coefficients", "plot_devs", "plot_kkt",
           "plot_set_sizes", "predict", "residuals"]


def _on_glm(glm, e):
    """An eta row as a tensor on the GLM's device, in its dtype."""
    return torch.as_tensor(np.asarray(e), dtype=glm.torch_dtype,
                           device=glm.y.device)


def predict(X, betas, intercepts, *, offsets=None, n_threads: int = 1,
            device=None):
    """Linear predictions (reference diagnostic.py:30): ``X betas^T`` plus
    the intercepts and offsets, one ``sp_tmul`` on the matrix's device.

    Returns (L, n) or, for (L, K) intercepts, (L, n, K) etas.
    """
    intercepts = np.atleast_1d(np.asarray(intercepts))
    is_multi = intercepts.ndim == 2
    if is_multi:
        K = intercepts.shape[1]
        Xm = matrix_mod.kronecker_eye(_as_matrix(X, device), K)
        n = Xm.rows() // K
        y_shape = (n, K)
    else:
        Xm = _as_matrix(X, device)
        n = Xm.rows()
        y_shape = (n,)

    if isinstance(betas, np.ndarray):
        betas = sp.csr_matrix(np.atleast_2d(betas))
    betas = sp.csr_matrix(betas)
    L = betas.shape[0]

    etas = _host(Xm.sp_tmul(betas))  # (L, nK)
    etas = etas.reshape((L,) + y_shape)
    if is_multi:
        etas = etas + intercepts[:, None, :]
    else:
        etas = etas + intercepts[:, None]
    if offsets is not None:
        etas = etas + _host(offsets).reshape(y_shape)[None]
    return etas


def residuals(glm, etas):
    """-grad loss at each eta row (reference diagnostic.py:279), on the
    GLM's device."""
    return np.stack([_host(glm.gradient(_on_glm(glm, e))) for e in etas])


def gradients(X, resids, *, n_threads: int = 1, device=None):
    """``X^T resid`` per row (reference diagnostic.py:320): one ``mul`` a
    row on the matrix's device, as in the JAX package.  On a host-streamed
    matrix each row is a pass over the panel."""
    is_multi = resids.ndim == 3
    if is_multi:
        K = resids.shape[2]
        Xm = matrix_mod.kronecker_eye(_as_matrix(X, device), K)
        shape = (Xm.cols() // K, K)
    else:
        Xm = _as_matrix(X, device)
        shape = (Xm.cols(),)
    ones = torch.ones(int(np.prod(resids.shape[1:])), dtype=Xm.torch_dtype,
                      device=Xm.device)
    out = [_host(Xm.mul(Xm._vec(r.ravel()), ones)).reshape(shape)
           for r in resids]
    return np.stack(out)


def _group_sizes(groups, p):
    return np.diff(np.concatenate([groups, [p]])).astype(int)


def objective(
    X, glm, betas, intercepts, lmdas, *,
    groups=None, alpha: float = 1.0, penalty=None, offsets=None,
    relative: bool = True, add_penalty: bool = True, n_threads: int = 1,
    device=None,
):
    """Group elastic net objective per path entry (reference
    diagnostic.py:124)."""
    etas = predict(X, betas, intercepts, offsets=offsets, device=device)
    is_multi = etas.ndim == 3
    Xm = _as_matrix(X, device)
    p = Xm.cols()
    if groups is None:
        groups = np.arange(p)
    groups = np.asarray(groups, int)
    if is_multi:
        K = etas.shape[2]
        groups_full = groups * K
        gs = _group_sizes(groups_full, p * K)
    else:
        groups_full = groups
        gs = _group_sizes(groups, p)
    if penalty is None:
        penalty = np.sqrt(gs)
    penalty = np.asarray(penalty, float)

    if isinstance(betas, np.ndarray):
        B = np.atleast_2d(betas)
    else:
        B = np.asarray(sp.csr_matrix(betas).todense())

    losses = np.array([float(glm.loss(_on_glm(glm, e))) for e in etas])
    if relative:
        losses = losses - float(glm.loss_full())

    if not add_penalty:
        return losses

    reg = np.zeros(len(losses))
    for li in range(len(losses)):
        b = B[li]
        for g, (s, q) in enumerate(zip(groups_full, gs)):
            nrm = np.linalg.norm(b[s:s + q])
            reg[li] += penalty[g] * (alpha * nrm + 0.5 * (1 - alpha) * nrm**2)
    return losses + np.asarray(lmdas) * reg


def gradient_norms(grads, betas, duals, lmdas, *, constraints=None,
                   groups=None, alpha: float = 1.0, penalty=None):
    """||grad_g - l2 beta_g - A'mu_g||_2 per group per lambda (reference
    diagnostic.py:389)."""
    is_multi = grads.ndim == 3
    if is_multi:
        L, p, K = grads.shape
        if groups is None:
            groups = np.arange(p)
        groups = np.asarray(groups, int) * K
        gs = _group_sizes(groups, p * K)
    else:
        L, p = grads.shape
        if groups is None:
            groups = np.arange(p)
        groups = np.asarray(groups, int)
        gs = _group_sizes(groups, p)
    if penalty is None:
        penalty = np.sqrt(gs)
    penalty = np.asarray(penalty, float)
    pen_cols = np.repeat(penalty, gs)

    B = np.asarray(sp.csr_matrix(betas).todense()) if not isinstance(
        betas, np.ndarray) else np.atleast_2d(betas)
    G2 = grads.reshape(L, -1) - B * (
        np.asarray(lmdas)[:, None] * (1 - alpha) * pen_cols[None]
    )
    if constraints is not None:
        for li in range(L):
            for g, c in enumerate(constraints):
                if c is None:
                    continue
                s, q = groups[g], gs[g]
                G2[li, s:s + q] -= np.asarray(c.gradient(B[li, s:s + q]))

    out = np.zeros((L, len(groups)))
    for g, (s, q) in enumerate(zip(groups, gs)):
        out[:, g] = np.linalg.norm(G2[:, s:s + q], axis=1)
    return out


def gradient_scores(grad_norms, lmdas, *, alpha: float = 1.0, penalty=None):
    """Gradient scores  ||.|| / (alpha penalty), lmda where the penalty is
    0 (reference diagnostic.py:523)."""
    penalty = np.asarray(penalty, float)
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = alpha * penalty
        scores = np.where(
            denom[None] > 0,
            grad_norms / np.where(denom[None] <= 0, 1.0, denom[None]),
            np.asarray(lmdas)[:, None],
        )
    return scores


def coefficient(lmda, betas, intercepts, lmdas):
    """Path interpolation of coefficients at a new lambda (reference
    diagnostic.py:577)."""
    lmdas = np.asarray(lmdas)
    if len(lmdas) == 0:
        raise RuntimeError("lmdas must be non-empty!")
    betas = sp.csr_matrix(betas)
    intercepts = np.asarray(intercepts)
    if len(lmdas) == 1:
        return betas[0], intercepts[0]
    order = np.argsort(lmdas)
    idx = np.searchsorted(lmdas, lmda, sorter=order)
    idx = lmdas.shape[0] - idx
    if idx == 0 or idx == lmdas.shape[0]:
        logger.warning(
            "lmda is not within the range of the saved lambdas. "
            "Returning boundary solution."
        )
        idx = int(np.clip(idx, 0, lmdas.shape[0] - 1))
        return betas[idx], intercepts[idx]
    left, right = betas[idx - 1], betas[idx]
    weight = (lmda - lmdas[idx]) / (lmdas[idx - 1] - lmdas[idx])
    beta = left.multiply(weight) + right.multiply(1 - weight)
    intercept = weight * intercepts[idx - 1] + (1 - weight) * intercepts[idx]
    return sp.csr_matrix(beta), intercept


# --------------------------------------------------------------------------- #
# plots (reference diagnostic.py:649-1126), matplotlib imported per call      #
# --------------------------------------------------------------------------- #


def plot_coefficients(betas, lmdas, groups=None, group_sizes=None):
    """Coefficient profile plot (role of reference diagnostic.py:649): the
    bulk of the paths in one muted ink, the top-k features by final
    coefficient magnitude in categorical hues with a direct label at the
    path's right edge."""
    from . import _plotstyle as ps

    B = np.asarray(sp.csr_matrix(betas).todense())
    fig, ax = ps.styled_axes("Coefficient paths", r"$\lambda$", r"$\beta_j$")
    lmdas = ps.lambda_axis(ax, lmdas)
    if B.size == 0:
        return fig, ax
    final_mag = np.abs(B[-1])
    k = min(len(ps.SERIES) - 1, B.shape[1])
    top = np.argsort(final_mag)[::-1][:k]
    top = [j for j in top if final_mag[j] > 0] or list(top[:1])
    rest = np.setdiff1d(np.arange(B.shape[1]), top)
    if rest.size:
        ax.plot(lmdas, B[:, rest], color=ps.MUTED, linewidth=0.9, zorder=1)
    # nudge apart right-edge labels that would overprint
    span = float(B.max() - B.min()) or 1.0
    min_gap = 0.035 * span
    order = sorted(range(len(top)), key=lambda r: B[-1, top[r]])
    label_y = [B[-1, top[r]] for r in order]
    for i in range(1, len(label_y)):
        label_y[i] = max(label_y[i], label_y[i - 1] + min_gap)
    y_of = {top[r]: y for r, y in zip(order, label_y)}
    for rank, j in enumerate(top):
        c = ps.SERIES[rank % len(ps.SERIES)]
        ax.plot(lmdas, B[:, j], color=c, linewidth=1.8, zorder=3)
        ax.annotate(
            f"x{j}", (lmdas[-1], y_of[j]), textcoords="offset points",
            xytext=(4, 0), fontsize=8, color=c, va="center",
        )
    return fig, ax


def plot_devs(lmdas, devs):
    """Deviance-explained plot (role of reference diagnostic.py:717)."""
    from . import _plotstyle as ps

    fig, ax = ps.styled_axes(
        "Deviance explained along the path", r"$\lambda$",
        "fraction of null deviance",
    )
    lmdas = ps.lambda_axis(ax, lmdas)
    devs = np.asarray(devs, dtype=float)
    ax.fill_between(lmdas, 0.0, devs, color=ps.PALETTE[0], alpha=0.12,
                    linewidth=0, zorder=1)
    ax.plot(lmdas, devs, color=ps.PALETTE[0], linewidth=2.0, zorder=3)
    ax.set_ylim(bottom=0.0)
    return fig, ax


def plot_set_sizes(state):
    """Screen and active set sizes as step curves (role of reference
    diagnostic.py:745); the gap between them is the screening overhead."""
    from . import _plotstyle as ps

    fig, ax = ps.styled_axes(
        "Screen vs. active set size", r"$\lambda$", "groups",
    )
    lmdas = ps.lambda_axis(ax, state.lmdas)
    m = min(len(lmdas), len(state.screen_sizes), len(state.active_sizes))
    ax.step(lmdas[:m], np.asarray(state.screen_sizes)[:m], where="mid",
            color=ps.PALETTE[0], linewidth=1.8, label="screen set")
    ax.step(lmdas[:m], np.asarray(state.active_sizes)[:m], where="mid",
            color=ps.PALETTE[1], linewidth=1.8, label="active set")
    ax.set_ylim(bottom=0)
    ps.legend(ax)
    return fig, ax


def plot_benchmark(state):
    """Total seconds per solver phase as a sorted horizontal bar chart
    (role of reference diagnostic.py:861)."""
    from . import _plotstyle as ps

    totals = {}
    for phase, times in state.benchmark.items():
        if len(times):
            totals[phase] = float(sum(
                t if np.isscalar(t) else float(np.sum(t)) for t in times
            ))
    fig, ax = ps.styled_axes("Time per solver phase", "seconds", "")
    if totals:
        order = sorted(totals, key=totals.get)
        vals = [totals[k] for k in order]
        ax.barh(order, vals, height=0.62, color=ps.PALETTE[0], zorder=3)
        for i, v in enumerate(vals):
            ax.annotate(f"{v:.3g}s", (v, i), textcoords="offset points",
                        xytext=(4, 0), fontsize=8, color=ps.INK,
                        va="center")
        ax.grid(False, axis="y")
    return fig, ax


def plot_kkt(lmdas, scores, idx=None):
    """KKT slack plot (role of reference diagnostic.py:991): the relative
    slack ``s_g/lambda - 1`` of every group, violations in the alert hue;
    with ``idx``, that group's score against the lambda threshold."""
    from . import _plotstyle as ps

    lmdas_np = np.asarray(lmdas)
    scores = np.asarray(scores)
    if idx is None:
        fig, ax = ps.styled_axes(
            "KKT slack by group", r"$\lambda$", r"$s_g/\lambda - 1$",
        )
        xs = ps.lambda_axis(ax, lmdas_np)
        rel = scores / lmdas_np[:, None] - 1
        # active groups sit at the boundary (rel ~ 0 up to solver noise);
        # only flag violations clearly beyond that band
        bad = rel > 1e-3
        X = np.broadcast_to(xs[:, None], rel.shape)
        ax.scatter(X[~bad], rel[~bad], s=6, color=ps.PALETTE[0],
                   alpha=0.5, linewidths=0, zorder=2, label="satisfied")
        if bad.any():
            ax.scatter(X[bad], rel[bad], s=14, color=ps.ALERT, marker="x",
                       zorder=4, label="violated")
            ps.legend(ax)
        ax.axhline(0, color=ps.INK, linewidth=0.8, linestyle="--", zorder=3)
    else:
        fig, ax = ps.styled_axes(
            f"KKT score of group {idx}", r"$\lambda$", "score",
        )
        xs = ps.lambda_axis(ax, lmdas_np)
        ax.plot(xs, lmdas_np, color=ps.INK, linewidth=0.8, linestyle="--",
                label=r"threshold $\lambda$", zorder=2)
        ax.plot(xs, scores[:, idx], color=ps.PALETTE[0], linewidth=1.8,
                zorder=3, label=f"$s_{{{idx}}}$")
        ps.legend(ax)
    return fig, ax


# --------------------------------------------------------------------------- #
# Diagnostic classes (reference diagnostic.py:1126-1415)                       #
# --------------------------------------------------------------------------- #


class _Plots:
    """The plots every diagnostic class draws from its state."""

    def plot_coefficients(self):
        return plot_coefficients(self.betas, self.lmdas)

    def plot_devs(self):
        return plot_devs(self.lmdas, np.asarray(self.state.devs))

    def plot_set_sizes(self):
        return plot_set_sizes(self.state)

    def plot_benchmark(self):
        return plot_benchmark(self.state)

    def plot_kkt(self, idx=None):
        return plot_kkt(self.lmdas, self.gradient_scores(), idx=idx)


@dataclass
class DiagnosticNaive(_Plots):
    """Diagnostic suite for naive-method states (reference
    diagnostic.py:1248): the products on the state's matrix, on its
    device."""

    state: Any

    def __post_init__(self):
        s = self.state
        self.lmdas = np.asarray(s.lmdas)
        self.betas = s.betas
        self.intercepts = np.asarray(s.intercepts)
        self._glm = getattr(s, "glm", None)
        self._X = s.X

    def predict(self):
        offs = getattr(self.state, "offsets", None)
        return predict(self._X, self.betas, self.intercepts, offsets=offs)

    def residuals(self, etas=None):
        if self._glm is None:
            raise RuntimeError("state has no GLM (gaussian fast path); "
                               "construct residuals from predict() directly")
        etas = self.predict() if etas is None else etas
        return residuals(self._glm, etas)

    def gradients(self, resids=None):
        if resids is None:
            resids = self.residuals()
        return gradients(self._X, resids)

    def gradient_norms(self, grads=None, **kwargs):
        s = self.state
        if grads is None:
            grads = self.gradients()
        return gradient_norms(
            grads, self.betas, getattr(s, "duals", None), self.lmdas,
            groups=s.groups, alpha=s.alpha, penalty=s.penalty, **kwargs,
        )

    def gradient_scores(self, grad_norms=None):
        s = self.state
        if grad_norms is None:
            grad_norms = self.gradient_norms()
        return gradient_scores(grad_norms, self.lmdas, alpha=s.alpha,
                               penalty=s.penalty)


@dataclass
class DiagnosticCov(_Plots):
    """Diagnostic suite for covariance-method states (reference
    diagnostic.py:1126): ``v - A beta`` a lambda on ``A``'s device."""

    state: Any

    def __post_init__(self):
        s = self.state
        self.lmdas = np.asarray(s.lmdas)
        self.betas = s.betas

    def gradients(self):
        s = self.state
        B = np.asarray(sp.csr_matrix(self.betas).todense())
        out = np.zeros_like(B)
        cols = np.arange(s.p)
        for li in range(B.shape[0]):
            out[li] = np.asarray(s.v) - _host(s.A.mul(cols, B[li]))
        return out

    def gradient_norms(self, grads=None):
        s = self.state
        if grads is None:
            grads = self.gradients()
        return gradient_norms(grads, self.betas, None, self.lmdas,
                              groups=s.groups, alpha=s.alpha,
                              penalty=s.penalty)

    def gradient_scores(self):
        s = self.state
        return gradient_scores(self.gradient_norms(), self.lmdas,
                               alpha=s.alpha, penalty=s.penalty)


def diagnostic(state):
    """The diagnostic class of a state (reference diagnostic.py:1393)."""
    if hasattr(state, "A") and getattr(state, "X", None) is None:
        return DiagnosticCov(state)
    return DiagnosticNaive(state)
