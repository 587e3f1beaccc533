"""K-fold cross-validation, the serial path.

Counterpart of ``adelie_tpu/cv.py``.  Folds are validated by
zero-weighting (reference adelie/cv.py): the training fit runs with the
validation weights set to 0 and renormalized, and the validation loss is
``(full-data loss - train-weight-sum * train loss) / val-weight-sum``.
Every fold is fitted on the common full-data lambda grid, so no fold's
path is interpolated but past an early exit.

The folds run one after another through ``grpnet`` (``_cv_serial``).  A
fold's losses stay on the device until the fold is done, then come to the
host in one copy: the JAX package's per-lambda ``float(glm.loss(...))``
would cost two host syncs a lambda.  The JAX package's fold-batched driver
(``solver/cv_batched.py``, all folds in one device program) is not ported:
``fold_batch=True`` on a problem it takes raises ``NotImplementedError``
(ROADMAP.md: the model-selection layer).
"""

import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse
import torch

from . import matrix as matrix_mod
from .diagnostic import coefficient
from .logger import logger
from .solver import _as_matrix, grpnet

__all__ = ["CVGrpnetResult", "cv_grpnet"]


@dataclass
class CVGrpnetResult:
    """Result of K-fold CV (reference cv.py:25)."""

    lmdas: np.ndarray
    losses: np.ndarray        # (K, L)
    avg_losses: np.ndarray
    best_idx: int

    def plot_loss(self):
        """Mean CV loss along the path (role of reference cv.py:47): the
        mean as a line with a +-1 sd band across folds, and the selected
        lambda marked."""
        from . import _plotstyle as ps

        fig, ax = ps.styled_axes(
            f"{self.losses.shape[0]}-fold CV loss", r"$\lambda$",
            "mean validation loss",
        )
        xs = ps.lambda_axis(ax, self.lmdas)
        mean = np.mean(self.losses, axis=0)
        sd = np.std(self.losses, axis=0, ddof=0)
        ax.fill_between(xs, mean - sd, mean + sd, color=ps.PALETTE[0],
                        alpha=0.15, linewidth=0, zorder=1,
                        label=r"$\pm 1$ sd across folds")
        ax.plot(xs, mean, color=ps.PALETTE[0], linewidth=2.0, zorder=3,
                label="mean loss")
        bi = int(self.best_idx)
        ax.axvline(xs[bi], color=ps.PALETTE[1], linewidth=1.0,
                   linestyle="--", zorder=2)
        ax.scatter([xs[bi]], [mean[bi]], s=36, color=ps.PALETTE[1],
                   zorder=4, label=rf"best $\lambda$ = {xs[bi]:.3g}")
        ps.legend(ax)
        return fig, ax

    def fit(self, X, glm, **grpnet_params):
        """Refit on the full data down to the best lambda (reference
        cv.py:76-127).

        The CV-only arguments (``n_folds``, ``seed``, ``fold_batch``) and
        those this refit sets itself (``early_exit``, ``lmda_path``) are
        dropped, so the keywords given to ``cv_grpnet`` can be passed here.
        """
        for k in ("n_folds", "seed", "early_exit", "lmda_path", "fold_batch"):
            grpnet_params.pop(k, None)
        with _quiet_logger():
            state = grpnet(X=X, glm=glm, lmda_path_size=0, progress_bar=False,
                           **_structural(grpnet_params))

        lmda_path_size = grpnet_params.pop("lmda_path_size", 100)
        lmda_star = self.lmdas[self.best_idx]
        full_lmdas = state.lmda_max * np.logspace(
            0, np.log10(lmda_star / state.lmda_max), lmda_path_size
        )
        return grpnet(
            X=X, glm=glm, lmda_path=full_lmdas, early_exit=False,
            **grpnet_params,
        )


class _quiet_logger:
    def __enter__(self):
        self._level = logger.level
        logger.setLevel(logging.ERROR)
        return self

    def __exit__(self, *exc):
        logger.setLevel(self._level)
        return False


def _fold_assignments(n, n_folds, seed):
    """Shuffle observations into K nearly-equal folds; a list of
    validation-index arrays (the JAX package's draw, so one seed gives
    both packages the same folds)."""
    rng = np.random.RandomState(seed) if seed is not None else np.random
    order = rng.choice(n, n, replace=False)
    bounds = np.linspace(0, n, n_folds + 1).astype(int)
    return [order[bounds[k]:bounds[k + 1]] for k in range(n_folds)]


# grpnet keywords that change the problem's structure, and so lmda_max;
# the dry fits of the common grid honor them
_STRUCTURAL_KEYS = ("groups", "alpha", "penalty", "offsets", "intercept",
                    "constraints", "device")


def _structural(grpnet_params):
    return {k: grpnet_params[k] for k in _STRUCTURAL_KEYS
            if k in grpnet_params}


def _common_path(X, glm, min_ratio, lmda_path_size, grpnet_params):
    """The full-data lambda_max and the log-spaced common grid under it,
    honoring the structural keywords.  Returns ``(lmdas, dry_state)``."""
    state = grpnet(X=X, glm=glm, lmda_path_size=0, progress_bar=False,
                   **_structural(grpnet_params))
    lmdas = state.lmda_max * np.logspace(0, np.log10(min_ratio),
                                         lmda_path_size)
    return lmdas, state


_SEPARABLE_GLMS = ("binomial_logit", "binomial_probit", "poisson")


def _can_batch(X, glm, grpnet_params):
    """Whether the JAX package's fold-batched driver takes the problem:
    the gaussian fast path, a separable single-response GLM or Cox,
    without constraints, multi-response or a host-streamed matrix."""
    if getattr(glm, "is_multi", False):
        return False
    if grpnet_params.get("constraints") is not None:
        return False
    if getattr(X, "is_streaming", False):
        return False
    if glm.name == "gaussian" and getattr(glm, "opt", False):
        return True
    return glm.name in _SEPARABLE_GLMS or glm.name == "cox"


def cv_grpnet(
    X,
    glm,
    *,
    n_threads: int = 1,
    early_exit: bool = False,
    min_ratio: float = 1e-1,
    lmda_path_size: int = 100,
    n_folds: int = 5,
    seed: int = None,
    fold_batch: bool = None,
    **grpnet_params,
):
    """K-fold CV group elastic net (reference cv.py:130).

    The folds run one after another (``fold_batch=None`` or ``False``).
    ``fold_batch=True`` raises ``ValueError`` on a problem the JAX
    package's fold-batched driver does not take (multi-response,
    constrained or host-streamed) and ``NotImplementedError`` on one it
    takes: that driver is not ported.  ``grpnet_params`` go to every fit
    (``device=`` among them); an array ``X`` becomes one dense matrix on
    that device, shared by the fits.
    """
    grpnet_params = dict(grpnet_params)
    grpnet_params.pop("progress_bar", None)
    grpnet_params.pop("ddev_tol", None)
    X = _as_matrix(X, grpnet_params.pop("device", None))
    n = X.rows()

    val_sets = _fold_assignments(n, n_folds, seed)
    base_weights = glm.weights.cpu().numpy().astype(np.float64)

    if fold_batch:
        if not _can_batch(X, glm, grpnet_params):
            raise ValueError(
                "fold_batch=True requires the gaussian fast path or a "
                "separable GLM (binomial/poisson) without constraints or "
                "multi-response."
            )
        raise NotImplementedError(
            "fold_batch=True is not ported yet (ROADMAP.md: the "
            "model-selection layer); fold_batch=None runs the folds one "
            "after another")

    with _quiet_logger():
        full_lmdas, _ = _common_path(X, glm, min_ratio, lmda_path_size,
                                     grpnet_params)
        cv_losses = _cv_serial(X, glm, base_weights, val_sets, full_lmdas,
                               early_exit, n_threads, grpnet_params)

    avg_losses = np.mean(cv_losses, axis=0)
    best_idx = int(np.argmin(avg_losses))
    return CVGrpnetResult(
        lmdas=full_lmdas, losses=cv_losses, avg_losses=avg_losses,
        best_idx=best_idx,
    )


def _fold_weights(base_weights, val_idx):
    """Zero-weighted, renormalized training weights for one fold."""
    w = base_weights.copy()
    w[val_idx] = 0
    w_sum = float(w.sum())
    return w / w_sum, w_sum, float(base_weights[val_idx].sum())


def _fold_etas(X, state, betas, intercepts):
    """The fold's etas over all rows, (L, n) or (L, n, K), on X's device."""
    intercepts = np.asarray(intercepts)
    if intercepts.ndim == 2:
        K = intercepts.shape[1]
        etas = matrix_mod.kronecker_eye(X, K).sp_tmul(betas)
        etas = etas.reshape(len(intercepts), -1, K) \
            + X._vec(intercepts)[:, None, :]
    else:
        etas = X.sp_tmul(betas) + X._vec(intercepts)[:, None]
    offs = getattr(state, "offsets", None)
    if offs is not None and bool(torch.any(torch.as_tensor(offs) != 0)):
        etas = etas + X._vec(offs).reshape(etas.shape[1:])[None]
    return etas


def _cv_serial(X, glm, base_weights, val_sets, full_lmdas, early_exit,
               n_threads, grpnet_params):
    """The serial fold loop with fits on the common grid."""
    K = len(val_sets)
    cv_losses = np.empty((K, full_lmdas.shape[0]))
    glm_dev = glm.to(X.device, X.dtype)
    for k, vidx in enumerate(val_sets):
        w_norm, w_train_sum, w_val_sum = _fold_weights(base_weights, vidx)
        glm_k = glm.reweight(w_norm)
        state = grpnet(
            X=X, glm=glm_k, ddev_tol=0, n_threads=n_threads,
            early_exit=early_exit, lmda_path=full_lmdas,
            progress_bar=False, **grpnet_params,
        )
        # the fit ran on lmda_path=full_lmdas, so its solutions are a
        # prefix of the grid; interpolate only past an early exit
        fit_lmdas = np.asarray(state.lmdas, float)
        n_fit = len(fit_lmdas)
        aligned = n_fit <= len(full_lmdas) and np.allclose(
            fit_lmdas, full_lmdas[:n_fit], rtol=1e-9, atol=0.0
        )
        betas, intercepts = [], []
        for j, lmda in enumerate(full_lmdas):
            if aligned and j < n_fit:
                betas.append(state.betas[j])
                intercepts.append(state.intercepts[j])
            else:
                b, b0 = coefficient(
                    lmda=lmda, betas=state.betas,
                    intercepts=state.intercepts, lmdas=state.lmdas,
                )
                betas.append(b)
                intercepts.append(b0)
        betas = scipy.sparse.vstack(betas).tocsr()

        etas = _fold_etas(X, state, betas, intercepts)
        glm_kd = glm_k.to(X.device, X.dtype)
        loss_full = torch.stack([glm_dev.loss(e) for e in etas])
        loss_train = torch.stack([glm_kd.loss(e) for e in etas])
        losses = torch.stack([loss_full, loss_train]).cpu().numpy() \
            .astype(np.float64)
        cv_losses[k] = (
            (losses[0] - w_train_sum * losses[1]) / w_val_sum
            if w_val_sum > 0 else 0.0
        )
    return cv_losses
