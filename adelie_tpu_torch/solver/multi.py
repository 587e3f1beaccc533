"""Multi-response fits: the multigaussian and the multinomial.

Counterpart of ``adelie_tpu/solver/multi.py`` (reference solver.py:700-763).
The K responses become one flattened problem on

    X_aug = [1 (x) I_K | X (x) I_K] = kronecker_eye(concatenate([1, X]), K)

(the same columns in the same order as the JAX package's concatenation of
two Kroneckers: column ``q K + k`` is column q of ``[1 | X]`` for class k),
with observation ``i K + k`` of weight ``w_i / K``.  The K intercept
columns are singleton unpenalized groups ahead of the features, and a user
group of size g becomes a flattened group of size g K.  The single-response
drivers run it without their implicit intercept: the gaussian in covariance
form (``GaussianNaiveDriver``, ``StreamedGaussianDriver``), the multinomial
and a multigaussian with ``opt=False`` by IRLS (``MultiGlmNaiveDriver``,
whose null model fits the K intercepts, and its streamed twin).  Their
screen cache keeps the Kronecker structure (``KroneckerScreenCache``).
Constraints are refused (ROADMAP.md: constraints).
"""

import numpy as np
import torch

from .. import matrix as matrix_mod
from ..configs import matmul_precision
from ..exceptions import SolverError
from ..glm import hessian_min
from ..glm.multi import FlattenedMultiGlm
from .gaussian import GaussianNaiveDriver, GaussianNaiveState
from .glm_driver import GlmNaiveDriver, GlmNaiveState
from .glm_fused import floored_hessian
from .streamed import StreamedGaussianDriver, StreamedGlmDriver

__all__ = ["MultiGlmNaiveDriver", "MultiStreamedGlmDriver",
           "build_multi_problem", "finalize_multi"]


class MultiGlmNaiveDriver(GlmNaiveDriver):
    """The IRLS driver with the per-class intercept-only null model
    (reference solver_multiglm_naive.hpp update_loss_null :103-190)."""

    def __init__(self, state, K, multi_intercept):
        super().__init__(state)
        self._K = int(K)
        self._multi_intercept = bool(multi_intercept)

    def update_loss_null(self):
        """Without intercepts ``loss(offsets)``; with them, the K
        intercepts alone fitted by IRLS to ``irls_tol`` within
        ``irls_max_iters`` (one host copy an iteration)."""
        s = self.s
        if s.loss_null is not None:
            return
        glm = s.glm
        if not self._multi_intercept:
            s.loss_null = float(glm.loss(s.offsets))
            return
        K = self._K
        hmin = hessian_min(s.dtype)
        tol = float(s.dtype.type(s.irls_tol))
        offs = s.offsets.reshape(-1, K)
        eta, resid = s.eta, s.resid
        for _ in range(s.irls_max_iters):
            hess = floored_hessian(glm, eta, resid, hmin)
            irls_y = glm.inv_hessian_gradient(eta, resid, hess) + eta \
                - s.offsets
            w2 = (hess / torch.sum(hess)).reshape(-1, K)
            beta0 = (torch.sum(w2 * irls_y.reshape(-1, K), dim=0)
                     / torch.sum(w2, dim=0))
            eta_n = (offs + beta0[None, :]).reshape(-1)
            resid_n = glm.gradient(eta_n)
            crit = float(torch.abs(torch.sum((resid_n - resid)
                                             * (eta_n - eta))))
            eta, resid = eta_n, resid_n
            if crit <= tol:
                s.loss_null = float(glm.loss(eta))
                return
        raise SolverError("Maximum IRLS iterations reached (multi loss_null).")


class MultiStreamedGlmDriver(MultiGlmNaiveDriver, StreamedGlmDriver):
    """The per-class null model of ``MultiGlmNaiveDriver`` with the
    optimistic fits, streamed KKT pass and certify of
    ``StreamedGlmDriver``: one pass over the panel serves the C lambdas of
    a chunk in all K classes (K5 at C K columns)."""


def build_multi_problem(X, glm, groups, penalty, offsets_np, warm_start,
                        common, is_gaussian_opt, irls_max_iters, irls_tol):
    """The flattened problem's state and driver (reference
    solver.py:700-763).  ``X`` is the user's (n, p) matrix, ``glm`` the
    multi-response GLM with ``y`` (n, K), ``groups`` the user's groups,
    ``offsets_np`` (n, K), ``common`` ``grpnet``'s solver settings."""
    n, p = X.rows(), X.cols()
    K = int(glm.y.shape[1])
    intercept = bool(common.pop("intercept"))
    dtype = np.dtype(X.dtype)
    like = dict(dtype=X.torch_dtype, device=X.device)

    # the flattened groups (reference solver.py:703-712)
    groups = np.asarray(groups, int) * K
    if intercept:
        groups = np.concatenate([np.arange(K), K + groups]).astype(int)
    p_aug = (p + int(intercept)) * K
    group_sizes = np.diff(np.concatenate([groups, [p_aug]])).astype(int)
    if penalty is None:
        penalty = np.sqrt(group_sizes).astype(float)
        if intercept:
            penalty[:K] = 0
    else:
        penalty = np.asarray(penalty, float)
        if intercept:
            penalty = np.concatenate([np.zeros(K), penalty])
    G = len(groups)
    alpha = common["alpha"]

    X1 = X
    if intercept:
        ones = matrix_mod.dense(np.ones((n, 1), dtype), device=X.device)
        X1 = matrix_mod.concatenate([ones, X])
    X_aug = matrix_mod.kronecker_eye(X1, K)
    streaming = bool(getattr(X_aug, "is_streaming", False))

    if warm_start is None:
        screen_set = np.arange(G)[(penalty <= 0) | (alpha <= 0)]
        gs = group_sizes[screen_set]
        screen_begins = np.concatenate([[0], np.cumsum(gs)])[:-1].astype(int)
        screen_beta = np.zeros(int(gs.sum()), dtype)
        screen_is_active = np.ones(len(screen_set), bool)
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
                f"it was fitted with a different grouping or K (G={G} "
                f"flattened groups, screen value size {len(screen_beta)}).")

    common.update(
        X=X_aug, groups=groups, group_sizes=group_sizes, penalty=penalty,
        n=n * K, p=p_aug,
        # the intercepts are columns of X_aug: the inner solvers run
        # without the implicit one
        intercept=False,
        max_screen_size=common["max_screen_size"] or G,
        max_active_size=common["max_active_size"] or G,
        screen_set=screen_set, screen_begins=screen_begins,
        screen_beta=screen_beta, screen_is_active=screen_is_active,
        lmda=lmda, lmda_max=lmda_max, setup_lmda_max=lmda_max is None,
    )

    if is_gaussian_opt:
        w_ms = glm.weights.to(**like) / K
        weights = torch.repeat_interleave(w_ms, K)
        if warm_start is None:
            y_off = glm.y.to(**like) - torch.as_tensor(offsets_np, **like)
            with matmul_precision():
                y_var = float(torch.sum(w_ms[:, None] * y_off**2))
                if intercept:
                    y_off_c = y_off - (y_off.T @ glm.weights.to(**like))[None]
                    yc_var = float(torch.sum(w_ms[:, None] * y_off_c**2))
                    rsq = yc_var - y_var
                    y_var = yc_var
                else:
                    rsq = 0.0
                resid_sum = float(torch.sum(w_ms[:, None] * y_off))
            resid = y_off.reshape(-1)
            if streaming:
                # one pass over the host-streamed bytes for both full-p
                # set-up products
                both = X_aug.mul_many(torch.stack([weights * resid, weights]))
                grad, X_means = (both[:, 0].contiguous(),
                                 both[:, 1].contiguous())
            else:
                grad = X_aug.mul(resid, weights)
                X_means = X_aug.mul(torch.ones_like(resid), weights)
        else:
            y_var, rsq = float(warm_start.y_var), float(warm_start.rsq)
            resid = torch.as_tensor(warm_start.resid, **like)
            resid_sum = float(warm_start.resid_sum)
            grad = torch.as_tensor(warm_start.grad, **like)
            X_means = torch.as_tensor(warm_start.X_means, **like)
        state = GaussianNaiveState(
            weights=weights, X_means=X_means, y_mean=0.0, y_var=y_var,
            rsq=float(rsq), resid=resid, resid_sum=resid_sum, **common)
        state.grad = grad
        driver = (StreamedGaussianDriver if streaming
                  else GaussianNaiveDriver)(state)
    else:
        fglm = FlattenedMultiGlm(glm).to(X.device, dtype)
        offs = torch.as_tensor(offsets_np.reshape(-1), **like)
        if warm_start is None:
            eta = offs
            resid = fglm.gradient(eta)
            grad = X_aug.mul(resid, torch.ones_like(resid))
            loss_null = None
            loss_full = float(fglm.loss_full())
        else:
            eta = torch.as_tensor(warm_start.eta, **like)
            resid = torch.as_tensor(warm_start.resid, **like)
            grad = torch.as_tensor(warm_start.grad, **like)
            loss_null = float(warm_start.loss_null)
            loss_full = float(warm_start.loss_full)
        state = GlmNaiveState(
            glm=fglm, offsets=offs, beta0=0.0, eta=eta, resid=resid,
            loss_null=loss_null, loss_full=loss_full,
            irls_max_iters=int(irls_max_iters), irls_tol=float(irls_tol),
            **common)
        state.grad = grad
        driver = (MultiStreamedGlmDriver if streaming
                  else MultiGlmNaiveDriver)(state, K, intercept)
    state.K = K
    state.multi_intercept = intercept
    return state, driver


def finalize_multi(state):
    """After ``finalize_state``: the per-class intercepts (L, K), cut from
    the leading K columns of the coefficients (reference
    solver_multiglm_naive.hpp 'tidy' :218-233), and ``n_classes``."""
    K = state.K
    L = state.betas.shape[0]
    state.n_classes = K
    if state.multi_intercept:
        state.intercepts = state.betas[:, :K].toarray()
        state.betas = state.betas[:, K:].tocsr()
    else:
        state.intercepts = np.zeros((L, K))
    return state
