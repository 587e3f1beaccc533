"""scikit-learn compatible estimators.

Counterpart of ``adelie_tpu/sklearn.py``, on the port's ``grpnet``,
``cv_grpnet``, ``diagnostic.predict`` and ``css_cov``.  Both estimators
take ``device`` (default ``"cuda"``; ``device="cpu"`` for the CPU): the
fits and the predictions run there.  Importing this module imports
scikit-learn; ``import adelie_tpu_torch`` does not.

Covers the same public surface as the reference (``adelie/sklearn.py:43-424``,
``py_sklearn.cpp:16-140``): a :class:`GroupElasticNet` estimator wrapping
``grpnet``/``cv_grpnet`` and a :class:`CSSModelSelection` estimator running
the finite-sample guaranteed subset-size selection test over swapping CSS
fits with the subset-factor loss.

Design notes (this module is a re-implementation, not a transcription):

* ``GroupElasticNet`` behavior is table-driven: each supported ``family``
  has a :class:`_Family` descriptor bundling the GLM factory, the inverse
  link, whether predictions are class labels, and the family-appropriate
  ``score``.
* ``score`` deviates deliberately from the reference, which computes an
  R² clipped to [0, 1] for *every* family (reference ``sklearn.py:216-237``)
  — a near-meaningless quantity when ``predict`` returns class labels.
  Here gaussian families report the standard (unclipped) coefficient of
  determination, classification families report accuracy, and poisson
  reports the fraction of deviance explained (D², as sklearn's own
  ``PoissonRegressor.score``).
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from sklearn.base import BaseEstimator, RegressorMixin

from . import glm as glm_mod
from .cv import CVGrpnetResult, cv_grpnet
from .diagnostic import predict as _linear_predict
from .solver import css_cov, grpnet
from .solver._css import _resid_given as _resid_given_t


def _resid_given(S, subset):
    """The residual covariance given ``subset`` and whether its Cholesky
    factor exists, for a numpy ``S``: the port's helper on a CPU tensor
    (host work, as the JAX package's numpy is)."""
    S_resid, ok = _resid_given_t(torch.as_tensor(S, dtype=torch.float64),
                                 np.asarray(subset, int))
    return S_resid.numpy(), bool(ok)


# ---------------------------------------------------------------------------
# family descriptors
# ---------------------------------------------------------------------------


def _sigmoid(eta):
    from scipy.special import expit

    return expit(eta)


def _softmax_rows(eta):
    from scipy.special import softmax

    return softmax(eta, axis=-1)


def _r2_score(y, yhat):
    y = np.asarray(y, dtype=float)
    resid = y - yhat
    centered = y - np.mean(y, axis=0)
    denom = float(np.sum(centered * centered))
    if denom == 0.0:
        return 0.0
    return 1.0 - float(np.sum(resid * resid)) / denom


def _accuracy_score(y, labels):
    y = np.asarray(y)
    if y.ndim == 2:  # one-hot / indicator responses -> label index
        y = np.argmax(y, axis=-1)
    return float(np.mean(y == labels))


def _poisson_d2(y, mu):
    """Fraction of Poisson deviance explained vs the mean-only model."""
    y = np.asarray(y, dtype=float)
    mu = np.maximum(np.asarray(mu, dtype=float), 1e-30)
    ybar = max(float(np.mean(y)), 1e-30)
    with np.errstate(divide="ignore", invalid="ignore"):
        ylogy = np.where(y > 0, y * np.log(y), 0.0)
    dev = 2.0 * np.sum(ylogy - y * np.log(mu) - y + mu)
    dev_null = 2.0 * np.sum(ylogy - y * np.log(ybar) - y + ybar)
    if dev_null == 0.0:
        return 0.0
    return 1.0 - float(dev) / float(dev_null)


@dataclass(frozen=True)
class _Family:
    """Everything the estimator needs to know about one response family."""

    make_glm: Callable[[np.ndarray], Any]
    classify: bool = False
    # inverse link: linear predictor -> mean / probabilities (None = identity)
    inv_link: Optional[Callable[[np.ndarray], np.ndarray]] = None
    # (y, predictions) -> float; predictions are labels when classify else means
    scorer: Callable[[np.ndarray, np.ndarray], float] = _r2_score


_FAMILIES: Dict[str, _Family] = {
    "gaussian": _Family(make_glm=glm_mod.gaussian),
    "multigaussian": _Family(make_glm=glm_mod.multigaussian),
    "binomial": _Family(
        make_glm=glm_mod.binomial,
        classify=True,
        inv_link=_sigmoid,
        scorer=_accuracy_score,
    ),
    "multinomial": _Family(
        make_glm=glm_mod.multinomial,
        classify=True,
        inv_link=_softmax_rows,
        scorer=_accuracy_score,
    ),
    "poisson": _Family(
        make_glm=glm_mod.poisson,
        inv_link=np.exp,
        scorer=_poisson_d2,
    ),
}

_SOLVERS = {"grpnet": grpnet, "cv_grpnet": cv_grpnet}


class GroupElasticNet(BaseEstimator, RegressorMixin):
    """Group elastic net with a scikit-learn API (reference ``sklearn.py:43``).

    Parameters
    ----------
    solver : {"grpnet", "cv_grpnet"}
        Path solver (plain fit) or K-fold cross-validated fit.
    family : {"gaussian", "binomial", "poisson", "multigaussian", "multinomial"}
        Response family.

    device : where the fits and predictions run (None: ``"cuda"``).

    After ``fit``: ``coef_`` holds the solution path (or, for
    ``cv_grpnet``, the single best-λ solution), ``intercept_`` and
    ``lambda_`` align with it, ``state_`` is the underlying solver result.
    """

    def __init__(self, solver: str = "grpnet", family: str = "gaussian",
                 device=None):
        self.solver = solver
        self.family = family
        self.device = device

    # -- internals ---------------------------------------------------------

    def _family(self) -> _Family:
        try:
            return _FAMILIES[self.family]
        except KeyError:
            raise ValueError(f"Unknown family: {self.family}") from None

    def _solver_fn(self):
        try:
            return _SOLVERS[self.solver]
        except KeyError:
            raise ValueError(f"Unknown solver: {self.solver}") from None

    def _validate_params(self):
        self._solver_fn()
        self._family()

    def _require_fitted(self):
        if getattr(self, "state_", None) is None:
            raise RuntimeError("The model has not been fitted yet. Call fit() first.")

    # -- sklearn API -------------------------------------------------------

    def fit(self, X, y, **solver_args: Any):
        """Fit the path (or CV + best-λ refit) and store the solutions."""
        fam = self._family()
        solve = self._solver_fn()
        self.glm_ = fam.make_glm(np.asarray(y))
        solver_args.setdefault("device", self.device)

        result = solve(X=X, glm=self.glm_, **solver_args)
        cv = isinstance(result, CVGrpnetResult)
        if cv:
            result = result.fit(X=X, glm=self.glm_, **solver_args)
        self.state_ = result

        if cv:
            # keep only the best-λ (= last on the refit path) solution; slices
            # preserve the leading path dim (predict relies on a (1, K)
            # intercept to detect multi-response)
            self.coef_ = result.betas[-1]
            self.intercept_ = np.asarray(result.intercepts)[-1:]
            self.lambda_ = np.asarray(result.lmdas)[-1:]
        else:
            self.coef_ = result.betas
            self.intercept_ = np.asarray(result.intercepts)
            self.lambda_ = np.asarray(result.lmdas)
        return self

    def predict_proba(self, X) -> np.ndarray:
        """Class probabilities (classification families only)."""
        self._require_fitted()
        fam = self._family()
        if not fam.classify:
            raise ValueError(
                'predict_proba is only available for "binomial" and '
                '"multinomial" families.'
            )
        eta = _linear_predict(X, self.coef_, self.intercept_,
                              device=self.device)
        p1 = fam.inv_link(eta)
        if self.family == "binomial":
            return np.stack([1.0 - p1, p1], axis=-1).squeeze()
        return np.asarray(p1).squeeze()

    def predict(self, X) -> np.ndarray:
        """Class labels for classification families, linear predictions else.

        (Linear — not mean — predictions for non-classification families,
        matching the reference's behavior; apply the inverse link to get
        means for poisson.)
        """
        self._require_fitted()
        fam = self._family()
        if fam.classify:
            return np.argmax(self.predict_proba(X), axis=-1).squeeze()
        return np.asarray(_linear_predict(
            X, self.coef_, self.intercept_, device=self.device)).squeeze()

    def score(self, X, y) -> float:
        """Family-appropriate goodness of fit (see module docstring).

        Scored at the last solution on the stored path (the best-λ
        solution when ``solver="cv_grpnet"``).
        """
        self._require_fitted()
        fam = self._family()
        # last path solution; [-1:] slices keep the leading path dim for
        # both sparse coef rows and (L, K) intercepts
        coef, icpt = self.coef_[-1:], np.asarray(self.intercept_)[-1:]
        eta = np.asarray(_linear_predict(X, coef, icpt,
                                         device=self.device))[0]
        if fam.classify:
            proba = fam.inv_link(eta)
            if self.family == "binomial":
                preds = (np.asarray(proba) > 0.5).astype(int).squeeze()
            else:
                preds = np.argmax(proba, axis=-1).squeeze()
            return fam.scorer(y, preds)
        preds = eta if fam.inv_link is None else fam.inv_link(eta)
        return fam.scorer(y, preds)


# ---------------------------------------------------------------------------
# CSS model selection
# ---------------------------------------------------------------------------


def _subset_factor_stat(S, subset, logdet_S):
    """Subset-factor test statistic for a candidate subset T:

        log|S_TT| + Σ_{j∉T} log (S / S_TT)_jj  −  log|S|

    i.e. the log-det of the subset-factor model's implied covariance minus
    the saturated one (reference ``py_sklearn.cpp:105-118``). Returns -inf
    when the subset is numerically rank-deficient (never rejects).
    """
    subset = np.asarray(subset, dtype=int)
    S_resid, ok = _resid_given(S, subset)
    if not ok:
        return -np.inf
    rest = np.setdiff1d(np.arange(S.shape[0]), subset)
    resid_diag = np.diag(S_resid)[rest]
    if np.any(resid_diag <= 0):
        return -np.inf
    sign, logdet_T = np.linalg.slogdet(S[np.ix_(subset, subset)])
    if sign <= 0:
        return -np.inf
    return float(logdet_T + np.sum(np.log(resid_diag)) - logdet_S)


class _NullDistribution:
    """Simulated null of the subset-factor statistic.

    Under the null (a size-k subset suffices), the statistic is distributed
    as  Σ_{i=0}^{p-k-2} log(1 + A_i / B_{k+i})  with independent
    A_i ~ χ²(i+1) and B_m ~ χ²(n−m−2). The A and B draws do not depend on
    k, so we draw each column once and slice per k.
    """

    def __init__(self, n: int, p: int, n_sims: int, rng: np.random.Generator):
        df_a = np.arange(1, p)            # A_i, i = 0..p-2
        df_b = n - np.arange(p - 1) - 2   # B_m, m = 0..p-2
        self._A = rng.chisquare(df_a, size=(n_sims, p - 1))
        self._B = rng.chisquare(df_b, size=(n_sims, p - 1))
        self._p = p

    def cutoff(self, k: int, alpha: float) -> float:
        """(1-alpha) quantile of the null statistic for subset size k."""
        m = self._p - k - 1  # number of summed terms
        if m <= 0:
            return np.inf
        samples = np.log1p(self._A[:, :m] / self._B[:, k : k + m]).sum(axis=1)
        return float(np.quantile(samples, 1.0 - alpha))


class CSSModelSelection(BaseEstimator, RegressorMixin):
    """Smallest-sufficient-subset selection via the finite-sample guaranteed
    subset-factor test (reference ``sklearn.py:253-424``).

    Walks subset sizes k = 0, 1, ... and stops at the first k whose best
    swapping-CSS subset is *not* rejected at level ``alpha`` against the
    simulated null; ``subset_`` holds that subset.
    """

    def __init__(
        self,
        alpha: float,
        n_inits: int = 1,
        n_sims: int = int(1e4),
        n_threads: int = 1,
        seed: Optional[int] = None,
        device=None,
    ):
        self.alpha = alpha
        self.n_inits = n_inits
        self.n_sims = n_sims
        self.n_threads = n_threads  # accepted for the JAX package's signature
        self.seed = seed
        self.device = device  # where css_cov runs (None: "cuda")

    def fit(self, X, y=None):
        X = np.asarray(X)
        n = X.shape[0]
        return self.fit_cov(X.T @ X / n, n)

    def _best_subset(self, S, k, rng, logdet_S):
        """Best (lowest-statistic) swapping-CSS subset of size k over random
        inits; returns (subset, stat, accepted_early) where accepted_early is
        set by the caller's cutoff test via the returned stat."""
        p = S.shape[0]
        n_inits = 1 if k == 1 else int(self.n_inits)
        best = (np.empty(0, dtype=int), np.inf)
        for _ in range(n_inits):
            init = rng.choice(p, size=k, replace=False)
            try:
                res = css_cov(S, method="swapping", subset=init,
                              loss="subset_factor", device=self.device)
                subset = np.asarray(res.subset, dtype=int)
                stat = _subset_factor_stat(S, subset, logdet_S)
            except Exception:
                subset, stat = np.asarray(init, dtype=int), -np.inf
            if stat < best[1]:
                best = (subset, stat)
            if best[1] <= self._cutoffs[k]:
                break  # already passes the test; no need for more inits
        return best

    def fit_cov(self, S, n):
        S = np.asarray(S, dtype=np.float64)
        p = S.shape[1]
        if p <= 0 or n < p:
            raise ValueError("requires p > 0 and n >= p")
        logdet_S = np.linalg.slogdet(S)[1]

        rng = np.random.default_rng(self.seed)
        null = _NullDistribution(n, p, int(self.n_sims), rng)
        self._cutoffs = {k: null.cutoff(k, self.alpha) for k in range(p - 1)}

        chosen = None
        for k in range(p - 1):
            if k == 0:
                subset = np.empty(0, dtype=int)
                stat = float(np.sum(np.log(np.diag(S))) - logdet_S)
            else:
                subset, stat = self._best_subset(S, k, rng, logdet_S)
            if stat <= self._cutoffs[k]:
                chosen = subset
                break
        if chosen is None:  # every size rejected: fall back to p-1 columns
            chosen = np.arange(p - 1)
        self.subset_ = np.asarray(chosen, dtype=int)
        return self

    def score(self, X, y=None, sample_weight=None):
        """Negative subset-factor loss of ``subset_`` on the sample
        covariance of ``X`` (reference ``sklearn.py:426``)."""
        self._require_fitted()
        X = np.asarray(X)
        n, p = X.shape
        S = X.T @ X / n
        S_resid, ok = _resid_given(S, self.subset_)
        if not ok:
            return np.inf
        rest = np.setdiff1d(np.arange(p), self.subset_)
        resid_diag = np.diag(S_resid)[rest]
        sign, logdet_T = np.linalg.slogdet(
            S[np.ix_(self.subset_, self.subset_)]
        )
        if sign <= 0 or np.any(resid_diag <= 0):
            return np.inf
        return -float(logdet_T + np.sum(np.log(resid_diag)))

    def _require_fitted(self):
        if getattr(self, "subset_", None) is None:
            raise RuntimeError("The model has not been fitted yet. Call fit() first.")
