"""adelie_tpu_torch's model-selection layer against adelie_tpu, float64 on
the CPU: ``diagnostic``, the serial ``cv_grpnet`` and the scikit-learn
estimators.

The same numpy inputs go through both packages; the port runs its pin
kernels' twins here, and the JAX package its serial CV
(``fold_batch=False``) only.  The JAX fits are shared at module scope.
Bars: diagnostics fed the same coefficients, intercepts and lambdas to
atol 1e-12; CV lambda grids to rtol 1e-12, fold losses to rtol 1e-8, the
same ``best_idx`` and the refit's coefficients to atol 1e-6; the
estimators' ``coef_`` to atol 1e-6, their predictions and scores to 1e-6.
Each plot returns a figure under matplotlib's Agg backend.
"""

import types

import matplotlib
import numpy as np
import pytest
import torch

import adelie_tpu as ja
import adelie_tpu_torch as ta
from adelie_tpu.cv import _fold_assignments as ja_folds
from adelie_tpu_torch.cv import _fold_assignments as ta_folds

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

torch.set_num_threads(1)

N, P = 120, 20
CV = dict(lmda_path_size=20, n_folds=3, seed=0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    X = rng.standard_normal((N, P))
    beta = np.zeros(P)
    beta[rng.choice(P, 5, replace=False)] = rng.standard_normal(5)
    eta = X @ beta
    y = eta + 0.7 * rng.standard_normal(N) + 0.2
    return dict(
        X=X, y=y, yb=(eta + 0.5 * rng.standard_normal(N) > 0) * 1.0,
        Y=np.eye(3)[np.argmax(X[:, :3] + rng.standard_normal((N, 3)), 1)],
        stop=np.exp(-eta + 0.5 * rng.standard_normal(N)),
        status=(rng.random(N) < 0.7) * 1.0,
        groups=np.arange(0, P, 4))


def _glm(pkg, data, family):
    if family == "gaussian":
        return pkg.glm.gaussian(data["y"])
    if family == "binomial":
        return pkg.glm.binomial(data["yb"])
    if family == "multinomial":
        return pkg.glm.multinomial(data["Y"])
    return pkg.glm.cox(stop=data["stop"], status=data["status"])


_CV_CASES = {
    "gaussian": ("gaussian", {}),
    "grouped": ("gaussian", {"alpha": 0.7, "groups": "groups"}),
    "binomial": ("binomial", {}),
    "multinomial": ("multinomial", {}),
    "cox": ("cox", {}),
}


def _cv_kw(data, case):
    family, kw = _CV_CASES[case]
    return family, {k: data[v] if isinstance(v, str) else v
                    for k, v in kw.items()}


@pytest.fixture(scope="module")
def cv_pairs(data):
    """Both packages' CV and refit, one a case, computed once."""
    out = {}

    def get(case):
        if case not in out:
            family, kw = _cv_kw(data, case)
            X = data["X"]
            jr = ja.cv_grpnet(X, _glm(ja, data, family), fold_batch=False,
                              **CV, **kw)
            tr = ta.cv_grpnet(X, _glm(ta, data, family), device="cpu",
                              **CV, **kw)
            jf = jr.fit(X, _glm(ja, data, family), fold_batch=False, **CV,
                        **kw)
            tf = tr.fit(X, _glm(ta, data, family), device="cpu", **CV, **kw)
            out[case] = (jr, tr, jf, tf)
        return out[case]

    return get


@pytest.fixture(scope="module")
def jax_fits(data, cv_pairs):
    """The JAX package's fits the diagnostics read: the CV refits (so that
    its programs compile once) and a covariance-method path."""
    out = {family: cv_pairs(family)[2]
           for family in ("gaussian", "binomial", "multinomial")}
    out["cov"] = ja.gaussian_cov(data["X"].T @ data["X"] / N,
                                 data["X"].T @ data["y"] / N,
                                 lmda_path_size=8, early_exit=False)
    return out


# --------------------------------------------------------------------------- #
# diagnostics                                                                  #
# --------------------------------------------------------------------------- #


def _close(a, b, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("family", ["gaussian", "binomial", "multinomial"])
def test_diagnostic_functions_vs_jax(data, jax_fits, family):
    """predict, residuals, gradients, objective, gradient_norms and
    gradient_scores of one set of coefficients, intercepts and lambdas."""
    js = jax_fits[family]
    B, b0, lm = js.betas, np.asarray(js.intercepts), np.asarray(js.lmdas)
    X = data["X"]
    offs = np.linspace(-0.1, 0.1, N)
    if family == "multinomial":
        offs = np.stack([offs, -offs, 0 * offs], axis=1)
    je = ja.diagnostic.predict(X, B, b0, offsets=offs)
    te = ta.diagnostic.predict(X, B, b0, offsets=offs, device="cpu")
    assert te.shape == je.shape == ((len(lm), N, 3) if family == "multinomial"
                                    else (len(lm), N))
    _close(te, je)
    jglm, tglm = _glm(ja, data, family), _glm(ta, data, family)
    jr = ja.diagnostic.residuals(jglm, je)
    tr = ta.diagnostic.residuals(tglm, je)
    _close(tr, jr)
    jg = ja.diagnostic.gradients(X, jr)
    tg = ta.diagnostic.gradients(ta.matrix.dense(X, device="cpu"), jr)
    _close(tg, jg)
    kw = dict(groups=data["groups"], alpha=0.7)
    _close(ta.diagnostic.objective(X, tglm, B, b0, lm, device="cpu", **kw),
           ja.diagnostic.objective(X, jglm, B, b0, lm, **kw))
    _close(ta.diagnostic.objective(X, tglm, B, b0, lm, relative=False,
                                   add_penalty=False, device="cpu"),
           ja.diagnostic.objective(X, jglm, B, b0, lm, relative=False,
                                   add_penalty=False))
    pen = np.sqrt(np.full(P // 4, 4.0))
    jn = ja.diagnostic.gradient_norms(jg, B, None, lm, penalty=pen, **kw)
    tn = ta.diagnostic.gradient_norms(jg, B, None, lm, penalty=pen, **kw)
    _close(tn, jn)
    _close(ta.diagnostic.gradient_scores(tn, lm, alpha=0.7, penalty=pen),
           ja.diagnostic.gradient_scores(jn, lm, alpha=0.7, penalty=pen))


def test_coefficient_vs_jax(jax_fits):
    """Interpolation between two path entries, an entry, and the boundary
    solutions past either end."""
    js = jax_fits["gaussian"]
    lm = np.asarray(js.lmdas)
    for lmda in (0.5 * (lm[2] + lm[3]), lm[4], 2 * lm[0], 0.5 * lm[-1]):
        jb, jb0 = ja.diagnostic.coefficient(lmda, js.betas, js.intercepts,
                                            lm)
        tb, tb0 = ta.diagnostic.coefficient(lmda, js.betas, js.intercepts,
                                            lm)
        _close(tb.toarray(), jb.toarray())
        assert abs(float(tb0) - float(jb0)) <= 1e-12
    with pytest.raises(RuntimeError, match="non-empty"):
        ta.diagnostic.coefficient(1.0, js.betas, js.intercepts, [])


def _port_view(js, X, glm):
    """A port-side state holding the JAX fit's outputs over the port's
    matrix and GLM."""
    return types.SimpleNamespace(
        lmdas=np.asarray(js.lmdas), betas=js.betas,
        intercepts=np.asarray(js.intercepts), devs=np.asarray(js.devs),
        X=X, glm=glm, groups=js.groups, alpha=js.alpha, penalty=js.penalty,
        screen_sizes=js.screen_sizes, active_sizes=js.active_sizes,
        benchmark={"fit": [0.1, 0.2], "screen": [0.05]})


@pytest.mark.parametrize("family", ["binomial", "cov"])
def test_diagnostic_classes_vs_jax(data, jax_fits, family):
    """``diagnostic(state)`` picks the naive or covariance class; every
    product and score equals the JAX class's on the same outputs, and
    every plot returns a figure."""
    js = jax_fits[family]
    if family == "cov":
        A = data["X"].T @ data["X"] / N
        view = _port_view(js, None, None)
        view.A = ta.matrix.dense(A, method="cov", device="cpu")
        view.v, view.p = np.asarray(js.v), P
        td, jd = ta.diagnostic.diagnostic(view), ja.diagnostic.diagnostic(js)
        assert isinstance(td, ta.diagnostic.DiagnosticCov)
        _close(td.gradients(), jd.gradients())
    else:
        view = _port_view(js, ta.matrix.dense(data["X"], device="cpu"),
                          _glm(ta, data, family))
        td, jd = ta.diagnostic.diagnostic(view), ja.diagnostic.diagnostic(js)
        assert isinstance(td, ta.diagnostic.DiagnosticNaive)
        for name in ("predict", "residuals", "gradients"):
            _close(getattr(td, name)(), getattr(jd, name)())
    _close(td.gradient_norms(), jd.gradient_norms())
    _close(td.gradient_scores(), jd.gradient_scores())
    for name in ("plot_coefficients", "plot_devs", "plot_set_sizes",
                 "plot_benchmark", "plot_kkt"):
        fig, _ = getattr(td, name)()
        assert isinstance(fig, matplotlib.figure.Figure)
        plt.close(fig)
    fig, _ = td.plot_kkt(idx=0)
    plt.close(fig)


def test_gaussian_diagnostic_has_no_glm(data):
    """A gaussian fit in covariance form keeps no GLM: its residuals
    raise, and its predictions still come from the state's matrix."""
    s = ta.grpnet(data["X"], ta.glm.gaussian(data["y"]), lmda_path_size=5,
                  device="cpu")
    d = ta.diagnostic.diagnostic(s)
    e = d.predict()
    _close(e, s.betas.toarray() @ data["X"].T + s.intercepts[:, None],
           atol=1e-10)
    with pytest.raises(RuntimeError, match="no GLM"):
        d.residuals()


# --------------------------------------------------------------------------- #
# cv_grpnet                                                                    #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", list(_CV_CASES))
def test_cv_grpnet_vs_jax(cv_pairs, case):
    jr, tr, jf, tf = cv_pairs(case)
    np.testing.assert_allclose(tr.lmdas, jr.lmdas, rtol=1e-12)
    assert tr.losses.shape == jr.losses.shape == (3, 20)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-8)
    np.testing.assert_allclose(tr.avg_losses, jr.avg_losses, rtol=1e-8)
    assert tr.best_idx == jr.best_idx
    assert jf.error == "" and tf.error == ""
    np.testing.assert_allclose(tf.lmdas, jf.lmdas, rtol=1e-10)
    np.testing.assert_allclose(tf.betas.toarray(), jf.betas.toarray(),
                               atol=1e-6)
    np.testing.assert_allclose(tf.intercepts, jf.intercepts, atol=1e-6)
    assert ta.state.check_state(tf) == []


def test_cv_plot_and_folds(cv_pairs):
    """The loss plot is a figure; both packages draw the same folds from
    one seed."""
    _, tr, _, _ = cv_pairs("gaussian")
    fig, _ = tr.plot_loss()
    assert isinstance(fig, matplotlib.figure.Figure)
    plt.close(fig)
    for n, k, seed in ((120, 3, 0), (37, 5, 4)):
        for a, b in zip(ta_folds(n, k, seed), ja_folds(n, k, seed)):
            np.testing.assert_array_equal(a, b)


def test_cv_fold_batch(data):
    """``fold_batch=True``: the JAX package's ValueError on a problem its
    fold-batched driver does not take (multinomial), NotImplementedError on
    one it takes (gaussian): that driver is not ported."""
    X = data["X"]
    with pytest.raises(ValueError, match="fold_batch=True requires"):
        ja.cv_grpnet(X, _glm(ja, data, "multinomial"), fold_batch=True,
                     **CV)
    with pytest.raises(ValueError, match="fold_batch=True requires"):
        ta.cv_grpnet(X, _glm(ta, data, "multinomial"), fold_batch=True,
                     device="cpu", **CV)
    with pytest.raises(NotImplementedError, match="model-selection layer"):
        ta.cv_grpnet(X, _glm(ta, data, "gaussian"), fold_batch=True,
                     device="cpu", **CV)


# --------------------------------------------------------------------------- #
# scikit-learn estimators                                                      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("family", ["gaussian", "binomial"])
@pytest.mark.parametrize("solver", ["grpnet", "cv_grpnet"])
def test_group_elastic_net_vs_jax(data, solver, family):
    X = data["X"]
    y = data["y"] if family == "gaussian" else data["yb"]
    kw = dict(lmda_path_size=20)
    if solver == "cv_grpnet":
        kw.update(n_folds=3, seed=0)
    je = ja.GroupElasticNet(solver=solver, family=family).fit(
        X, y, **kw, **({"fold_batch": False} if solver == "cv_grpnet"
                       else {}))
    te = ta.GroupElasticNet(solver=solver, family=family,
                            device="cpu").fit(X, y, **kw)
    np.testing.assert_allclose(te.coef_.toarray(), je.coef_.toarray(),
                               atol=1e-6)
    np.testing.assert_allclose(te.intercept_, je.intercept_, atol=1e-6)
    np.testing.assert_allclose(te.lambda_, je.lambda_, rtol=1e-10)
    Xt = X[:30] + 0.1
    np.testing.assert_allclose(te.predict(Xt), je.predict(Xt), atol=1e-6)
    if family == "binomial":
        np.testing.assert_allclose(te.predict_proba(Xt), je.predict_proba(Xt),
                                   atol=1e-6)
    assert abs(te.score(X, y) - je.score(X, y)) <= 1e-6
    assert te.get_params() == {"solver": solver, "family": family,
                               "device": "cpu"}


def test_estimator_errors():
    with pytest.raises(ValueError, match="Unknown family"):
        ta.GroupElasticNet(family="tweedie", device="cpu").fit(
            np.eye(4), np.ones(4))
    with pytest.raises(RuntimeError, match="not been fitted"):
        ta.GroupElasticNet(device="cpu").predict(np.eye(3))
    with pytest.raises(ValueError, match="predict_proba"):
        est = ta.GroupElasticNet(device="cpu")
        est.state_ = object()
        est.predict_proba(np.eye(3))
    with pytest.raises(RuntimeError, match="not been fitted"):
        ta.CSSModelSelection(alpha=0.1, device="cpu").score(np.eye(3))


def test_css_model_selection_vs_jax():
    """The smallest subset the subset-factor test does not reject, and its
    score, on data with a 3-factor structure."""
    rng = np.random.default_rng(7)
    Z = rng.standard_normal((400, 3))
    X = np.concatenate([Z, Z @ rng.standard_normal((3, 7))
                        + 0.3 * rng.standard_normal((400, 7))], axis=1)
    kw = dict(alpha=0.05, n_inits=2, n_sims=2000, seed=3)
    je = ja.CSSModelSelection(**kw).fit(X)
    te = ta.CSSModelSelection(device="cpu", **kw).fit(X)
    assert list(te.subset_) == list(je.subset_)
    assert abs(te.score(X) - je.score(X)) <= 1e-8 * max(1.0, abs(je.score(X)))
