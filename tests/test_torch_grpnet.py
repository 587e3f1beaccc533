"""adelie_tpu_torch.grpnet against adelie_tpu.grpnet, float64 on the CPU.

The same numpy inputs go through both packages; the port runs its kernels'
twins here.  Bars: equal path lengths, lambdas to rtol 1e-10, coefficients
to atol 1e-6 (BASELINE.md), deviances and intercepts to atol 1e-8, equal
active and screen sizes.
"""

import numpy as np
import pytest
import torch

import adelie_tpu as ja
import adelie_tpu_torch as ta
from adelie_tpu_torch.solver import pin_kernels as tk
from adelie_tpu_torch.state import state_from_numpy

torch.set_num_threads(1)


def _data(n, p, k, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[rng.choice(p, k, replace=False)] = rng.standard_normal(k)
    y = X @ beta + 0.5 * rng.standard_normal(n) + 1.0
    w = rng.uniform(0.5, 1.5, n)
    pen = rng.uniform(0.5, 1.5, p)
    return X, y, w, pen


def _assert_same_path(js, ts):
    assert js.error == "" and ts.error == "", (js.error, ts.error)
    assert len(ts.lmdas) == len(js.lmdas)
    np.testing.assert_allclose(ts.lmdas, js.lmdas, rtol=1e-10)
    np.testing.assert_allclose(ts.betas.toarray(), js.betas.toarray(),
                               atol=1e-6)
    np.testing.assert_allclose(ts.devs, js.devs, atol=1e-8)
    np.testing.assert_allclose(ts.intercepts, js.intercepts, atol=1e-8)
    assert list(ts.active_sizes) == list(js.active_sizes)
    assert list(ts.screen_sizes) == list(js.screen_sizes)


def _fit_both(X, y, w=None, **kw):
    js = ja.grpnet(X, ja.glm.gaussian(y, weights=w), **kw)
    ts = ta.grpnet(X, ta.glm.gaussian(y, weights=w), device="cpu", **kw)
    return js, ts


@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_small_p_screen_all(intercept, alpha):
    """p < 1024: every group is screened up front and K1's twin runs."""
    X, y, w, pen = _data(120, 40, 6, seed=1)
    js, ts = _fit_both(X, y, w, penalty=pen, alpha=alpha,
                       intercept=intercept, lmda_path_size=30)
    _assert_same_path(js, ts)
    assert ts.screen_sizes[0] == 40


@pytest.mark.parametrize("intercept", [True, False])
def test_large_p_basil_screening(intercept):
    """p > 1024 with small n: BASIL screening (pivot rule) through K1."""
    X, y, w, pen = _data(50, 1100, 5, seed=2)
    js, ts = _fit_both(X, y, w, penalty=pen, intercept=intercept,
                       lmda_path_size=20)
    _assert_same_path(js, ts)
    assert max(ts.screen_sizes) < 1100


def test_screen_past_1024_takes_k2(monkeypatch):
    """The strong rule at a deep chunk end screens most of p = 1100, so the
    screen capacity passes 1024 and K2's twin with the filtered full sweep
    carries the pin solves.

    tol is 1e-12 here: the filtered full sweep picks its movers by exact
    comparisons of a proposal with the current coefficient, so last-bit
    differences between the packages' products pick other movers.  Both
    paths then meet tol but differ by up to sqrt(tol) scale (7.6e-5 at the
    default 1e-7); at 1e-12 they agree to the coefficient bar."""
    X, y, _, _ = _data(50, 1100, 5, seed=3)
    kw = dict(screen_rule="strong", early_exit=False, lmda_path_size=8,
              min_ratio=0.02, tol=1e-12)
    solves = []
    twin = tk.pin_lasso_solve_rows_ref
    monkeypatch.setattr(tk, "pin_lasso_solve_rows_ref",
                        lambda *a: solves.append(a[0].shape[0]) or twin(*a))
    js, ts = _fit_both(X, y, **kw)
    _assert_same_path(js, ts)
    assert max(ts.screen_sizes) > 1024
    assert tk.launches == {"pin_lasso_solve": 0, "pin_lasso_solve_rows": 0}
    # the state counts every pin solve past 1024, dry fits included: the
    # count a run on the card holds K2's launches against
    caps = ts.benchmark["pin_caps"]
    assert solves and solves == [c for c in caps if c > 1024]


@pytest.mark.parametrize("cap_min", [6, 10])
def test_screen_cap_min_not_a_multiple_of_4(cap_min):
    """The pin kernels take a screen capacity that is a multiple of 4, so a
    ``screen_cap_min`` that is not one is rounded up: BASIL's small first
    screens get capacities of 8 or 12, and the path is the default
    capacity's."""
    X, y, w, pen = _data(120, 40, 6, seed=5)

    def fit():
        return ta.grpnet(X, ta.glm.gaussian(y, weights=w), penalty=pen,
                         lmda_path_size=20, device="cpu")

    ta.set_configs("screen_all_max", 0)
    try:
        ref = fit()
        ta.set_configs("screen_cap_min", cap_min)
        ts = fit()
    finally:
        ta.set_configs("screen_all_max", None)
        ta.set_configs("screen_cap_min", None)
    caps = ts.benchmark["pin_caps"]
    assert all(c % 4 == 0 for c in caps), caps
    assert min(caps) < 2 * cap_min
    _assert_same_path(ref, ts)


_WS_KEYS = ("screen_set", "screen_begins", "screen_beta", "screen_is_active",
            "lmda", "lmda_max", "X_means", "y_mean", "y_var", "rsq", "resid",
            "resid_sum", "grad", "abs_grad")


def test_warm_start_from_jax_state():
    """Fit the first 10 lambdas with adelie_tpu, carry the state over with
    state_from_numpy and finish in the port: the same as adelie_tpu's own
    continuation, and the full adelie_tpu path to the coefficient bar."""
    X, y, w, pen = _data(100, 30, 5, seed=4)
    kw = dict(penalty=pen, early_exit=False, lmda_path_size=25)
    full = ja.grpnet(X, ja.glm.gaussian(y, weights=w), **kw)
    half = ja.grpnet(X, ja.glm.gaussian(y, weights=w), penalty=pen,
                     lmda_path=full.lmdas[:10])
    rest = full.lmdas[10:]
    ws = state_from_numpy({k: np.asarray(getattr(half, k)) for k in _WS_KEYS},
                          device="cpu")
    ts = ta.grpnet(X, ta.glm.gaussian(y, weights=w), penalty=pen,
                   lmda_path=rest, early_exit=False, warm_start=ws,
                   device="cpu")
    js = ja.grpnet(X, ja.glm.gaussian(y, weights=w), penalty=pen,
                   lmda_path=rest, early_exit=False, warm_start=half)
    _assert_same_path(js, ts)
    np.testing.assert_allclose(ts.betas.toarray(), full.betas.toarray()[10:],
                               atol=1e-6)
    np.testing.assert_allclose(ts.devs, full.devs[10:], atol=1e-8)


# the port's deliberate departures from adelie_tpu's signatures: where the
# tensors live, and the JAX package's device mesh
_PORT_ONLY = {"grpnet": {"device"}, "dense": {"device"}}
_JAX_ONLY = {"grpnet": set(), "dense": {"mesh"}}


@pytest.mark.parametrize("name", ["grpnet", "dense"])
def test_signatures_match_jax_package(name):
    """Both packages' ``grpnet`` and ``matrix.dense`` take the same keywords
    with the same defaults, but for the listed differences; so
    ``n_threads=`` is accepted (and ignored), as docs/parallelism.md
    promises."""
    import inspect

    jf = ja.grpnet if name == "grpnet" else ja.matrix.dense
    tf = ta.grpnet if name == "grpnet" else ta.matrix.dense
    jp = inspect.signature(jf).parameters
    tp = inspect.signature(tf).parameters
    assert set(tp) - set(jp) == _PORT_ONLY[name]
    assert set(jp) - set(tp) == _JAX_ONLY[name]
    for key in set(jp) & set(tp):
        assert tp[key].default == jp[key].default, key
        assert tp[key].kind == jp[key].kind, key
    assert "n_threads" in tp


_OPTION_CASES = [("screen_all", "unpenalized"), ("screen_all", "offsets"),
                 ("basil", "unpenalized"), ("basil", "offsets")]


@pytest.mark.parametrize("screen,option", _OPTION_CASES,
                         ids=[f"{s}-{o}" for s, o in _OPTION_CASES])
def test_unpenalized_groups_and_offsets(screen, option):
    """Unpenalized groups (penalty 0: screened and active from the start)
    and ``offsets``, under screen-all (p < 1024) and under BASIL (p past
    1024), at the sizes of the tests above."""
    n, p = (120, 40) if screen == "screen_all" else (50, 1100)
    X, y, w, pen = _data(n, p, 5, seed=6)
    kw = dict(lmda_path_size=12)
    if option == "unpenalized":
        pen = pen.copy()
        pen[[2, 7]] = 0.0
        kw["penalty"] = pen
    else:
        kw["offsets"] = np.random.default_rng(7).uniform(-0.5, 0.5, n)
    js, ts = _fit_both(X, y, w, **kw)
    _assert_same_path(js, ts)
    if option == "unpenalized":
        assert (ts.betas.toarray()[:, [2, 7]] != 0).all()
    if screen == "basil":
        assert max(ts.screen_sizes) < p
    else:
        assert ts.screen_sizes[0] == p
