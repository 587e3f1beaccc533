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


def test_screen_past_1024_takes_k2():
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
    js, ts = _fit_both(X, y, **kw)
    _assert_same_path(js, ts)
    assert max(ts.screen_sizes) > 1024
    assert tk.launches == {"pin_lasso_solve": 0, "cd_sweep_rows": 0}


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
