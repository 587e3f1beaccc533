"""adelie_tpu_torch.state against adelie_tpu, float64 on the CPU: the
state factories, the fixed-screen pin states, ``check_state`` (with
``grpnet(..., check_state=True)`` and ``configs.debug_check_state``) and
warm-start save and load.

The same numpy inputs go through both packages; the port runs its pin
kernels' twins here.  Bars: the pin states' coefficients to atol 1e-10;
the factories' paths as ``grpnet``'s (lambdas rtol 1e-10, coefficients
atol 1e-6); a warm start from either package's ``.npz`` to the JAX
package's own resume at the same bars.  ``check_state`` passes on a port
state of every fit family and names, on corrupted copies, the failures
the JAX package's audit names.
"""

import copy

import numpy as np
import pytest
import torch

import adelie_tpu as ja
import adelie_tpu_torch as ta
from adelie_tpu.state import check_state as ja_check
from adelie_tpu_torch.configs import set_configs
from adelie_tpu_torch.state import check_state

torch.set_num_threads(1)

N, P = 120, 24


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    X = rng.standard_normal((N, P))
    beta = np.zeros(P)
    beta[rng.choice(P, 6, replace=False)] = rng.standard_normal(6)
    y = X @ beta + 0.5 * rng.standard_normal(N) + 0.3
    return dict(X=X, y=y, A=X.T @ X / N, v=X.T @ y / N,
                groups=np.arange(0, P, 3),
                lmdas=np.abs(X.T @ (y - y.mean()) / N).max()
                * np.logspace(0, -2, 12))


def _same_path(js, ts, atol=1e-6):
    assert js.error == "" and ts.error == "", (js.error, ts.error)
    assert len(ts.lmdas) == len(js.lmdas) > 0
    np.testing.assert_allclose(ts.lmdas, js.lmdas, rtol=1e-10)
    np.testing.assert_allclose(ts.betas.toarray(), js.betas.toarray(),
                               atol=atol)
    np.testing.assert_allclose(ts.intercepts, js.intercepts, atol=atol)


# --------------------------------------------------------------------------- #
# the pin states                                                               #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("grouped", [False, True])
def test_gaussian_pin_naive_vs_jax(data, grouped):
    """A fixed screen of some groups (q = 1: K1's twin; groups of 3: K6's)
    over a 12-lambda path: the same coefficients, intercepts and devs."""
    kw = dict(X=data["X"], y=data["y"], lmda_path=data["lmdas"])
    if grouped:
        kw.update(groups=data["groups"], screen_set=np.array([0, 2, 3, 5]))
    else:
        kw.update(screen_set=np.array([1, 3, 4, 8, 11, 17, 20]))
    js = ja.state.gaussian_pin_naive(**kw).solve()
    ts = ta.state.gaussian_pin_naive(device="cpu", **kw).solve()
    _same_path(js, ts, atol=1e-10)
    np.testing.assert_allclose(ts.devs, js.devs, atol=1e-10)
    assert check_state(ts) == []
    assert list(ts.screen_sizes) == [len(kw["screen_set"])] * 12


@pytest.mark.parametrize("case", ["q1", "groups_of_4", "groups_of_3"])
def test_gaussian_pin_cov_vs_jax(data, case):
    """The covariance-form pin state on A = X'X/n, v = X'y/n: one pin solve
    a lambda on the fixed screen's block, the same coefficients and final
    iterate as the JAX package's.  Groups of 3 (padded block width 4) are
    held against the JAX package's ``gaussian_pin_naive`` on the same
    problem (no intercept, weights 1/n): its ``gaussian_pin_cov`` keeps the
    screen block unpadded, and ``lax.dynamic_slice`` then clamps the last
    group's 4-wide window back into the block (its path misses KKT there
    by several lambda)."""
    kw = dict(A=data["A"], v=data["v"], lmda_path=data["lmdas"])
    if case == "groups_of_4":
        kw.update(groups=np.arange(0, P, 4), screen_set=np.array([0, 2, 3, 5]))
    elif case == "groups_of_3":
        kw.update(groups=data["groups"], screen_set=np.array([1, 2, 4, 6]))
    ts = ta.state.gaussian_pin_cov(device="cpu", **kw).solve()
    if case == "groups_of_3":
        js = ja.state.gaussian_pin_naive(
            X=data["X"], y=data["y"], lmda_path=data["lmdas"],
            groups=data["groups"], screen_set=kw["screen_set"],
            intercept=False).solve()
        np.testing.assert_allclose(ts.betas.toarray(), js.betas.toarray(),
                                   atol=1e-10)
        return
    js = ja.state.gaussian_pin_cov(**kw).solve()
    np.testing.assert_allclose(ts.lmdas, js.lmdas, rtol=1e-12)
    np.testing.assert_allclose(ts.betas.toarray(), js.betas.toarray(),
                               atol=1e-10)
    np.testing.assert_allclose(ts.screen_beta, js.screen_beta, atol=1e-10)
    np.testing.assert_array_equal(ts.screen_is_active, js.screen_is_active)
    assert abs(ts.rsq - js.rsq) <= 1e-10


def test_pin_states_take_a_warm_iterate_and_refuse(data, tmp_path):
    """A pin state started from the JAX package's final iterate of the
    path's first half (screen_beta, active flags, rsq, resid) fits the
    second half as the JAX package's does from it; a missing path and a
    host-streamed matrix raise."""
    X, y, lm = data["X"], data["y"], data["lmdas"]
    ss = np.arange(P)
    head = ja.state.gaussian_pin_naive(X=X, y=y, lmda_path=lm[:6],
                                       screen_set=ss).solve()
    warm = dict(X=X, y=y, lmda_path=lm[6:], screen_set=ss,
                screen_beta=np.asarray(head.screen_beta),
                screen_is_active=np.asarray(head.screen_is_active),
                rsq=float(head.rsq), resid=np.asarray(head.resid))
    js = ja.state.gaussian_pin_naive(**warm).solve()
    ts = ta.state.gaussian_pin_naive(device="cpu", **warm).solve()
    _same_path(js, ts, atol=1e-10)
    with pytest.raises(ValueError, match="lmda_path"):
        ta.state.gaussian_pin_naive(X=X, y=y, device="cpu")
    with pytest.raises(ValueError, match="lmda_path"):
        ta.state.gaussian_pin_cov(A=data["A"], v=data["v"], device="cpu")
    d = ja.data.snp_unphased(40, 16, seed=3)
    f = str(tmp_path / "p.snpdat")
    ta.io.snp_unphased(f).write(d["X"])
    io = ta.io.snp_unphased(f).read()
    Xs = ta.matrix.snp_unphased(io, streaming=True, tile_snps=8,
                                dtype=np.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="host-streamed"):
        ta.state.gaussian_pin_naive(X=Xs, y=d["glm"].y, lmda_path=[1.0])


# --------------------------------------------------------------------------- #
# the factories                                                                #
# --------------------------------------------------------------------------- #


def _factory_args(pkg, data, name):
    X, y = data["X"], data["y"]
    Y = np.stack([y, -0.5 * y + X[:, 0]], axis=1)
    rng = np.random.default_rng(4)
    if name == "gaussian_naive":
        return dict(X=X, y=y, lmda_path_size=15)
    if name == "glm_naive":
        return dict(X=X, glm=pkg.glm.binomial((y > 0.3).astype(float)),
                    lmda_path_size=10)
    if name == "multigaussian_naive":
        return dict(X=X, y=Y, lmda_path_size=10)
    if name == "multiglm_naive":
        return dict(X=X, glm=pkg.glm.multigaussian(Y), lmda_path_size=10)
    if name == "gaussian_cov":
        return dict(A=data["A"], v=data["v"], lmda_path_size=15)
    if name == "bvls":
        return dict(X=X, y=y, lower=np.zeros(P), upper=np.full(P, 0.5))
    if name == "pinball":
        return dict(A=rng.standard_normal((10, 8)), S=np.eye(8) * 2.0,
                    v=rng.standard_normal(8),
                    penalty_neg=rng.uniform(0.1, 1.0, 10),
                    penalty_pos=rng.uniform(0.1, 1.0, 10), tol=1e-10)
    return dict(S=np.corrcoef(X.T), subset_size=5, method="greedy")


@pytest.mark.parametrize("name", [
    "gaussian_naive", "glm_naive", "multigaussian_naive", "multiglm_naive",
    "gaussian_cov", "bvls", "pinball", "css_cov"])
def test_factories_vs_jax(data, name):
    """Each factory's ``solve()`` against the JAX package's; its result
    passes ``check_state``."""
    js = getattr(ja.state, name)(**_factory_args(ja, data, name)).solve()
    ts = getattr(ta.state, name)(device="cpu",
                                 **_factory_args(ta, data, name)).solve()
    if name == "css_cov":
        assert list(ts.subset) == list(js.subset)
    elif name in ("bvls", "pinball"):
        np.testing.assert_allclose(ts.beta, js.beta, atol=1e-8)
    else:
        _same_path(js, ts)
    assert check_state(ts) == []


def test_factories_refuse_a_wrapped_stream(tmp_path):
    """A wrapper of a host-streamed panel is refused when the state is
    made, before any fit."""
    d = ja.data.snp_unphased(40, 16, seed=3)
    f = str(tmp_path / "w.snpdat")
    ta.io.snp_unphased(f).write(d["X"])
    Xs = ta.matrix.snp_unphased(ta.io.snp_unphased(f).read(), streaming=True,
                                tile_snps=8, dtype=np.float64, device="cpu")
    Xw = ta.matrix.standardize(Xs)
    y = np.asarray(d["glm"].y)
    with pytest.raises(NotImplementedError, match="MatrixNaiveStandardize"):
        ta.state.gaussian_naive(X=Xw, y=y)
    with pytest.raises(NotImplementedError, match="bare panel"):
        ta.state.glm_naive(X=Xw, glm=ta.glm.gaussian(y))


# --------------------------------------------------------------------------- #
# check_state                                                                  #
# --------------------------------------------------------------------------- #


def _family_state(data, family, tmp_path):
    X, y, n = data["X"], data["y"], N
    rng = np.random.default_rng(9)
    dev = dict(device="cpu")
    if family == "gaussian":
        return ta.grpnet(X, ta.glm.gaussian(y), **dev)
    if family == "grouped":
        return ta.grpnet(X, ta.glm.gaussian(y), groups=data["groups"],
                         alpha=0.7, **dev)
    if family == "binomial":
        return ta.grpnet(X, ta.glm.binomial((y > 0.3).astype(float)),
                         lmda_path_size=20, **dev)
    if family == "cox":
        return ta.grpnet(X, ta.glm.cox(stop=np.exp(rng.standard_normal(n)),
                                       status=(rng.random(n) < 0.7) * 1.0),
                         lmda_path_size=15, **dev)
    if family == "multinomial":
        return ta.grpnet(X, ta.glm.multinomial(
            np.eye(3)[rng.integers(0, 3, n)]), lmda_path_size=10, **dev)
    if family == "cov":
        return ta.gaussian_cov(data["A"], data["v"], **dev)
    if family == "lazy_cov":
        return ta.gaussian_cov(ta.matrix.lazy_cov(X / np.sqrt(n), **dev),
                               data["v"], **dev)
    if family == "bvls":
        return ta.bvls(X, y, np.zeros(P), np.ones(P), **dev)
    if family == "css":
        return ta.css_cov(data["A"], 4, **dev)
    d = ja.data.snp_unphased(n, 40, missing_ratio=0.1, seed=5)
    f = str(tmp_path / "c.snpdat")
    ta.io.snp_unphased(f).write(d["X"])
    Xs = ta.matrix.snp_unphased(ta.io.snp_unphased(f).read(), streaming=True,
                                tile_snps=16, dtype=np.float64, **dev)
    ys = np.asarray(d["glm"].y)
    if family == "streamed":
        return ta.grpnet(Xs, ta.glm.gaussian(ys), lmda_path_size=20)
    return ta.grpnet(Xs, ta.glm.binomial((ys > np.median(ys)) * 1.0),
                     lmda_path_size=10)


@pytest.fixture
def basil():
    """``screen_all_max = 0``: BASIL screens from the unpenalized groups,
    so KKT failures and retries reach the audited bookkeeping."""
    set_configs("screen_all_max", 0)
    yield
    set_configs("screen_all_max", None)


@pytest.mark.parametrize("family", [
    "gaussian", "grouped", "binomial", "cox", "multinomial", "cov",
    "lazy_cov", "bvls", "css", "streamed", "streamed_binomial"])
def test_check_state_passes_on_every_family(data, family, basil, tmp_path):
    state = _family_state(data, family, tmp_path)
    assert getattr(state, "error", "") == ""
    assert check_state(state, "warn") == []
    assert check_state(state) == []


def test_check_state_true_audits_the_fit(data, monkeypatch):
    """``grpnet(..., check_state=True)`` and ``gaussian_cov(...,
    check_state=True)`` run the audit on the finished state: a failing
    audit raises its AssertionError."""
    kw = dict(lmda_path_size=8, early_exit=False, device="cpu")
    ok = ta.grpnet(data["X"], ta.glm.gaussian(data["y"]), check_state=True,
                   **kw)
    assert ok.error == "" and len(ok.lmdas) == 8
    seen = []
    from adelie_tpu_torch import state as st

    real = st.check_state
    monkeypatch.setattr(st, "check_state",
                        lambda s, method="assert": seen.append(s)
                        or real(s, method))
    ta.gaussian_cov(data["A"], data["v"], check_state=True, **kw)
    ta.grpnet(data["X"], ta.glm.gaussian(data["y"]), **kw)
    assert len(seen) == 1
    monkeypatch.setattr(st, "check_state", lambda s, method="assert": (
        _ for _ in ()).throw(AssertionError("state check failed: x")))
    with pytest.raises(AssertionError, match="state check failed"):
        ta.grpnet(data["X"], ta.glm.gaussian(data["y"]), check_state=True,
                  **kw)


def test_debug_check_state_audits_each_streamed_chunk(data, tmp_path,
                                                      monkeypatch, basil):
    """With ``configs.debug_check_state`` the streamed gaussian and GLM
    drivers audit the state after every certified chunk."""
    from adelie_tpu_torch import state as st

    calls = []
    real = st.check_state
    monkeypatch.setattr(st, "check_state",
                        lambda s, method="assert": calls.append(
                            len(s.lmdas)) or real(s, method))
    set_configs("debug_check_state", True)
    try:
        for family in ("streamed", "streamed_binomial"):
            before = len(calls)
            s = _family_state(data, family, tmp_path)
            assert s.error == ""
            assert len(calls) - before == len(s.benchmark["kkt"]) > 1
    finally:
        set_configs("debug_check_state", None)
    n = len(calls)
    _family_state(data, "streamed", tmp_path)
    assert len(calls) == n


def _corrupt(state, kind):
    s = copy.copy(state)
    if kind == "duplicate screen":
        s.screen_set = np.concatenate([state.screen_set, state.screen_set[:1]])
    elif kind == "lambdas not decreasing":
        s.lmdas = np.asarray(state.lmdas)[::-1].copy()
    elif kind == "beta off the screen":
        off = np.setdiff1d(np.arange(P), state.screen_set)[0]
        B = state.betas.toarray()
        B[-1, off] = 1.0
        s.betas = type(state.betas)(B)
    else:
        s.lmdas = np.asarray(state.lmdas)[:-1]
    return s


_MESSAGES = {
    "duplicate screen": "screen_set must be unique",
    "lambdas not decreasing": "lmdas must be strictly decreasing",
    "beta off the screen": "nonzero coefficients outside the screen set",
    "length mismatch": "betas/lmdas length mismatch",
}


@pytest.fixture(scope="module")
def basil_pair(data):
    """A gaussian path of both packages on a screen smaller than p."""
    ja.set_configs("screen_all_max", 0)
    set_configs("screen_all_max", 0)
    try:
        kw = dict(lmda_path_size=6, min_ratio=0.2, early_exit=False)
        js = ja.grpnet(data["X"], ja.glm.gaussian(data["y"]), **kw)
        ts = ta.grpnet(data["X"], ta.glm.gaussian(data["y"]), device="cpu",
                       **kw)
    finally:
        ja.set_configs("screen_all_max", None)
        set_configs("screen_all_max", None)
    assert len(ts.screen_set) < P
    return js, ts


@pytest.mark.parametrize("kind", list(_MESSAGES))
def test_check_state_names_corruptions_as_jax(basil_pair, kind):
    js, ts = basil_pair
    want = _MESSAGES[kind]
    got_t = check_state(_corrupt(ts, kind), "warn")
    got_j = ja_check(_corrupt(js, kind), "warn")
    assert want in got_t and want in got_j, (got_t, got_j)
    with pytest.raises(AssertionError, match=want):
        check_state(_corrupt(ts, kind))


def test_check_state_aux_corruptions(data):
    """The standalone solvers' audit: beta outside its box and a subset
    that repeats a column."""
    b = ta.bvls(data["X"], data["y"], np.zeros(P), np.full(P, 0.2),
                device="cpu")
    bad = copy.copy(b)
    bad.beta = np.full(P, 0.5)
    assert "beta violates the [lower, upper] bounds" in check_state(bad,
                                                                    "warn")
    c = copy.copy(ta.css_cov(data["A"], 4, device="cpu"))
    c.subset = np.array([0, 0, 1, 2])
    assert "subset must be unique" in check_state(c, "warn")


# --------------------------------------------------------------------------- #
# warm starts through .npz                                                     #
# --------------------------------------------------------------------------- #


def _stop_at(k):
    return lambda state: len(state.lmdas) >= k


@pytest.mark.parametrize("family", ["gaussian", "binomial"])
def test_warm_start_file_from_jax_resumes_in_the_port(data, family,
                                                      tmp_path):
    """The JAX package's fit stopped at its 5th lambda, saved by its
    ``save_state``; the port's ``load_warm_start`` resumes it over the
    rest of the path as the JAX package's own ``load_warm_start`` does."""
    X, y = data["X"], data["y"]
    yy = y if family == "gaussian" else (y > 0.3).astype(float)
    mk = {"gaussian": lambda pkg: pkg.glm.gaussian(yy),
          "binomial": lambda pkg: pkg.glm.binomial(yy)}[family]
    kw = dict(lmda_path_size=15, early_exit=False)
    head = ja.grpnet(X, mk(ja), exit_cond=_stop_at(5), **kw)
    full = ja.grpnet(X, mk(ja), **kw)
    rest = np.asarray(full.lmdas)[len(head.lmdas):]
    f = ja.state.save_state(head, str(tmp_path / "ws.npz"))
    js = ja.grpnet(X, mk(ja), lmda_path=rest, early_exit=False,
                   warm_start=ja.state.load_warm_start(f))
    ws = ta.state.load_warm_start(f, device="cpu")
    assert isinstance(ws, ta.state.WarmStart)
    ts = ta.grpnet(X, mk(ta), lmda_path=rest, early_exit=False,
                   warm_start=ws, device="cpu")
    _same_path(js, ts)
    np.testing.assert_allclose(ts.betas.toarray(), full.betas.toarray()[5:],
                               atol=1e-6)


def test_save_and_load_round_trip_in_the_port(data, tmp_path):
    """The port's ``save_state`` writes the JAX package's fields; its
    ``load_warm_start`` reads them back unchanged and resumes the path."""
    X, y = data["X"], data["y"]
    kw = dict(lmda_path_size=15, early_exit=False, device="cpu")
    head = ta.grpnet(X, ta.glm.gaussian(y), exit_cond=_stop_at(6), **kw)
    full = ta.grpnet(X, ta.glm.gaussian(y), **kw)
    f = ta.state.save_state(head, str(tmp_path / "port"))
    ws = ta.state.load_warm_start(f, device="cpu")
    for k in ("screen_set", "screen_beta", "abs_grad"):
        np.testing.assert_array_equal(getattr(ws, k), getattr(head, k))
    np.testing.assert_array_equal(ws.resid.numpy(), head.resid.numpy())
    assert (ws.lmda, ws.rsq, ws.y_mean) == (head.lmda, head.rsq, head.y_mean)
    jws = ja.state.load_warm_start(f)
    np.testing.assert_array_equal(np.asarray(jws.grad), head.grad.numpy())
    rest = full.lmdas[6:]
    ts = ta.grpnet(X, ta.glm.gaussian(y), lmda_path=rest, warm_start=ws,
                   early_exit=False, device="cpu")
    np.testing.assert_allclose(ts.betas.toarray(), full.betas.toarray()[6:],
                               atol=1e-6)
