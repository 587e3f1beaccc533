"""GLMs by IRLS in adelie_tpu_torch against adelie_tpu, on the CPU.

The same float64 inputs, made from a numpy seed, go through both
packages: the GLM methods (binomial logit and probit, poisson, cox with
Efron and Breslow ties, strata and zero weights) within rtol 1e-12, and
``grpnet`` paths on dense, in-device SNP and streamed SNP inputs at the
parity bar: coefficients and intercepts within 1e-6, lambdas to rtol
1e-10, deviances within 1e-8, equal screen and active sizes.  The port
runs its kernels' twins here (K1, K6, K3 and K5).  Also the repairs of the
screen Gram's centering and of the group norms, bit for bit against the
formulas they replace.  One JAX fit a case, shared by module fixtures.
"""

import numpy as np
import pytest
import torch

import adelie_tpu as ja
import adelie_tpu_torch as ta
from adelie_tpu.configs import set_configs as ja_set_configs
from adelie_tpu_torch.configs import set_configs
from adelie_tpu_torch.glm._cox import fixed_cumsum
from adelie_tpu_torch.solver import pin_group_kernels as pg
from adelie_tpu_torch.matrix import snp_kernels as sk
from adelie_tpu_torch.solver.pin import screen_gram
from adelie_tpu_torch.utils.groups import GroupIndex, group_sum
from adelie_tpu_torch.state import state_from_numpy

torch.set_num_threads(1)


def _assert_glm_path(js, ts):
    assert js.error == "" and ts.error == "", (js.error, ts.error)
    assert len(ts.lmdas) == len(js.lmdas) > 1
    np.testing.assert_allclose(ts.lmdas, js.lmdas, rtol=1e-10)
    B = js.betas.toarray()
    assert (B != 0).sum() > 0
    np.testing.assert_allclose(ts.betas.toarray(), B, atol=1e-6)
    np.testing.assert_allclose(ts.intercepts, js.intercepts, atol=1e-6)
    np.testing.assert_allclose(ts.devs, js.devs, atol=1e-8)
    assert list(ts.active_sizes) == list(js.active_sizes)
    assert list(ts.screen_sizes) == list(js.screen_sizes)


def _close(got, want, bar=1e-12):
    """Within ``bar`` relative, each entry or, for entries that cancel to
    near 0, of the vector's largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=bar,
                               atol=bar * np.max(np.abs(want)))


# --------------------------------------------------------------------------- #
# the GLMs' methods                                                           #
# --------------------------------------------------------------------------- #


def _eta(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([3 * rng.standard_normal(n - 4),
                           [40.0, -40.0, 20.0, -20.0]])


def _methods(jg, tg, eta, hess_bar=1e-12):
    """Every method of a GLM pair at ``eta`` (``_close``), the Hessian at
    ``hess_bar``; the second argument of ``hessian`` and the last two of
    ``inv_hessian_gradient`` are the JAX package's outputs in both."""
    import jax.numpy as jnp

    je, te = jnp.asarray(eta), torch.from_numpy(eta.copy())
    jgr = np.asarray(jg.gradient(je))
    _close(tg.gradient(te), jgr)
    grad = torch.from_numpy(jgr.copy())
    jh = np.asarray(jg.hessian(je, jnp.asarray(jgr)))
    _close(tg.hessian(te, grad), jh, hess_bar)
    hess = torch.from_numpy(jh.copy())
    _close(tg.inv_hessian_gradient(te, grad, hess),
           jg.inv_hessian_gradient(je, jnp.asarray(jgr), jnp.asarray(jh)))
    _close(tg.loss(te), jg.loss(je))
    _close(tg.loss_full(), jg.loss_full())
    _close(tg.inv_link(te), jg.inv_link(je))


@pytest.mark.parametrize("family", ["logit", "probit", "poisson"])
def test_glm_methods_match_jax(family):
    n = 120
    rng = np.random.default_rng(1)
    w = rng.uniform(0.5, 1.5, n)
    w[:6] = 0.0
    if family == "poisson":
        y = rng.poisson(2.0, n).astype(float)
        jg, tg = ja.glm.poisson(y, w), ta.glm.poisson(y, w)
    else:
        y = (rng.uniform(size=n) < 0.4).astype(float)
        jg = ja.glm.binomial(y, w, link=family)
        tg = ta.glm.binomial(y, w, link=family)
    _methods(jg, tg, _eta(n, 2))


def _cox_data(n, seed, n_strata):
    """tests/test_glm_cox.py's data: ties, left truncation, strata and a
    fifth of the weights zero."""
    rng = np.random.default_rng(seed)
    stop = rng.integers(1, n // 2, n).astype(float)
    start = stop - rng.integers(1, 5, n).astype(float)
    status = (rng.uniform(size=n) < 0.7).astype(float)
    strata = rng.integers(0, n_strata, n)
    w = rng.uniform(0.5, 2.0, n)
    w[rng.choice(n, n // 5, replace=False)] = 0.0
    return dict(start=start, stop=stop, status=status, strata=strata,
                weights=w / w.sum())


@pytest.mark.parametrize("tie_method", ["efron", "breslow"])
@pytest.mark.parametrize("n_strata", [1, 3])
def test_cox_methods_match_jax(tie_method, n_strata):
    """eta up to +-5: at +-40 both packages' at-risk sums are differences
    of suffix sums that cancel to their last bits (XLA's cumsum adds in
    another order than torch's, and the two give values a factor apart),
    so only an eta the likelihood can resolve is compared.  The Hessian,
    ``w status - grad - acc z^2``, cancels at the largest eta: held at
    1e-10 of its largest entry."""
    d = _cox_data(80, seed=n_strata, n_strata=n_strata)
    jg = ja.glm.cox(**d, tie_method=tie_method)
    tg = ta.glm.cox(**d, tie_method=tie_method)
    _methods(jg, tg, _eta(80, 3) / 8, hess_bar=1e-10)
    # fold weights (normalised, as the factories normalise theirs)
    # through the weight bundle, without a rebuild
    w2 = np.random.default_rng(4).uniform(0.0, 1.0, 80)
    w2 /= w2.sum()
    _methods(jg.with_weights(w2), tg.with_weights(w2), _eta(80, 5) / 8,
             hess_bar=1e-10)


@pytest.mark.parametrize("n", [1, 1024, 1025, 40_000])
def test_fixed_cumsum_is_a_cumsum(n):
    """Cox's cumulative sums, in rows scanned in a fixed order (the card's
    1-D ``torch.cumsum`` adds in no fixed order): a cumulative sum within
    float64 rounding."""
    v = torch.randn(n, generator=torch.Generator().manual_seed(n),
                    dtype=torch.float64)
    want = torch.cumsum(v, 0)
    got = fixed_cumsum(v)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-13 * float(v.abs().sum()))


def test_multi_response_is_refused():
    """Multi-response responses are ported: ``data.dense(K=2,
    glm="multinomial")`` and ``data.snp_unphased(K=2,
    glm="multigaussian")`` give the JAX package's arrays.  Refused: K > 1
    for a single-response GLM, and the SNP multigaussian at K = 1, whose
    (n,) response is no (n, K) one (the JAX package fails there too)."""
    for gen, args, kw in ((ja.data.dense, (20, 6, 3), dict(glm="multinomial")),
                          (ja.data.snp_unphased, (20, 6),
                           dict(glm="multigaussian"))):
        dj = gen(*args, K=2, seed=2, **kw)
        dt = getattr(ta.data, gen.__name__)(*args, K=2, seed=2, **kw)
        np.testing.assert_array_equal(dt["X"], dj["X"])
        np.testing.assert_array_equal(dt["glm"].y.numpy(),
                                      np.asarray(dj["glm"].y))
        assert dt["glm"].y.shape == (20, 2) and dt["glm"].is_multi
    with pytest.raises(ValueError, match="multi-response"):
        ta.data.dense(20, 6, 3, K=2, glm="binomial")
    with pytest.raises(ValueError, match=r"\(n, K\)"):
        ta.data.snp_unphased(20, 6, glm="multigaussian")


# --------------------------------------------------------------------------- #
# the generators                                                              #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("glm", ["binomial", "poisson", "cox"])
def test_generators_match_jax(glm):
    dj, dt = (pkg.data.dense(50, 40, 12, glm=glm, seed=3) for pkg in (ja, ta))
    np.testing.assert_array_equal(dt["X"], dj["X"])
    np.testing.assert_array_equal(dt["glm"].y.numpy(), np.asarray(dj["glm"].y))
    if glm == "cox":
        np.testing.assert_array_equal(dt["glm"].stop, dj["glm"].stop)
    sj, st = (pkg.data.snp_unphased(60, 25, glm=glm, seed=7)
              for pkg in (ja, ta))
    for key in ("X", "y", "beta", "penalty"):
        np.testing.assert_array_equal(st[key], sj[key])


# --------------------------------------------------------------------------- #
# grpnet on a dense matrix                                                    #
# --------------------------------------------------------------------------- #


def _dense(n=100, p=20, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    eta = X[:, :3] @ np.array([1.0, -1.0, 0.5])
    return rng, X, eta


def _fit_both(X, jglm, tglm, **kw):
    return (ja.grpnet(X, jglm, **kw),
            ta.grpnet(X, tglm, device="cpu", **kw))


def _binomial_y(rng, eta):
    return (rng.uniform(size=len(eta)) < 1 / (1 + np.exp(-eta))).astype(float)


@pytest.fixture(scope="module")
def logit_fits():
    """The binomial logit path with and without an intercept."""
    rng, X, eta = _dense()
    y = _binomial_y(rng, eta)
    fits = {inter: _fit_both(X, ja.glm.binomial(y), ta.glm.binomial(y),
                             intercept=inter, lmda_path_size=20)
            for inter in (True, False)}
    return X, y, fits


@pytest.mark.parametrize("intercept", [True, False])
def test_binomial_logit_path(logit_fits, intercept):
    """Every group screened up front (p = 20): K1's twin on every IRLS
    iteration."""
    js, ts = logit_fits[2][intercept]
    _assert_glm_path(js, ts)
    assert ts.screen_sizes[0] == 20
    assert len(ts.benchmark["pin_caps"]) == sum(ts.benchmark["irls_iters"])


def test_binomial_warm_start_continues_the_jax_path(logit_fits):
    """The first 8 lambdas fitted by adelie_tpu, carried over with
    state_from_numpy and finished by the port: the full path's rest."""
    X, y, fits = logit_fits
    full = fits[True][0]
    half = ja.grpnet(X, ja.glm.binomial(y), lmda_path=full.lmdas[:8])
    keys = ("screen_set", "screen_begins", "screen_beta", "screen_is_active",
            "lmda", "lmda_max", "resid", "grad", "abs_grad", "eta", "beta0",
            "loss_null", "loss_full")
    ws = state_from_numpy({k: np.asarray(getattr(half, k)) for k in keys},
                          device="cpu")
    ts = ta.grpnet(X, ta.glm.binomial(y), lmda_path=full.lmdas[8:],
                   warm_start=ws, device="cpu")
    assert ts.error == ""
    np.testing.assert_allclose(ts.lmdas, full.lmdas[8:], rtol=1e-10)
    np.testing.assert_allclose(ts.betas.toarray(), full.betas.toarray()[8:],
                               atol=1e-6)
    np.testing.assert_allclose(ts.intercepts, full.intercepts[8:],
                               atol=1e-6)
    np.testing.assert_allclose(ts.devs, full.devs[8:], atol=1e-8)


def test_binomial_probit_path():
    rng, X, eta = _dense(seed=1)
    y = _binomial_y(rng, eta)
    _assert_glm_path(*_fit_both(X, ja.glm.binomial(y, link="probit"),
                                ta.glm.binomial(y, link="probit"),
                                lmda_path_size=15))


def test_gaussian_by_irls_path():
    """``glm.gaussian(y, opt=False)`` takes the IRLS path, as in the JAX
    package."""
    rng, X, eta = _dense(seed=7)
    y = eta + rng.standard_normal(len(eta))
    _assert_glm_path(*_fit_both(X, ja.glm.gaussian(y, opt=False),
                                ta.glm.gaussian(y, opt=False),
                                lmda_path_size=10))


def test_poisson_path_with_offsets_and_weights():
    rng, X, eta = _dense(seed=2)
    y = rng.poisson(np.exp(0.3 * eta)).astype(float)
    w = rng.uniform(0.5, 1.5, len(y))
    off = 0.1 * rng.standard_normal(len(y))
    _assert_glm_path(*_fit_both(X, ja.glm.poisson(y, w), ta.glm.poisson(y, w),
                                offsets=off, lmda_path_size=15))


def test_cox_path():
    """Right-censored times with ties (no start: no left truncation)."""
    rng, X, eta = _dense(seed=3)
    stop = np.round(-np.log(rng.uniform(size=len(eta)))
                    * np.exp(-0.5 * eta), 1) + 0.1
    status = (rng.uniform(size=len(eta)) < 0.7).astype(float)
    _assert_glm_path(*_fit_both(X, ja.glm.cox(stop=stop, status=status),
                                ta.glm.cox(stop=stop, status=status),
                                lmda_path_size=15))


def test_grouped_binomial_path():
    """Groups of 4: K6's twin on every IRLS iteration of a grouped
    screen."""
    rng, X, eta = _dense(seed=4)
    y = _binomial_y(rng, eta)
    pg.reset_newton()
    js, ts = _fit_both(X, ja.glm.binomial(y), ta.glm.binomial(y),
                       groups=np.arange(0, 20, 4), lmda_path_size=15)
    _assert_glm_path(js, ts)
    assert pg.newton["updates"] > 0


def test_binomial_basil_past_1024():
    """p = 1,100 > screen_all_max: BASIL screens, the KKT fails and the
    chunk is retried on a larger screen."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((60, 1100))
    y = _binomial_y(rng, X[:, :5] @ rng.standard_normal(5))
    js, ts = _fit_both(X, ja.glm.binomial(y), ta.glm.binomial(y),
                       lmda_path_size=12)
    _assert_glm_path(js, ts)
    assert not all(ts.n_valid_solutions)


@pytest.mark.parametrize("intercept", [True, False])
def test_irls_failure_leaves_the_same_partial_state(intercept):
    """``irls_max_iters=1``: with an intercept the null model's IRLS
    fails; without one, the first lambda of the path.  The same error and
    the same partial state as the JAX package."""
    rng, X, eta = _dense(seed=6)
    y = _binomial_y(rng, eta)
    js, ts = (pkg.grpnet(X, pkg.glm.binomial(y), irls_max_iters=1,
                         intercept=intercept, lmda_path_size=10, **kw)
              for pkg, kw in ((ja, {}), (ta, dict(device="cpu"))))
    assert ts.error == js.error != ""
    assert len(ts.lmdas) == len(js.lmdas) == int(not intercept)
    np.testing.assert_allclose(ts.lmda, js.lmda, rtol=1e-10)
    if intercept:
        assert ts.lmda_max is js.lmda_max is None
    else:
        np.testing.assert_allclose(ts.lmda_max, js.lmda_max, rtol=1e-10)
    np.testing.assert_allclose(ts.screen_beta, js.screen_beta, atol=1e-12)
    np.testing.assert_array_equal(ts.screen_is_active, js.screen_is_active)
    assert abs(ts.beta0 - float(js.beta0)) < 1e-12
    np.testing.assert_allclose(ts.eta.numpy(), np.asarray(js.eta),
                               atol=1e-12)


# --------------------------------------------------------------------------- #
# SNP inputs: in device memory (K3) and streamed (K5)                         #
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def snp_panel(tmp_path_factory):
    d = ja.data.snp_unphased(300, 120, missing_ratio=0.1, glm="binomial",
                             seed=13)
    f = str(tmp_path_factory.mktemp("glm") / "b.snpdat")
    ja.io.snp_unphased(f).write(d["X"])
    return ja.io.snp_unphased(f).read(), ta.io.snp_unphased(f).read(), d["y"]


def test_snp_binomial_in_device(snp_panel):
    jio, tio, y = snp_panel
    before = sk.launches["snp_mul"]
    js = ja.grpnet(ja.matrix.snp_unphased(jio), ja.glm.binomial(y),
                   lmda_path_size=15)
    ts = ta.grpnet(ta.matrix.snp_unphased(tio, device="cpu"),
                   ta.glm.binomial(y), lmda_path_size=15)
    _assert_glm_path(js, ts)
    assert sk.launches["snp_mul"] == before   # twins on the CPU


def test_snp_binomial_streamed(snp_panel):
    """BASIL (``screen_all_max = 0``) over four tiles of 32: optimistic
    IRLS chunks certified by one K5 pass each, the same passes as the JAX
    package's."""
    jio, tio, y = snp_panel
    ja_set_configs("screen_all_max", 0)
    set_configs("screen_all_max", 0)
    try:
        jm = ja.matrix.snp_unphased(jio, streaming=True, tile_snps=32,
                                    dtype=np.float64)
        tm = ta.matrix.snp_unphased(tio, streaming=True, tile_snps=32,
                                    dtype=np.float64, device="cpu")
        js = ja.grpnet(jm, ja.glm.binomial(y), lmda_path_size=15)
        ts = ta.grpnet(tm, ta.glm.binomial(y), lmda_path_size=15)
    finally:
        ja_set_configs("screen_all_max", None)
        set_configs("screen_all_max", None)
    _assert_glm_path(js, ts)
    assert tm.sweeps == jm.sweeps
    assert len(ts.benchmark["kkt"]) == len(js.benchmark["kkt"]) > 1


# --------------------------------------------------------------------------- #
# the repairs: one Gram at the centering's peak; group norms over p           #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_screen_gram_centering_keeps_the_bits(dtype):
    g = torch.Generator().manual_seed(0)
    Xs = torch.randn((40, 2048), generator=g, dtype=dtype)
    w = torch.rand(40, generator=g, dtype=dtype)
    w = w / w.sum()
    A, means = screen_gram(Xs, w, True)
    A0, means0 = screen_gram(Xs, w, False)
    assert torch.equal(means, means0)
    assert torch.equal(A, A0 - torch.outer(means0, means0))


def _old_fold(x, groups, sizes, p):
    """The (G, Q) fold the bucketed group_sum replaces: every group padded
    to the largest size's power of 2."""
    Q = 1 << int(np.ceil(np.log2(sizes.max())))
    lane = np.arange(Q)
    cols = np.where(lane[None, :] < sizes[:, None], groups[:, None] + lane, p)
    g = torch.cat([x, torch.zeros((1,) + tuple(x.shape[1:]),
                                  dtype=x.dtype)])[torch.as_tensor(cols)]
    while g.shape[1] > 1:
        h = g.shape[1] // 2
        g = g[:, :h] + g[:, h:2 * h]
    return g[:, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bucketed_group_sum_keeps_the_bits(dtype):
    """Mixed sizes 1 to 1,024: the same bits as the old fold, on (p,) and
    (p, C); one group of 1,024 among 20,000 singletons indexes fewer than
    2p entries (the old fold: G x 1,024)."""
    rng = np.random.default_rng(0)
    sizes = np.concatenate([rng.integers(1, 40, 300), [1024, 3, 1]])
    groups = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    p = int(sizes.sum())
    index = GroupIndex(groups, sizes, p, "cpu")
    assert index.size < 2 * p
    x = torch.as_tensor(rng.standard_normal((p, 3)) ** 2, dtype=dtype)
    assert torch.equal(group_sum(x, index), _old_fold(x, groups, sizes, p))
    assert torch.equal(group_sum(x[:, 0], index),
                       _old_fold(x[:, 0], groups, sizes, p))
    sizes = np.concatenate([np.ones(20_000, int), [1024]])
    groups = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    p = int(sizes.sum())
    index = GroupIndex(groups, sizes, p, "cpu")
    assert index.size < 2 * p
    x = torch.as_tensor(rng.standard_normal(p) ** 2, dtype=dtype)
    assert torch.equal(group_sum(x, index), _old_fold(x, groups, sizes, p))


def test_one_large_group_held_out_matches_jax():
    """One group of 512 held out of the screen by penalty 100 among 600
    singletons (p past screen_all_max: BASIL): the KKT's group norms over
    every group, each lambda."""
    rng = np.random.default_rng(8)
    p = 1112
    X = rng.standard_normal((50, p))
    y = X[:, :4] @ rng.standard_normal(4) + rng.standard_normal(50)
    groups = np.arange(601)
    penalty = np.concatenate([np.ones(600), [100.0]])
    kw = dict(groups=groups, penalty=penalty, lmda_path_size=6,
              min_ratio=0.2)
    js = ja.grpnet(X, ja.glm.gaussian(y), **kw)
    ts = ta.grpnet(X, ta.glm.gaussian(y), device="cpu", **kw)
    _assert_glm_path(js, ts)
    assert 600 not in ts.screen_set
