"""Multi-response fits of adelie_tpu_torch against adelie_tpu, on the CPU.

The same float64 inputs, made from a numpy seed, go through both packages:
the multigaussian and multinomial GLMs' methods (rtol 1e-12); the
Kronecker and concatenation wrappers' products over dense, in-device SNP
and streamed SNP children; the identity of the port's ``X_aug``
(``kronecker_eye(concatenate([1, X]), K)``) with the JAX package's
concatenation of two Kroneckers; the Kronecker screen block (per-class
Grams from the child's columns) against the naive (n K, S) gather within
1e-12; and ``grpnet`` paths at the parity bar: lambdas to rtol 1e-10,
coefficients and (L, K) intercepts within 1e-6, deviances within 1e-8,
equal screen and active sizes, and equal passes over a streamed panel.
The port runs its kernels' twins here (K1, K6, K3 and K5).  The JAX fits
share shapes, so the JAX package compiles each program once.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import adelie_tpu as ja
import adelie_tpu_torch as ta
from adelie_tpu_torch.configs import set_configs
from adelie_tpu_torch.matrix import snp_kernels as sk
from adelie_tpu_torch.solver import pin_group_kernels as pg
from adelie_tpu_torch.solver.state_core import (KroneckerScreenCache,
                                                ScreenCache)
from adelie_tpu_torch.state import state_from_numpy

torch.set_num_threads(1)

N, P, K = 60, 8, 3


def _assert_multi_path(js, ts, K=K, sizes=True):
    """``sizes=False``: a streamed fit against an in-device one, whose
    drivers screen and keep active sets differently."""
    assert js.error == "" and ts.error == "", (js.error, ts.error)
    assert len(ts.lmdas) == len(js.lmdas) > 1
    np.testing.assert_allclose(ts.lmdas, js.lmdas, rtol=1e-10)
    B = js.betas.toarray()
    assert (B != 0).sum() > 0
    assert ts.betas.shape == js.betas.shape
    np.testing.assert_allclose(ts.betas.toarray(), B, atol=1e-6)
    assert ts.intercepts.shape == (len(js.lmdas), K) == \
        np.asarray(js.intercepts).shape
    np.testing.assert_allclose(ts.intercepts, js.intercepts, atol=1e-6)
    np.testing.assert_allclose(ts.devs, js.devs, atol=1e-8)
    if sizes:
        assert list(ts.active_sizes) == list(js.active_sizes)
        assert list(ts.screen_sizes) == list(js.screen_sizes)
    assert ts.n_classes == js.n_classes == K


def _close(got, want, bar=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=bar,
                               atol=bar * np.max(np.abs(want)))


def _dense(seed, n=N, p=P, K=K):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    B = np.zeros((p, K))
    B[:3] = rng.standard_normal((3, K))
    return rng, X, X @ B


def _gaussian_y(rng, eta):
    return eta + 0.5 * rng.standard_normal(eta.shape)


def _multinomial_y(rng, eta):
    P = np.exp(2 * eta - (2 * eta).max(1, keepdims=True))
    P /= P.sum(1, keepdims=True)
    return np.eye(eta.shape[1])[[rng.choice(eta.shape[1], p=pi) for pi in P]]


# --------------------------------------------------------------------------- #
# the GLMs                                                                    #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("family", ["multigaussian", "multinomial"])
def test_multi_glm_methods_match_jax(family):
    """Every method of the (n, K) GLM and of its flattened view, with
    weights (one of them 0) and eta up to +-20."""
    rng, _, eta = _dense(1)
    eta = 4 * eta
    eta[0] = [20.0, -20.0, 0.0]
    y = (_gaussian_y if family == "multigaussian" else _multinomial_y)(rng,
                                                                       eta)
    w = rng.uniform(0.5, 1.5, N)
    w[3] = 0.0
    jg = getattr(ja.glm, family)(y, weights=w)
    tg = getattr(ta.glm, family)(y, weights=w)
    assert tg.is_multi and tg.name == jg.name
    e = torch.from_numpy(eta)
    grad = tg.gradient(e)
    _close(grad.numpy(), jg.gradient(eta))
    hess = tg.hessian(e, grad)
    _close(hess.numpy(), jg.hessian(eta, jg.gradient(eta)))
    _close(tg.inv_hessian_gradient(e, grad, hess).numpy(),
           jg.inv_hessian_gradient(eta, jg.gradient(eta),
                                   jg.hessian(eta, jg.gradient(eta))))
    _close(float(tg.loss(e)), float(jg.loss(eta)))
    assert abs(float(tg.loss_full()) - float(jg.loss_full())) < 1e-14
    _close(tg.inv_link(e).numpy(), jg.inv_link(eta))

    from adelie_tpu.glm.multi import FlattenedMultiGlm as JFlat
    from adelie_tpu_torch.glm.multi import FlattenedMultiGlm as TFlat

    jf, tf = JFlat(jg), TFlat(tg).to("cpu", np.float64)
    ef = eta.reshape(-1)
    tgr = tf.gradient(torch.from_numpy(ef))
    _close(tgr.numpy(), jf.gradient(ef))
    _close(tf.hessian(torch.from_numpy(ef), tgr).numpy(),
           jf.hessian(ef, jf.gradient(ef)))
    _close(tf.weights.numpy(), jf.weights)
    _close(float(tf.loss(torch.from_numpy(ef))), float(jf.loss(ef)))
    assert not tf.is_multi


def test_multinomial_needs_two_classes():
    with pytest.raises(ValueError, match="2 columns"):
        ta.glm.multinomial(np.ones((5, 1)))
    with pytest.raises(ValueError, match=r"\(n, K\)"):
        ta.glm.multigaussian(np.ones(5))


# --------------------------------------------------------------------------- #
# the wrappers                                                                #
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def snp_panel(tmp_path_factory):
    """A 150 x 24 panel with 10 % NA; multigaussian (K = 3) and multinomial
    (K = 3) responses from its first columns."""
    d = ja.data.snp_unphased(150, 24, missing_ratio=0.1, seed=21)
    f = str(tmp_path_factory.mktemp("multi") / "m.snpdat")
    ja.io.snp_unphased(f).write(d["X"])
    Xd = np.where(d["X"] == -9, 0, d["X"]).astype(float)
    rng, _, _ = _dense(2)
    B = np.zeros((24, K))
    B[:4] = 0.5 * rng.standard_normal((4, K))
    eta = Xd @ B
    eta -= eta.mean(0)
    ys = {"multigaussian": _gaussian_y(rng, eta),
          "multinomial": _multinomial_y(rng, eta)}
    return ja.io.snp_unphased(f).read(), ta.io.snp_unphased(f).read(), ys


def _children(kind, snp_panel):
    """(JAX child, port child, n, p) of a wrapper test."""
    if kind == "dense":
        X = _dense(3)[1]
        return (ja.matrix.dense(X), ta.matrix.dense(X, device="cpu"),
                *X.shape)
    jio, tio, _ = snp_panel
    streaming = kind == "streamed"
    jm = ja.matrix.snp_unphased(jio, streaming=streaming, tile_snps=8,
                                dtype=np.float64)
    tm = ta.matrix.snp_unphased(tio, streaming=streaming, tile_snps=8,
                                dtype=np.float64, device="cpu")
    return jm, tm, 150, 24


@pytest.mark.parametrize("kind", ["dense", "snp", "streamed"])
def test_wrappers_match_jax(kind, snp_panel):
    """``kronecker_eye`` over ``concatenate([1, child])`` (and, on a dense
    child, over the child): mul, mul_many,
    gather and sq_mul against the JAX wrappers', tmul against the dense
    product; one streamed pass a mul_many, for all C K columns."""
    jc, tc, n, p = _children(kind, snp_panel)
    rng = np.random.default_rng(4)
    ones = np.ones((n, 1))
    jcat = ja.matrix.concatenate([ja.matrix.dense(ones), jc])
    tcat = ta.matrix.concatenate([ones, tc])
    assert tcat.device == torch.device("cpu")
    t = torch.from_numpy
    cases = [(ja.matrix.kronecker_eye(jcat, K),
              ta.matrix.kronecker_eye(tcat, K), p + 1)]
    if kind == "dense":
        # an SNP child's products are the JAX package's slowest to compile:
        # its wrappers run once, in the multi-response problem's X_aug
        cases += [(ja.matrix.kronecker_eye(jc, K),
                   ta.matrix.kronecker_eye(tc, K), p)]
    for jm, tm, q in cases:
        rows, cols = jm.rows(), jm.cols()
        assert tm.shape == (rows, cols)
        v, w = rng.standard_normal(rows), rng.uniform(0.1, 1, rows)
        U = rng.standard_normal((4, rows))
        beta = np.zeros(cols)
        beta[rng.choice(cols, 5, replace=False)] = rng.standard_normal(5)
        idx = np.array([0, 2, cols - 1, 5, 1])
        sweeps = tm.sweeps if kind == "streamed" else 0
        _close(tm.mul(t(v), t(w)), jm.mul(v, w))
        _close(tm.mul_many(t(U)), jm.mul_many(U))
        if kind == "streamed":
            assert tm.is_streaming and tm.sweeps == sweeps + 2
        _close(tm.gather(idx), jm.gather(idx))
        if kind == "dense":
            _close(tm.to_dense(), jm.to_dense())
        # the JAX streamed matrix's tmul takes no (p, K) beta
        _close(tm.tmul(t(beta)), tm.to_dense() @ beta)
        _close(tm.sq_mul(t(w)), jm.sq_mul(w))
        assert tm.K == K and tm.child.cols() == q


def test_x_aug_is_the_jax_packages():
    """The port's X_aug, one Kronecker of ``[1 | X]``, has the columns of
    the JAX package's ``[1 (x) I_K | X (x) I_K]`` in the same order."""
    X = _dense(5)[1]
    ones = np.ones((N, 1))
    j = ja.matrix.concatenate([ja.matrix.kronecker_eye(ones, K),
                               ja.matrix.kronecker_eye(X, K)],
                              axis=1).to_dense()
    t = ta.matrix.kronecker_eye(
        ta.matrix.concatenate([ones, X], device="cpu"), K).to_dense()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        t, np.kron(np.concatenate([ones, X], 1), np.eye(K)))


def test_wrappers_refuse_mixed_inputs():
    a = ta.matrix.dense(np.ones((4, 2)), device="cpu")
    b = ta.matrix.dense(np.ones((4, 2), np.float32), device="cpu")
    with pytest.raises(ValueError, match="dtypes"):
        ta.matrix.concatenate([a, b])
    with pytest.raises(ValueError, match="row counts"):
        ta.matrix.concatenate([a, ta.matrix.dense(np.ones((5, 1)),
                                                  device="cpu")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ta.matrix.kronecker_eye(np.ones((4, 2)), 2)


# --------------------------------------------------------------------------- #
# the Kronecker screen block against the naive gather                         #
# --------------------------------------------------------------------------- #


def _screen_state(X_aug, groups, sizes, screen_set):
    return SimpleNamespace(
        X=X_aug, groups=groups, group_sizes=sizes, screen_set=screen_set,
        penalty=np.ones(len(groups)), n=X_aug.rows(), dtype=np.dtype("f8"),
        torch_dtype=torch.float64, device=torch.device("cpu"))


@pytest.mark.parametrize("classes", ["same", "per-class"])
def test_kronecker_screen_block_matches_the_naive_gather(classes):
    """The intercepts' K slots, user groups of 1 and of 2 (flattened
    groups of K and 2 K slots), screened out of order, then an appended
    extension: the Gram (formed and extended), the screen gradient, the
    residual update and the streamed residuals of the Kronecker cache
    against the dense cache on the (n K, S) gather, within 1e-12 of the
    largest entry.  ``same``: every class weighted alike; ``per-class``:
    weights that differ by class (K Grams either way)."""
    rng, X, _ = _dense(6)
    ones = np.ones((N, 1))
    X_aug = ta.matrix.kronecker_eye(
        ta.matrix.concatenate([ones, X], device="cpu"), K)
    user = np.array([0, 1, 3, 4, 6])                     # sizes 1, 2, 1, 2, 2
    groups = np.concatenate([np.arange(K), K + user * K])
    sizes = np.diff(np.concatenate([groups, [(P + 1) * K]]))
    w = rng.uniform(0.5, 1.5, (N, 1 if classes == "same" else K))
    w = torch.from_numpy(np.broadcast_to(w, (N, K)).reshape(-1).copy())
    w /= w.sum()
    screen = np.array([0, 1, 2, 6, 3])
    st = _screen_state(X_aug, groups, sizes, screen)
    kron, naive = KroneckerScreenCache(K), ScreenCache()
    caches = (kron, naive)
    for step, ss in enumerate((screen, np.concatenate([screen, [7, 4]]))):
        st.screen_set = ss
        for c in caches:
            c.rebuild_structure(st)
            if step:
                assert c._pending_ext is not None and c._A_prev is not None
            c.rebuild_weighted(w, False)
        assert kron.Xs is None and kron.Xc.shape[0] == N
        assert kron.S_cap == naive.S_cap and kron.qmax == naive.qmax == 8
        np.testing.assert_array_equal(kron.cols, naive.cols)
        assert kron.G.shape[0] == K
        bar = 1e-12 * float(naive.A.abs().max())
        np.testing.assert_allclose(kron.A.numpy(), naive.A.numpy(), rtol=0,
                                   atol=bar)
        assert not kron.means_s.any()
        np.testing.assert_allclose(kron.eigvals.numpy(),
                                   naive.eigvals.numpy(), rtol=0, atol=bar)
        u = torch.from_numpy(rng.standard_normal(N * K)) * w
        _close(kron.screen_grad(u), naive.screen_grad(u))
        d = np.zeros(kron.S_cap)
        d[:kron.S_val] = rng.standard_normal(kron.S_val)
        _close(kron.screen_apply(torch.from_numpy(d)),
               naive.screen_apply(torch.from_numpy(d)))
        D = torch.from_numpy(np.stack([d, -2 * d, d[::-1].copy()]))
        D[:, kron.S_val:] = 0
        _close(kron.screen_apply_many(D), naive.screen_apply_many(D))
    # the intercept column is gathered once, for all K of its slots
    assert list(kron.ccols[:1]) == [0] and len(kron.ccols) == \
        len(set(kron.cols // K))


# --------------------------------------------------------------------------- #
# grpnet                                                                      #
# --------------------------------------------------------------------------- #


def _fit_both(X, family, y, **kw):
    js = ja.grpnet(X, getattr(ja.glm, family)(y, weights=kw.get("w")),
                   **{k: v for k, v in kw.items() if k != "w"})
    ts = ta.grpnet(X, getattr(ta.glm, family)(y, weights=kw.get("w")),
                   device="cpu", **{k: v for k, v in kw.items() if k != "w"})
    return js, ts


@pytest.fixture(scope="module")
def gaussian_fits():
    """The multigaussian, intercept and no intercept: user groups of size
    2 (flattened groups of 6), alpha 0.5, weights and (n, K) offsets."""
    rng, X, eta = _dense(7)
    y = _gaussian_y(rng, eta)
    w = rng.uniform(0.5, 1.5, N)
    offs = 0.1 * rng.standard_normal((N, K))
    kw = dict(groups=np.arange(0, P, 2), alpha=0.5, w=w, offsets=offs,
              lmda_path_size=15)
    pg.reset_newton()
    fits = {inter: _fit_both(X, "multigaussian", y, intercept=inter, **kw)
            for inter in (True, False)}
    return X, y, w, offs, fits, dict(pg.newton)


@pytest.mark.parametrize("intercept", [True, False])
def test_multigaussian_path(gaussian_fits, intercept):
    _, _, _, _, fits, newton = gaussian_fits
    js, ts = fits[intercept]
    _assert_multi_path(js, ts)
    assert ts.betas.shape[1] == P * K
    assert isinstance(ts._cache, KroneckerScreenCache)
    assert newton["updates"] > 0          # K6's twin on groups of 6


@pytest.fixture(scope="module")
def multinomial_fits():
    rng, X, eta = _dense(8)
    y = _multinomial_y(rng, eta)
    return X, y, _fit_both(X, "multinomial", y, lmda_path_size=15)


def test_multinomial_path(multinomial_fits):
    """The multinomial by IRLS: the per-class null model, then every IRLS
    iteration's per-class Grams (its classes' weights differ) and K6's
    twin (a column's K classes are one group of 3, qmax 4)."""
    js, ts = multinomial_fits[2]
    _assert_multi_path(js, ts)
    assert len(ts.benchmark["pin_caps"]) == sum(ts.benchmark["irls_iters"])
    assert ts._cache.G.shape[0] == K


def test_multigaussian_by_irls():
    """``opt=False``: the multigaussian by IRLS in user groups of 2, every
    class weighted alike (still one Gram a class)."""
    rng, X, eta = _dense(9)
    y = _gaussian_y(rng, eta)
    kw = dict(groups=np.arange(0, P, 2), lmda_path_size=15)
    js = ja.grpnet(X, ja.glm.multigaussian(y, opt=False), **kw)
    ts = ta.grpnet(X, ta.glm.multigaussian(y, opt=False), device="cpu",
                   **kw)
    _assert_multi_path(js, ts)
    assert sum(ts.benchmark["irls_iters"]) > 0
    assert ts._cache.G.shape[0] == K


_GAUSS_WS = ("screen_set", "screen_begins", "screen_beta", "screen_is_active",
             "lmda", "lmda_max", "X_means", "y_var", "rsq", "resid",
             "resid_sum", "grad", "abs_grad")
_GLM_WS = ("screen_set", "screen_begins", "screen_beta", "screen_is_active",
           "lmda", "lmda_max", "resid", "grad", "abs_grad", "eta",
           "loss_null", "loss_full")


def test_multigaussian_warm_start_continues_the_jax_path(gaussian_fits):
    """The first 6 lambdas fitted by adelie_tpu, its flattened state
    carried over with ``state_from_numpy`` and the rest of the path fitted
    by the port: the full JAX path's rest.  At ``tol = 1e-12``: at the
    default 1e-7 a path resumed at a lambda stops its coordinate descent
    elsewhere than the unbroken path (9.3e-6 apart in beta, the port
    resumed from its own state too).  The JAX package cannot resume a
    multi-response fit itself (its warm start leaves the group norms
    unset)."""
    X, y, w, offs, _, _ = gaussian_fits
    kw = dict(groups=np.arange(0, P, 2), alpha=0.5, offsets=offs, tol=1e-12)
    full = ja.grpnet(X, ja.glm.multigaussian(y, weights=w),
                     lmda_path_size=15, **kw)
    half = ja.grpnet(X, ja.glm.multigaussian(y, weights=w),
                     lmda_path=full.lmdas[:6], **kw)
    ws = state_from_numpy(
        {k: np.asarray(getattr(half, k)) for k in _GAUSS_WS}, device="cpu")
    ts = ta.grpnet(X, ta.glm.multigaussian(y, weights=w),
                   lmda_path=full.lmdas[6:], warm_start=ws, device="cpu",
                   **kw)
    assert ts.error == ""
    np.testing.assert_allclose(ts.lmdas, full.lmdas[6:], rtol=1e-10)
    np.testing.assert_allclose(ts.betas.toarray(), full.betas.toarray()[6:],
                               atol=1e-6)
    np.testing.assert_allclose(ts.intercepts,
                               np.asarray(full.intercepts)[6:], atol=1e-6)
    np.testing.assert_allclose(ts.devs, full.devs[6:], atol=1e-8)


def test_multinomial_warm_start_carries_the_jax_state(multinomial_fits):
    """The JAX multinomial path's last state (eta, the flattened residual
    and gradient, the null and saturated losses, the screen), carried over
    with ``state_from_numpy``, continued by the port to smaller lambdas:
    the same as the port's continuation of its own fit.  (Against an
    unbroken path the bar cannot hold: IRLS with the multinomial's
    diagonal Hessian bound converges slowly, so ``irls_tol`` stops a
    resumed path up to 1e-4 away from the unbroken one, in both
    packages.)"""
    X, y, fits = multinomial_fits
    js, ts = fits
    path = js.lmdas[-1] * np.array([0.8, 0.6, 0.45])
    conts = []
    for st in (js, ts):
        ws = state_from_numpy(
            {k: np.asarray(getattr(st, k)) for k in _GLM_WS}, device="cpu")
        conts.append(ta.grpnet(X, ta.glm.multinomial(y), lmda_path=path,
                               warm_start=ws, device="cpu"))
    a, b = conts
    assert a.error == b.error == "" and len(a.lmdas) == len(b.lmdas) == 3
    np.testing.assert_allclose(a.betas.toarray(), b.betas.toarray(),
                               atol=1e-6)
    np.testing.assert_allclose(a.intercepts, b.intercepts, atol=1e-6)
    np.testing.assert_allclose(a.devs, b.devs, atol=1e-8)
    assert a.devs[0] > ts.devs[-1]


@pytest.mark.parametrize("family", ["gaussian", "binomial"])
def test_single_response_on_a_kronecker_matrix(family):
    """A single-response fit on ``kronecker_eye(X, K)``: refused with the
    implicit intercept (the Kronecker screen block forms no centered
    Gram), and without it the same path as on the dense ``X (x) I_K``."""
    rng, X, _ = _dense(11)
    y = rng.standard_normal(N * K)
    if family == "binomial":
        y = (y > 0).astype(float)
    Xk = ta.matrix.kronecker_eye(ta.matrix.dense(X, device="cpu"), K)
    glm = getattr(ta.glm, family)
    with pytest.raises(NotImplementedError, match="intercept=True"):
        ta.grpnet(Xk, glm(y), device="cpu")
    kw = dict(intercept=False, lmda_path_size=10, device="cpu")
    tk = ta.grpnet(Xk, glm(y), **kw)
    td = ta.grpnet(np.kron(X, np.eye(K)), glm(y), **kw)
    assert isinstance(tk._cache, KroneckerScreenCache)
    assert tk.error == td.error == "" and len(tk.lmdas) == len(td.lmdas)
    np.testing.assert_allclose(tk.lmdas, td.lmdas, rtol=1e-10)
    np.testing.assert_allclose(tk.betas.toarray(), td.betas.toarray(),
                               atol=1e-10)
    np.testing.assert_allclose(tk.devs, td.devs, atol=1e-10)


def test_constraints_stay_refused():
    X = _dense(10)[1]
    with pytest.raises(NotImplementedError, match="constraints"):
        ta.grpnet(X, ta.glm.multigaussian(np.ones((N, K))),
                  constraints=[object()] * P, device="cpu")


def _snp_fits(jio, tio, family, y, streaming, port_only=False, **kw):
    jm = ja.matrix.snp_unphased(jio, streaming=streaming, tile_snps=8,
                                dtype=np.float64)
    tm = ta.matrix.snp_unphased(tio, streaming=streaming, tile_snps=8,
                                dtype=np.float64, device="cpu")
    js = None if port_only else ja.grpnet(jm, getattr(ja.glm, family)(y),
                                          **kw)
    ts = ta.grpnet(tm, getattr(ta.glm, family)(y), **kw)
    return jm, tm, js, ts


@pytest.mark.parametrize("family", ["multigaussian", "multinomial"])
def test_snp_multi_streamed_and_in_device(snp_panel, family):
    """The port's fit on the panel in device memory (K3's twin, K launches
    a gradient) against the JAX package's in-device fit; then the port's
    streamed fit over three tiles (K5's twin at C K columns).  The
    multigaussian's, with the default speculative union, against the JAX
    package's streamed fit, with the same passes over the panel; the
    multinomial's (the per-class null model, then optimistic IRLS chunks
    each certified by one pass) with the union off, which keeps the
    in-device driver's screens, against the JAX package's in-device fit:
    the JAX package's streamed multinomial takes 8 s more to compile, past
    this file's budget, and with the union on its screens part from the
    in-device fit's."""
    jio, tio, ys = snp_panel
    y = ys[family]
    kw = dict(lmda_path_size=6, min_ratio=0.1)
    before = dict(sk.launches)
    jd = ja.grpnet(ja.matrix.snp_unphased(jio, dtype=np.float64),
                   getattr(ja.glm, family)(y), **kw)
    td = ta.grpnet(ta.matrix.snp_unphased(tio, device="cpu"),
                   getattr(ta.glm, family)(y), **kw)
    _assert_multi_path(jd, td)
    assert isinstance(td._cache, KroneckerScreenCache)
    if family == "multigaussian":
        jm, tm, js, ts = _snp_fits(jio, tio, family, y, True, **kw)
        _assert_multi_path(js, ts)
        assert tm.sweeps == jm.sweeps > 2
        assert len(ts.benchmark["kkt"]) == len(js.benchmark["kkt"])
    else:
        set_configs("stream_speculative_union", False)
        try:
            tm, ts = _snp_fits(jio, tio, family, y, True, port_only=True,
                               **kw)[1::2]
        finally:
            set_configs("stream_speculative_union", None)
        assert tm.sweeps > 2
        _assert_multi_path(jd, ts, sizes=False)
    assert sk.launches == before               # twins on the CPU


# --------------------------------------------------------------------------- #
# the generators                                                              #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["dense", "snp_unphased",
                                  "snp_phased_ancestry"])
def test_generators_match_jax(case):
    args = {"dense": ((40, 12, 4), dict(K=3, glm="multinomial", seed=3)),
            "snp_unphased": ((50, 10), dict(K=2, glm="multigaussian",
                                            seed=4)),
            "snp_phased_ancestry": ((30, 4, 3), dict(K=3, glm="multinomial",
                                                     seed=5))}[case]
    dj = getattr(ja.data, case)(*args[0], **args[1])
    dt = getattr(ta.data, case)(*args[0], **args[1])
    np.testing.assert_array_equal(dt["glm"].y.numpy(),
                                  np.asarray(dj["glm"].y))
    assert dt["glm"].name == dj["glm"].name and dt["glm"].is_multi
    for key in ("X", "y", "beta", "ancestries", "groups", "group_sizes",
                "penalty"):
        if key in dj and dj[key] is not None:
            np.testing.assert_array_equal(dt[key], dj[key])
    if case == "dense":
        with pytest.raises(ValueError, match="multi-response"):
            ta.data.dense(40, 12, 4, K=2, glm="binomial")
