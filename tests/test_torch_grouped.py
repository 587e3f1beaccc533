"""Groups of size > 1: adelie_tpu_torch against adelie_tpu, float64 on the
CPU.

The same numpy inputs go through both packages; the port runs K6's twin
(``solver/pin_group_kernels.py``) for every pin solve whose screen holds a
group of size > 1.  Bars: ``screen_eigh``'s eigenvalues and blocks at 1e-12;
one pin solve's coefficients at 1e-10 with equal active flags; ``grpnet``
paths at the reference's bars (``test_torch_grpnet._assert_same_path``:
lambdas rtol 1e-10, coefficients atol 1e-6, deviances and intercepts atol
1e-8, equal screen and active sizes); ``data.dense``'s arrays equal.  The
JAX package's grouped fits are shared in module-scoped fixtures: each
traces its own programs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adelie_tpu as ja
import adelie_tpu_torch as ta
import adelie_tpu_torch.bcd as tb
from adelie_tpu.configs import set_configs as ja_set_configs
from adelie_tpu.solver.pin import pin_cov_solve as jax_pin_cov_solve
from adelie_tpu.solver.pin import screen_eigh as jax_screen_eigh
from adelie_tpu_torch.configs import set_configs
from adelie_tpu_torch.solver import pin as tpin
from adelie_tpu_torch.solver import pin_group_kernels as pg
from adelie_tpu_torch.solver import pin_kernels as tk
from adelie_tpu_torch.solver.state_core import (abs_grad_kernel, group_cols,
                                                group_sum)
from adelie_tpu_torch.state import state_from_numpy
from test_torch_bcd import full_walk
from test_torch_grpnet import _WS_KEYS, _assert_same_path

torch.set_num_threads(1)
t = torch.from_numpy


# --------------------------------------------------------------------------- #
# data.dense                                                                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("equal_groups", [True, False])
def test_dense_generator_matches_jax(equal_groups):
    kw = dict(equal_groups=equal_groups, rho=0.3, zero_penalty=0.1, seed=5)
    dj = ja.data.dense(50, 40, 12, **kw)
    dt = ta.data.dense(50, 40, 12, **kw)
    np.testing.assert_array_equal(dt["X"], dj["X"])
    np.testing.assert_array_equal(dt["glm"].y.numpy(), np.asarray(dj["glm"].y))
    for key in ("groups", "group_sizes", "penalty"):
        np.testing.assert_array_equal(dt[key], dj[key])
    assert dt["X"].flags.f_contiguous
    with pytest.raises(NotImplementedError, match="queue 5"):
        ta.data.dense(50, 40, 12, glm="binomial")


# --------------------------------------------------------------------------- #
# the screen's blocks and one pin solve                                       #
# --------------------------------------------------------------------------- #


def _blocks(qmax, seed, n=80):
    """A Gram of mixed-size groups (1 .. qmax, one of each end), one block
    rank-deficient, two invalid slots; S leaves the qmax margin the JAX
    package's slices need."""
    rng = np.random.default_rng(seed)
    sizes = list(rng.integers(1, qmax + 1, size=8)) + [1, qmax]
    sizes = np.asarray(sizes)
    begins = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    S_val = int(sizes.sum())
    S = S_val + qmax
    X = rng.standard_normal((n, S))
    X[:, S_val:] = 0.0
    k = int(np.flatnonzero(sizes >= 2)[0])
    X[:, begins[k] + 1] = X[:, begins[k]]
    A = X.T @ X / n
    y = X[:, :6] @ rng.standard_normal(6) + 0.3 * rng.standard_normal(n)
    grad = X.T @ y / n
    slot_begin = np.concatenate([begins, [0, 0]]).astype(np.int64)
    slot_size = np.concatenate([sizes, [0, 0]]).astype(np.int32)
    return A, grad, slot_begin, slot_size, begins, sizes


@pytest.mark.parametrize("qmax", [2, 4, 8])
def test_screen_eigh_matches_jax(qmax):
    """Eigenvalues within 1e-12 of the JAX package's (clamped at 0, the
    rank-deficient block's zero among them); V diag(lam) V^T within 1e-12
    of each block, zero-padded past its size (V's signs are free)."""
    A, _, sb, ss, begins, sizes = _blocks(qmax, seed=qmax)
    lam, V = tpin.screen_eigh(t(A), t(sb), t(ss), qmax)
    lj, _ = jax_screen_eigh(jnp.asarray(A), jnp.asarray(sb), jnp.asarray(ss),
                            qmax)
    assert lam.shape == (len(ss), qmax) and V.shape == (len(ss), qmax, qmax)
    assert V.is_contiguous()
    np.testing.assert_allclose(lam.numpy(), np.asarray(lj), rtol=0,
                               atol=1e-12)
    assert (lam >= 0).all() and (lam[:, 0] < 1e-12).any()
    rec = (V * lam[:, None, :]) @ V.transpose(1, 2)
    for i, (b, q) in enumerate(zip(begins, sizes)):
        want = np.zeros((qmax, qmax))
        want[:q, :q] = A[b:b + q, b:b + q]
        np.testing.assert_allclose(rec[i].numpy(), want, rtol=0, atol=1e-12)
    assert (lam[-2:] == 0).all()


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("qmax", [2, 4, 8])
def test_twin_solve_matches_jax_pin_cov_solve(qmax, alpha):
    """K6's twin through ``pin_cov_solve`` against the JAX package's
    grouped solve on the same eigendecomposition: mixed sizes (a group of
    size 1 takes the Newton update), a zero eigenvalue, a zero penalty,
    alpha 1 and 0.5.  Coefficients within 1e-10, equal active flags, the
    same sweeps."""
    A, grad, sb, ss, begins, sizes = _blocks(qmax, seed=10 + qmax)
    G = len(ss)
    pen = np.concatenate([np.sqrt(sizes), [1.0, 1.0]])
    pen[3] = 0.0
    act = np.zeros(G, bool)
    act[3] = True
    norms = [np.linalg.norm(grad[b:b + q]) / p
             for b, q, p in zip(begins, sizes, pen) if p > 0]
    lmda = 0.3 * max(norms) / alpha
    ev, V = jax_screen_eigh(jnp.asarray(A), jnp.asarray(sb), jnp.asarray(ss),
                            qmax)
    beta0 = np.zeros(A.shape[0])
    out_x = jax_pin_cov_solve(
        jnp.asarray(A), jnp.asarray(grad), jnp.asarray(beta0),
        jnp.asarray(sb), jnp.asarray(ss), ev, V, jnp.asarray(pen),
        jnp.asarray(act), lmda, alpha, 1e-12, 1e-12, 1e-12, 1000, 100000,
        0.0)
    before = dict(pg.launches)
    beta, grad_n, act_t, rsq, iters, done = tpin.pin_cov_solve(
        t(A), t(grad), t(beta0), t(sb), t(ss), t(np.array(ev)),
        t(np.array(V)), t(pen), t(act), lmda, alpha, 1e-12, 1e-12, 1e-12,
        1000, 100000, 0.0)
    assert pg.launches == before
    np.testing.assert_allclose(beta.numpy(), np.asarray(out_x[0]), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(grad_n.numpy(), np.asarray(out_x[1]), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(act_t.numpy(), np.asarray(out_x[2]))
    assert abs(rsq - float(out_x[3])) <= 1e-10
    assert iters == int(out_x[4]) and done and bool(out_x[5])
    assert act_t.sum() >= 2 and beta[begins[3]] != 0


def test_wrapper_refuses_other_devices_and_counts_no_twin():
    """The twin runs for CPU tensors and is no launch; a tensor neither on
    the CPU nor on CUDA gets no twin."""
    m = dict(device="meta")
    v = torch.empty(4, **m)
    args = (torch.empty((4, 4), **m), v, v, torch.empty(2, dtype=torch.int64,
            **m), torch.empty(2, dtype=torch.int32, **m),
            torch.empty((2, 2), **m), torch.empty((2, 2, 2), **m),
            torch.empty(2, **m), torch.empty(2, dtype=torch.bool, **m))
    with pytest.raises(ValueError, match="no kernel or twin"):
        pg.pin_group_solve(*args, 0.1, 1.0, 1e-7, 1e-12, 1e-12, 1000, 10, 0.0)


# --------------------------------------------------------------------------- #
# deterministic group norms                                                   #
# --------------------------------------------------------------------------- #


def _fold(x):
    """numpy per-group sum in the fixed order: zero-pad to a power of 2,
    fold in halves."""
    Q = 1
    while Q < len(x):
        Q *= 2
    x = np.concatenate([x, np.zeros(Q - len(x), x.dtype)])
    while len(x) > 1:
        x = x[:len(x) // 2] + x[len(x) // 2:]
    return x[0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_group_norms_equal_a_numpy_sum_bit_for_bit(dtype):
    """``abs_grad_kernel`` (the in-device KKT's group norms) and
    ``group_sum`` over (p, C) (the streamed KKT's) equal a numpy per-group
    sum in the documented order to the last bit; at q = 1 a group's sum
    is its entry."""
    rng = np.random.default_rng(0)
    p = 37
    groups = np.array([0, 1, 6, 9, 10, 17, 22, 30])
    sizes = np.diff(np.concatenate([groups, [p]]))
    grad = rng.standard_normal(p).astype(dtype)
    pen_cols = np.repeat(rng.uniform(0.5, 1.5, len(groups)), sizes) \
        .astype(dtype)
    cols_padded = np.array([6, 7, 8, -1, 22, 23, 24, 25, 26, -1], np.int64)
    beta_padded = rng.standard_normal(10).astype(dtype)
    cols = t(group_cols(groups, sizes, p))
    assert cols.shape == (len(groups), 8)
    l2 = 0.7
    got = abs_grad_kernel(t(grad), t(cols_padded), t(beta_padded),
                          t(pen_cols), cols, l2).numpy()
    beta_cols = np.zeros(p, dtype)
    ok = cols_padded >= 0
    beta_cols[cols_padded[ok]] = beta_padded[ok]
    gadj = grad - dtype(l2) * (pen_cols * beta_cols)
    want = np.asarray([np.sqrt(_fold((gadj * gadj)[g:g + q]))
                       for g, q in zip(groups, sizes)], dtype)
    np.testing.assert_array_equal(got, want)
    M = rng.standard_normal((p, 3)).astype(dtype)
    got2 = group_sum(t(M), cols).numpy()
    want2 = np.stack([[_fold(M[g:g + q, c]) for c in range(3)]
                      for g, q in zip(groups, sizes)])
    np.testing.assert_array_equal(got2, want2)
    ones = t(group_cols(np.arange(p), np.ones(p, int), p))
    assert torch.equal(group_sum(t(M), ones), t(M))


# --------------------------------------------------------------------------- #
# grpnet                                                                      #
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def equal_fits():
    """Screen-all (p + qmax <= 1024): data.dense with 20 groups of 3, the
    JAX package's fits with and without the intercept."""
    d = ja.data.dense(100, 60, 20, equal_groups=True, seed=21)
    kw = dict(groups=d["groups"], penalty=d["penalty"], lmda_path_size=30)
    y = np.asarray(d["glm"].y)
    return d, y, kw, {ic: ja.grpnet(d["X"], ja.glm.gaussian(y), intercept=ic,
                                    **kw) for ic in (True, False)}


@pytest.mark.parametrize("intercept", [True, False])
def test_grouped_screen_all(intercept, equal_fits):
    d, y, kw, js = equal_fits
    before = dict(pg.launches)
    pg.reset_newton()
    ts = ta.grpnet(d["X"], ta.glm.gaussian(y), intercept=intercept,
                   device="cpu", **kw)
    _assert_same_path(js[intercept], ts)
    assert ts.screen_sizes[0] == 20 and max(ts.active_sizes) > 3
    assert pg.launches == before
    assert pg.newton["solves"] > 0 and pg.newton["iters"] > 0


def test_grouped_warm_start(equal_fits):
    """The first 10 lambdas fitted in the port, carried over with
    state_from_numpy and finished there: the JAX package's full path to
    the bars.  A warm start fitted with other groups is refused."""
    d, y, kw, js = equal_fits
    full = js[True]
    base = dict(groups=d["groups"], penalty=d["penalty"], device="cpu")
    half = ta.grpnet(d["X"], ta.glm.gaussian(y), lmda_path=full.lmdas[:10],
                     **base)
    ws = state_from_numpy({k: np.asarray(getattr(half, k)) for k in _WS_KEYS},
                          device="cpu")
    rest = ta.grpnet(d["X"], ta.glm.gaussian(y), lmda_path=full.lmdas[10:],
                     warm_start=ws, **base)
    assert half.error == rest.error == ""
    np.testing.assert_allclose(rest.lmdas, full.lmdas[10:], rtol=1e-10)
    np.testing.assert_allclose(rest.betas.toarray(),
                               full.betas.toarray()[10:], atol=1e-6)
    np.testing.assert_allclose(rest.devs, full.devs[10:], atol=1e-8)
    with pytest.raises(ValueError, match="different grouping"):
        ta.grpnet(d["X"], ta.glm.gaussian(y), lmda_path=full.lmdas[10:],
                  warm_start=ws, device="cpu")


def test_grouped_basil_unequal_groups():
    """BASIL (p + qmax > 1024): n = 60, p = 1,101 in 401 groups of unequal
    sizes (data.dense), with the intercept."""
    d = ja.data.dense(60, 1101, 401, equal_groups=False, seed=22)
    y = np.asarray(d["glm"].y)
    kw = dict(groups=d["groups"], penalty=d["penalty"], lmda_path_size=8)
    js = ja.grpnet(d["X"], ja.glm.gaussian(y), **kw)
    ts = ta.grpnet(d["X"], ta.glm.gaussian(y), device="cpu", **kw)
    _assert_same_path(js, ts)
    assert max(ts.screen_sizes) < 401 and d["group_sizes"].max() > 1


def test_grpnet_uses_the_newton_knobs():
    """``newton_max_iters`` and ``newton_tol`` reach the block updates: a
    cap of 1 step changes the histogram's last bin; the default meets
    newton_tol."""
    d = ta.data.dense(80, 24, 8, equal_groups=True, seed=23)
    kw = dict(groups=d["groups"], lmda_path_size=8, device="cpu")
    hists = []
    for cap in (1000, 1):
        pg.reset_newton()
        st = ta.grpnet(d["X"], d["glm"], newton_max_iters=cap, **kw)
        assert st.error == ""
        hists.append(list(pg.newton["hist"]))
    assert hists[0][-1] == 0 and hists[1][-1] > 0


def test_grouped_float32_newton_counts_match_the_full_walks(monkeypatch):
    """A float32 grouped fit on the CPU, where a third of the root finds
    reach newton_max_iters and end by the cycle rule: the steps run are at
    most ``newton["iters"]`` and the cycle exits at most the finds at the
    cap; the updates, finds, ``newton["iters"]``, histogram and the whole
    path equal, bit for bit, a fit whose walks run in full (``bcd``'s walk
    replaced by one with no exit)."""
    d = ta.data.dense(200, 40, 10, equal_groups=True, seed=23)
    X = np.asfortranarray(d["X"], dtype=np.float32)
    y = d["glm"].y.numpy().astype(np.float32)
    kw = dict(groups=d["groups"], lmda_path_size=8, device="cpu")
    fits = []
    for exit_rule in (True, False):
        if not exit_rule:
            def walk(buf1, v, l1, h0, tol, max_iters):
                h, iters, _ = full_walk(buf1, v, l1, h0, tol, max_iters)
                return h, iters, iters, False
            monkeypatch.setattr(tb, "_newton_phase", walk)
        pg.reset_newton()
        st = ta.grpnet(X, ta.glm.gaussian(y), **kw)
        assert st.error == "" and st.betas.dtype == np.float32
        fits.append((st, {k: (list(v) if isinstance(v, list) else v)
                          for k, v in pg.newton.items()}))
    (st, got), (st_full, want) = fits
    capped = got["hist"][-1]
    assert 0 < got["cycle_exits"] <= capped
    assert got["steps_run"] < got["iters"]
    assert want["cycle_exits"] == 0 and want["steps_run"] == want["iters"]
    for key in ("updates", "solves", "iters", "hist"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(st.lmdas, st_full.lmdas)
    np.testing.assert_array_equal(st.betas.toarray(), st_full.betas.toarray())


def _phased_io(tmp_path, n, s, A, seed):
    d = ja.data.snp_phased_ancestry(n, s, A, seed=seed)
    f = str(tmp_path / "grouped.snpdat")
    ja.io.snp_phased_ancestry(f).write(d["X"], d["ancestries"], A)
    return (ja.io.snp_phased_ancestry(f).read(),
            ta.io.snp_phased_ancestry(f).read(), d)


def test_grouped_phased_snp_in_device(tmp_path):
    """The in-device phased-ancestry matrix grouped one SNP a group
    (columns s A + a), K4's and K6's twins."""
    A = 3
    jio, tio, d = _phased_io(tmp_path, 120, 20, A, seed=24)
    kw = dict(groups=A * np.arange(20), lmda_path_size=15)
    js = ja.grpnet(ja.matrix.snp_phased_ancestry(jio),
                   ja.glm.gaussian(d["y"]), **kw)
    ts = ta.grpnet(ta.matrix.snp_phased_ancestry(tio, device="cpu"),
                   ta.glm.gaussian(d["y"]), **kw)
    _assert_same_path(js, ts)
    assert max(ts.active_sizes) > 1


def test_grouped_streamed_unphased(tmp_path):
    """The host-streamed unphased panel (``tile_snps=256``, three tiles,
    the last ragged) in groups of 2 and 3, with ``screen_all_max = 0`` in
    both packages: BASIL, the streamed KKT's group norms and K6's twin;
    the same passes over the panel."""
    n, p = 100, 600
    dj = ja.data.snp_unphased(n, p, missing_ratio=0.1, seed=25)
    f = str(tmp_path / "s.snpdat")
    ja.io.snp_unphased(f).write(dj["X"])
    groups = np.cumsum([0] + [2, 3] * 120)[:-1]
    assert np.diff(np.append(groups, p)).min() == 2 and groups[-1] == p - 3
    kw = dict(groups=groups, lmda_path_size=6, min_ratio=0.1)
    ja_set_configs("screen_all_max", 0)
    set_configs("screen_all_max", 0)
    try:
        jm = ja.matrix.snp_unphased(ja.io.snp_unphased(f).read(),
                                    streaming=True, tile_snps=256,
                                    dtype=np.float64)
        tm = ta.matrix.snp_unphased(ta.io.snp_unphased(f).read(),
                                    streaming=True, tile_snps=256,
                                    dtype=np.float64, device="cpu")
        js = ja.grpnet(jm, ja.glm.gaussian(dj["y"]), **kw)
        ts = ta.grpnet(tm, ta.glm.gaussian(dj["y"]), **kw)
    finally:
        ja_set_configs("screen_all_max", None)
        set_configs("screen_all_max", None)
    _assert_same_path(js, ts)
    assert tm.sweeps == jm.sweeps and tm._ntiles == 3
    assert tk.launches == {"pin_lasso_solve": 0, "pin_lasso_solve_rows": 0}
