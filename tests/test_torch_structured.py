"""Structured and user matrices of adelie_tpu_torch against adelie_tpu,
float64 on the CPU.

The same numpy inputs, made from a seed, build each matrix in both
packages: ``standardize``, ``subset`` (both axes, with repeated indices),
``concatenate(axis=0)``, the naive ``block_diag``, the naive ``sparse``
(padded and dense layouts), ``one_hot``, ``interaction``, ``convex_relu``
and ``convex_gated_relu`` (dense and sparse Z) and a user's subclass of
``MatrixNaiveBase``.  Bars: every product, ``mean`` and ``var`` within
1e-12 relative of the JAX package's and of the dense equivalent's;
``grpnet`` paths at the parity bar (ROADMAP.md: lambdas to rtol 1e-10,
coefficients within 1e-6, deviances and intercepts within 1e-8, equal
screen and active sizes).  The JAX fits are module-scoped.
"""

import inspect

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import adelie_tpu as ja
import adelie_tpu_torch as ta
from adelie_tpu_torch.state import state_from_numpy
from test_torch_grpnet import _WS_KEYS, _assert_same_path
from test_user_extension import ScaledDense as JaxScaledDense

torch.set_num_threads(1)
t = torch.from_numpy


class ScaledDense(ta.matrix.MatrixNaiveBase):
    """The JAX package's test user matrix ``M diag(s)``, in torch: only
    ``mul``, ``gather`` and ``tmul``."""

    def __init__(self, M, scales, device="cpu"):
        self.device = torch.device(device)
        self._M = torch.as_tensor(M, device=self.device)
        self._s = torch.as_tensor(scales, dtype=self._M.dtype,
                                  device=self.device)
        self._rows, self._cols = M.shape
        self.torch_dtype = self._M.dtype
        self.dtype = np.dtype(str(self._M.dtype).replace("torch.", ""))

    def mul(self, v, w):
        return self._s * ((v * w) @ self._M)

    def gather(self, indices):
        idx = torch.as_tensor(indices, device=self.device).long()
        return self._M[:, idx] * self._s[idx]

    def tmul(self, beta):
        beta = torch.as_tensor(beta, dtype=self.torch_dtype,
                               device=self.device)
        s = self._s if beta.dim() == 1 else self._s[:, None]
        return self._M @ (s * beta)


def _levels_data(rng, n, levels):
    Z = rng.standard_normal((n, len(levels)))
    for g, L in enumerate(levels):
        if L > 0:
            Z[:, g] = rng.integers(0, L, n)
    return Z


def _one_hot_dense(Z, levels):
    from test_matrix_structured import _one_hot_dense as f
    return f(Z, levels)


def _interaction_dense(Z, pairs, levels):
    from test_matrix_structured import _interaction_dense as f
    return f(Z, pairs, levels)


def _relu_dense(Z, mask, gated):
    Zd = Z.toarray() if sp.issparse(Z) else Z
    Y = np.concatenate([mask[:, [k]] * Zd for k in range(mask.shape[1])], 1)
    return Y if gated else np.concatenate([Y, -Y], 1)


ONE_HOT_LEVELS = np.array([0, 3, 0, 4, 2, 0])


def build(kind, n=60, seed=0):
    """``(jax matrix, port matrix, dense equivalent)`` of ``kind``, from
    one seed."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 9)) * rng.uniform(0.5, 3, 9) \
        + rng.uniform(-2, 2, 9)
    cpu = dict(device="cpu")
    if kind == "standardize":
        c, s = X.mean(0), X.std(0)
        return (ja.matrix.standardize(X), ta.matrix.standardize(X, **cpu),
                (X - c) / s)
    if kind == "standardize_ddof":
        c = np.median(X, 0)
        s = np.sqrt(((X - c) ** 2).sum(0) / (n - 1))
        return (ja.matrix.standardize(X, centers=c, ddof=1),
                ta.matrix.standardize(X, centers=c, ddof=1, **cpu),
                (X - c) / s)
    if kind == "csubset":
        idx = np.array([3, 0, 7, 3, 8, 1])
        return (ja.matrix.subset(X, idx, axis=1),
                ta.matrix.subset(X, idx, axis=1, **cpu), X[:, idx])
    if kind == "wrappers":
        # the naive block-diagonal matrix of a row subset (a repeated row)
        # and a row concatenation
        idx = np.concatenate([rng.permutation(n)[:40], [4, 4]])
        A, B = X[:, :5], X[:, 5:]
        D = np.zeros((len(idx) + n, 9))
        D[:len(idx), :5], D[len(idx):, 5:] = A[idx], B
        mats = [(pkg.matrix.subset(A, idx, axis=0, **kw),
                 pkg.matrix.concatenate([B[:30], B[30:]], axis=0, **kw))
                for pkg, kw in ((ja, {}), (ta, cpu))]
        return (ja.matrix.block_diag(list(mats[0])),
                ta.matrix.block_diag(list(mats[1]), **cpu), D)
    if kind in ("sparse_padded", "sparse_dense"):
        Zs = X * (rng.uniform(size=X.shape) < 0.3)
        Zs[:, 2] = 0.0
        Zs[5] = 0.0
        layout = kind.split("_")[1]
        return (ja.matrix.sparse(sp.csc_matrix(Zs), layout=layout),
                ta.matrix.sparse(sp.csc_matrix(Zs), layout=layout, **cpu),
                Zs)
    if kind == "one_hot":
        levels = ONE_HOT_LEVELS
        Z = _levels_data(rng, n, levels)
        return (ja.matrix.one_hot(Z, levels),
                ta.matrix.one_hot(Z, levels, **cpu),
                _one_hot_dense(Z, levels))
    if kind == "interaction":
        levels = np.array([0, 3, 0, 2, 2])
        Z = _levels_data(rng, n, levels)
        imap = {0: None, 1: [2, 3, 4], 3: [4]}
        jm = ja.matrix.interaction(Z, imap, levels)
        return (jm, ta.matrix.interaction(Z, imap, levels, **cpu),
                _interaction_dense(Z, jm.pairs, levels))
    if kind.startswith("relu"):
        _, form, zkind = kind.split("_")
        Z = X[:, :4]
        if zkind == "sparse":
            Z = sp.csc_matrix(Z * (rng.uniform(size=Z.shape) < 0.4))
        mask = rng.uniform(size=(n, 3)) < 0.5
        gated = form == "gated"
        return (ja.matrix.convex_relu(Z, mask, gated=gated),
                ta.matrix.convex_relu(Z, mask, gated=gated, **cpu),
                _relu_dense(Z, mask, gated))
    if kind == "user":
        s = rng.uniform(0.5, 2.0, 9)
        return JaxScaledDense(X, s), ScaledDense(X, s), X * s
    if kind == "standardize_one_hot":
        levels = np.array([0, 3, 0, 2])
        Z = _levels_data(rng, n, levels)
        D = _one_hot_dense(Z, levels)
        c = D.mean(0)
        c[[1, 2, 3, 5, 6]] = 0.0
        s = np.sqrt(((D - c) ** 2).mean(0))
        s[[1, 2, 3, 5, 6]] = 1.0
        return (None,
                ta.matrix.standardize(ta.matrix.one_hot(Z, levels, **cpu)),
                (D - c) / s)
    raise ValueError(kind)


# the full ReLU matrix calls the gated one's products, so two kinds cover
# both forms on both Zs; "wrappers" holds the row subset, the row
# concatenation and the naive block-diagonal matrix in one; standardize of
# a one-hot matrix (its indicators left as they are) is held against its
# dense equivalent only
KINDS = ["standardize", "standardize_ddof", "csubset", "wrappers",
         "sparse_padded", "sparse_dense", "one_hot", "interaction",
         "relu_gated_dense", "relu_full_sparse", "user",
         "standardize_one_hot"]


def _close(a, b):
    """Within 1e-12 relative of ``b``'s largest entry."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-300)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("kind", KINDS)
def test_products(kind):
    """Every product against the JAX package's and the dense
    equivalent's; ``mean`` and ``var`` where the class defines them."""
    jm, tm, D = build(kind)
    n, p = D.shape
    assert tm.shape == (n, p) and tm.dtype == np.float64
    rng = np.random.default_rng(1)
    v, w = rng.standard_normal(n), rng.uniform(0.1, 1.0, n)
    w /= w.sum()
    beta = rng.standard_normal(p)
    B = rng.standard_normal((p, 3))
    idx = rng.choice(p, min(p, 7), replace=False)
    outs = [(tm.mul(t(v), t(w)), D.T @ (w * v), lambda: jm.mul(v, w)),
            (tm.tmul(t(beta)), D @ beta, lambda: jm.tmul(beta)),
            (tm.gather(t(idx)), D[:, idx], lambda: jm.gather(idx)),
            (tm.sq_mul(t(w)), (D * D).T @ w, lambda: jm.sq_mul(w))]
    if kind != "interaction":
        c = D.T @ w
        var = ((D - c) ** 2).T @ w
        if kind == "one_hot":
            # mean 0 and var 1 on indicator columns
            disc = np.repeat(ONE_HOT_LEVELS > 0,
                             np.maximum(ONE_HOT_LEVELS, 1))
            c[disc], var[disc] = 0.0, 1.0
        outs += [(tm.mean(t(w)), c, lambda: jm.mean(w)),
                 (tm.var(t(c), t(w)), var, lambda: jm.var(c, w))]
    for got, dense, jax_out in outs:
        _close(got.numpy(), dense)
        if jm is not None:
            _close(got.numpy(), np.asarray(jax_out()))
    _close(tm.tmul(t(B)).numpy(), D @ B)
    _close(tm.to_dense(), D)
    if kind == "interaction":
        with pytest.raises(NotImplementedError, match="centers"):
            tm.mean(t(w))
        with pytest.raises(NotImplementedError, match="scales"):
            tm.var(t(v), t(w))


def test_reference_products_and_sugar():
    """The reference's column and block products, ``@``, ``.T @``,
    ``[...]`` and ``sp_tmul`` of a user matrix against its dense
    equivalent, as tests/test_user_extension.py holds the JAX package's
    (numpy out where the JAX package gives numpy)."""
    _, tm, D = build("user")
    rng = np.random.default_rng(2)
    n, p = D.shape
    v, w = rng.standard_normal(n), rng.uniform(0.1, 1.0, n)
    sw = np.sqrt(w)
    Bs = sp.random(3, p, density=0.3, random_state=1, format="csr")
    for got, ref in ((tm.cmul(4, v, w), D[:, 4] @ (w * v)),
                     (tm.ctmul(4, t(v)), v * D[:, 4]),
                     (tm.bmul(2, 5, v, w), D[:, 2:7].T @ (w * v)),
                     (tm.btmul(2, 5, np.ones(5)), D[:, 2:7] @ np.ones(5)),
                     (tm.cov(1, 4, sw), (D[:, 1:5] * w[:, None]).T
                      @ D[:, 1:5]),
                     (tm.sp_tmul(Bs), Bs.toarray() @ D.T)):
        _close(got.numpy(), ref)
    beta = rng.standard_normal(p)
    U = rng.standard_normal((n, 2))
    for got, ref in ((tm @ beta, D @ beta), (tm.T @ v, D.T @ v),
                     (tm.T @ U, D.T @ U), (tm[3:7, 2], D[3:7, [2]]),
                     (tm[:, [1, 5]], D[:, [1, 5]])):
        assert isinstance(got, np.ndarray)
        _close(got, ref)
    assert tm.T.shape == (p, n) and tm.T.T is tm and tm.ndim == 2
    assert ta.matrix.PyMatrixNaiveBase is ta.matrix.MatrixNaiveBase
    with pytest.raises(ValueError, match="1 or 2"):
        tm.T @ np.ones((2, 2, 2))


def test_sq_mul_gathers_chunks():
    """A user matrix's ``sq_mul`` (and ``var``, and so ``standardize``)
    gathers at most 4,096 columns at a time, and equals the dense one."""
    rng = np.random.default_rng(3)
    M = rng.standard_normal((6, 9000))
    s = rng.uniform(0.5, 2.0, 9000)
    tm = ScaledDense(M, s)
    asked = []
    inner = tm.gather
    tm.gather = lambda idx: (asked.append(len(idx)), inner(idx))[1]
    w = rng.uniform(0.1, 1.0, 6)
    D = M * s
    _close(tm.sq_mul(t(w)).numpy(), (D * D).T @ w)
    assert asked == [4096, 4096, 808]
    S = ta.matrix.standardize(tm)
    _close(S.scales.numpy(), D.std(0))
    assert max(asked) == 4096


def test_fixed_sums_and_layouts():
    """The padded planes' and repeated indices' sums; the sparse layouts
    ``auto`` picks, as the JAX package picks them; what stays refused."""
    rng = np.random.default_rng(4)
    n, p = 4000, 2000
    rows = np.repeat(np.arange(n), 2)
    cols = np.concatenate([np.arange(n) % p, (np.arange(n) + 7) % p])
    Zu = sp.csc_matrix((rng.standard_normal(2 * n), (rows, cols)),
                       shape=(n, p))
    Zd = np.where(rng.uniform(size=(60, 10)) < 0.2,
                  rng.standard_normal((60, 10)), 0.0)
    Zs = np.zeros((6000, 1000))
    Zs[:, 0] = rng.standard_normal(6000)
    Zs[0, 1] = 1.0
    for Z in (Zu, sp.csc_matrix(Zd), sp.csc_matrix(Zs)):
        assert (ta.matrix.sparse(Z, device="cpu").layout
                == ja.matrix.sparse(Z).layout)
    with pytest.raises(ValueError, match="bcoo"):
        ta.matrix.sparse(Zd, layout="bcoo", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        ta.matrix.sparse(Zd, layout="padddded", device="cpu")
    with pytest.raises(ValueError, match="axis"):
        ta.matrix.concatenate([Zd, Zd], axis=2, device="cpu")
    with pytest.raises(ValueError, match="integers"):
        ta.matrix.one_hot(np.array([[0.0], [3.0]]), [3], device="cpu")
    # a row subset repeating rows: X[idx]^T u sums the repeats
    X = rng.standard_normal((8, 3))
    idx = np.array([5, 5, 5, 0, 7, 5])
    R = ta.matrix.subset(X, idx, axis=0, device="cpu")
    u = rng.standard_normal(6)
    _close(R.mul(t(u), torch.ones(6, dtype=torch.float64)).numpy(),
           X[idx].T @ u)


_PATH_KW = dict(lmda_path_size=12, min_ratio=0.05)
# a family a path; the row subset, the row concatenation and the naive
# block-diagonal matrix (one matrix of the three) have columns whose means
# are not zero, so they hold the screen Gram's centering with the intercept
PATH_KINDS = ["standardize", "wrappers", "sparse_padded", "one_hot",
              "interaction", "relu_full_sparse", "user"]


def _path_problem(kind):
    jm, tm, D = build(kind, n=200, seed=5)
    rng = np.random.default_rng(6)
    n, p = D.shape
    beta = np.zeros(p)
    beta[rng.choice(p, min(p, 4), replace=False)] = [1.0, -0.8, 0.6, 0.5][
        :min(p, 4)]
    y = D @ beta + 0.3 * rng.standard_normal(n) + 1.0
    groups = np.asarray(jm.groups) if kind == "interaction" else None
    return jm, tm, y, dict(_PATH_KW, groups=groups)


@pytest.fixture(scope="module")
def jax_paths():
    out = {}
    for kind in PATH_KINDS:
        jm, _, y, kw = _path_problem(kind)
        out[kind] = ja.grpnet(jm, ja.glm.gaussian(y), **kw)
    return out


@pytest.mark.parametrize("kind", PATH_KINDS)
def test_path_matches_jax(kind, jax_paths):
    """``grpnet`` with the intercept through each family, as the JAX
    package fits it (the interaction's pairs as groups: K6's twin)."""
    _, tm, y, kw = _path_problem(kind)
    ts = ta.grpnet(tm, ta.glm.gaussian(y), device="cpu", **kw)
    _assert_same_path(jax_paths[kind], ts)
    assert len(ts.lmdas) > 3


def test_warm_start_on_one_hot(jax_paths):
    """The JAX package's state after 5 lambdas on a one-hot matrix, carried
    over with ``state_from_numpy``, continues in the port as the JAX
    package's full path does."""
    jm, tm, y, kw = _path_problem("one_hot")
    full = jax_paths["one_hot"]
    half = ja.grpnet(jm, ja.glm.gaussian(y), lmda_path=full.lmdas[:5])
    ws = state_from_numpy({k: np.asarray(getattr(half, k)) for k in _WS_KEYS},
                          device="cpu")
    rest = ta.grpnet(tm, ta.glm.gaussian(y), lmda_path=full.lmdas[5:],
                     warm_start=ws, device="cpu")
    assert half.error == rest.error == ""
    np.testing.assert_allclose(rest.lmdas, full.lmdas[5:], rtol=1e-10)
    np.testing.assert_allclose(rest.betas.toarray(),
                               full.betas.toarray()[5:], atol=1e-6)
    np.testing.assert_allclose(rest.devs, full.devs[5:], atol=1e-8)


_FACTORIES = ["standardize", "subset", "concatenate", "block_diag", "sparse",
              "one_hot", "interaction", "convex_relu", "convex_gated_relu"]


@pytest.mark.parametrize("name", _FACTORIES)
def test_factory_signatures(name):
    """Each factory takes the JAX package's keywords, with its defaults,
    and ``device``."""
    jp = inspect.signature(getattr(ja.matrix, name)).parameters
    tp = inspect.signature(getattr(ta.matrix, name)).parameters
    assert set(tp) - set(jp) == {"device"}
    assert set(jp) <= set(tp)
    for key in jp:
        assert tp[key].default == jp[key].default, key
        assert tp[key].kind == jp[key].kind, key
