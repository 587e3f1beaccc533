"""adelie_tpu_torch.gaussian_cov and the covariance matrices against
adelie_tpu, float64 on the CPU.

The same numpy inputs go through both packages; the port runs its pin
kernels' twins here.  Bars (ROADMAP.md's parity bar): equal path lengths,
lambdas to rtol 1e-10, coefficients to atol 1e-6, equal screen and active
sizes; the matrices' products against numpy to 1e-12.
"""

import numpy as np
import pytest
import torch

import adelie_tpu as ja
import adelie_tpu_torch as ta

torch.set_num_threads(1)

N, P = 120, 36


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((N, P))
    beta = np.zeros(P)
    beta[rng.choice(P, 6, replace=False)] = rng.standard_normal(6)
    y = X @ beta + 0.5 * rng.standard_normal(N)
    A = X.T @ X / N
    return dict(X=X, A=A, v=X.T @ y / N,
                As=np.where(np.abs(A) > 0.08, A, 0.0),
                blocks=[A[:12, :12], A[12:, 12:]],
                groups=np.arange(0, P, 3))


def _mats(problem, kind, pkg, **dev):
    A, X = problem["A"], problem["X"]
    m = pkg.matrix
    if kind == "dense":
        return m.dense(A, method="cov", **dev)
    if kind == "lazy":
        return m.lazy_cov(X / np.sqrt(N), **dev)
    if kind == "block_diag":
        return m.block_diag(problem["blocks"], method="cov", **dev)
    return m.sparse(problem["As"], method="cov", **dev)


def _dense_of(problem, kind):
    if kind == "block_diag":
        D = np.zeros((P, P))
        D[:12, :12], D[12:, 12:] = problem["blocks"]
        return D
    return problem["As"] if kind == "sparse" else problem["A"]


def _assert_same_path(js, ts):
    assert js.error == "" and ts.error == "", (js.error, ts.error)
    assert len(ts.lmdas) == len(js.lmdas) > 0
    np.testing.assert_allclose(ts.lmdas, js.lmdas, rtol=1e-10)
    np.testing.assert_allclose(ts.betas.toarray(), js.betas.toarray(),
                               atol=1e-6)
    np.testing.assert_allclose(ts.devs, js.devs, atol=1e-8)
    np.testing.assert_array_equal(ts.intercepts, 0.0)
    np.testing.assert_array_equal(ts.devs, ts.rsqs)
    assert list(ts.active_sizes) == list(js.active_sizes)
    assert list(ts.screen_sizes) == list(js.screen_sizes)


def _both(problem, kind, **kw):
    js = ja.gaussian_cov(_mats(problem, kind, ja), problem["v"], **kw)
    ts = ta.gaussian_cov(_mats(problem, kind, ta, device="cpu"),
                         problem["v"], **kw)
    return js, ts


@pytest.fixture
def basil():
    """Both packages screen from an empty set (BASIL) instead of
    screening every group of a small problem up front."""
    ja.set_configs("screen_all_max", 0)
    ta.set_configs("screen_all_max", 0)
    try:
        yield
    finally:
        ja.set_configs("screen_all_max", None)
        ta.set_configs("screen_all_max", None)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("screen_all", [True, False])
def test_dense_chunked(problem, request, grouped, screen_all):
    """A dense A: the chunked path (K1's twin, K6's for groups of 3)."""
    if not screen_all:
        request.getfixturevalue("basil")
    kw = dict(groups=problem["groups"]) if grouped else {}
    js, ts = _both(problem, "dense", lmda_path_size=30, **kw)
    _assert_same_path(js, ts)
    if screen_all:
        assert ts.screen_sizes[0] == len(kw.get("groups", range(P)))


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("kind", ["lazy", "block_diag", "sparse"])
def test_solve_core_matrices(problem, request, kind, grouped):
    """Lazy, block-diagonal and sparse A: basil.solve_core a lambda at a
    time, with the rdev early exit.  The lazy and sparse matrices grow
    their screens by BASIL; the block-diagonal one screens every group up
    front (the JAX package's block-diagonal products compile once for
    every screen size, which BASIL would make many)."""
    if kind != "block_diag":
        request.getfixturevalue("basil")
    kw = dict(groups=problem["groups"]) if grouped else {}
    js, ts = _both(problem, kind, lmda_path_size=12, **kw)
    _assert_same_path(js, ts)


def test_warm_start_and_user_path(problem, basil):
    """A user path in two pieces: the second continues the first's state
    (the rdev early exit off, so both walk their whole paths)."""
    path = np.geomspace(0.3, 0.01, 16)
    kw = dict(early_exit=False)
    j1 = ja.gaussian_cov(problem["A"], problem["v"], lmda_path=path[:8], **kw)
    t1 = ta.gaussian_cov(problem["A"], problem["v"], lmda_path=path[:8],
                         device="cpu", **kw)
    _assert_same_path(j1, t1)
    j2 = ja.gaussian_cov(problem["A"], problem["v"], lmda_path=path[8:],
                         warm_start=j1, **kw)
    t2 = ta.gaussian_cov(problem["A"], problem["v"], lmda_path=path[8:],
                         warm_start=t1, device="cpu", **kw)
    _assert_same_path(j2, t2)
    np.testing.assert_allclose(t2.lmdas, path[8:], rtol=1e-12)


@pytest.mark.parametrize("kind", ["dense", "lazy", "block_diag", "sparse"])
def test_cov_matrix_products(problem, kind):
    """``block``, ``mul``, ``bmul`` and ``to_dense`` against numpy, with
    rows and columns in any order (and a repeated row)."""
    D = _dense_of(problem, kind)
    m = _mats(problem, kind, ta, device="cpu")
    assert m.shape == (P, P) and m.device == torch.device("cpu")
    rows, cols = np.array([30, 2, 17, 2, 11]), np.array([5, 13, 35, 0])
    np.testing.assert_allclose(m.block(rows, cols).numpy(),
                               D[np.ix_(rows, cols)], atol=1e-12)
    vals = np.array([0.5, -1.0, 2.0, 0.25])
    np.testing.assert_allclose(m.mul(cols, torch.as_tensor(vals)).numpy(),
                               D[:, cols] @ vals, atol=1e-12)
    np.testing.assert_allclose(m.bmul(rows, cols, vals).numpy(),
                               (D[:, cols] @ vals)[rows], atol=1e-12)
    np.testing.assert_allclose(m.to_dense(), D, atol=1e-12)


def test_lazy_forms_columns_once(problem):
    """The lazy matrix forms each column once, into a buffer whose
    capacity doubles and never passes p."""
    m = ta.matrix.lazy_cov(problem["X"] / np.sqrt(N), device="cpu")
    m.block([0, 1], [3, 4, 3])
    assert m.n_formed == 2
    m.mul([4, 7], torch.ones(2, dtype=torch.float64))
    assert m.n_formed == 3 and m._buf.shape[1] == 16
    m.to_dense()
    assert m.n_formed == P and m._buf.shape[1] == P


def test_sparse_mul_is_deterministic(problem):
    """The sparse product sums without atomics: two calls, the same
    bits."""
    m = ta.matrix.sparse(problem["As"], method="cov", device="cpu")
    cols = np.arange(0, P, 2)
    vals = torch.as_tensor(np.random.default_rng(3).standard_normal(len(cols)))
    a, b = m.mul(cols, vals), m.mul(cols, vals)
    assert torch.equal(a, b)


def test_eager_cov_and_dtypes(problem):
    A = ta.matrix.eager_cov(problem["X"], device="cpu")
    np.testing.assert_allclose(A.to_dense(), problem["X"].T @ problem["X"],
                               rtol=1e-12)
    A32 = ta.matrix.eager_cov(problem["X"].astype(np.float32), device="cpu")
    assert A32.dtype == np.float32 and A32.mat.dtype == torch.float32
    t = torch.as_tensor(problem["A"])
    assert ta.matrix.dense(t, method="cov").device == torch.device("cpu")


def test_refusals(problem):
    """The naive ``block_diag`` and ``sparse`` (the default method) build
    and match their dense equivalents; what stays refused names its
    ROADMAP item; ``check_state=True`` audits the finished state."""
    bd = ta.matrix.block_diag(problem["blocks"], device="cpu")
    D = np.zeros((P, P))
    D[:12, :12], D[12:, 12:] = problem["blocks"]
    np.testing.assert_allclose(bd.to_dense(), D, rtol=1e-12)
    spm = ta.matrix.sparse(problem["As"], device="cpu")
    np.testing.assert_allclose(spm.to_dense(), problem["As"], rtol=1e-12)
    with pytest.raises(ValueError, match="constraint"):
        ta.matrix.block_diag(problem["blocks"], method="constraint",
                             device="cpu")
    with pytest.raises(ValueError, match="method"):
        ta.matrix.dense(problem["A"], method="covariance", device="cpu")
    with pytest.raises(NotImplementedError, match="constraints"):
        ta.gaussian_cov(problem["A"], problem["v"],
                        constraints=[None] * (P - 1) + ["a constraint"],
                        device="cpu")
    checked = ta.gaussian_cov(problem["A"], problem["v"], check_state=True,
                              device="cpu")
    assert checked.error == "" and ta.state.check_state(checked) == []
    np.testing.assert_array_equal(
        checked.betas.toarray(),
        ta.gaussian_cov(problem["A"], problem["v"], device="cpu")
        .betas.toarray())
    with pytest.raises(TypeError, match="covariance matrix"):
        ta.gaussian_cov(ta.matrix.dense(problem["X"], device="cpu"),
                        problem["v"])


def test_screen_eigh_zeroes_invalid_slots(monkeypatch):
    """An invalid slot's eigenvalues are 0 even when ``eigh`` returns NaN
    for its all-zero block, as the card's batched eigh has done (the pin
    solves take max |eigvals| for their tolerance floor)."""
    from adelie_tpu_torch.solver import pin

    inner = torch.linalg.eigh

    def nan_for_zero_blocks(blocks):
        lam, V = inner(blocks)
        zero = (blocks == 0).flatten(1).all(1)
        return torch.where(zero[:, None], float("nan"), lam), V

    monkeypatch.setattr(torch.linalg, "eigh", nan_for_zero_blocks)
    A = torch.as_tensor(np.diag(np.arange(1.0, 9.0)))
    lam, V = pin.screen_eigh(A, torch.tensor([0, 4, 0]),
                             torch.tensor([4, 4, 0], dtype=torch.int32), 4)
    assert torch.equal(lam[2], torch.zeros(4))
    np.testing.assert_allclose(lam[:2].numpy(), [[1, 2, 3, 4], [5, 6, 7, 8]])
