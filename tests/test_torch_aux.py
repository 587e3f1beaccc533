"""The standalone solvers of adelie_tpu_torch (bvls, pinball, css_cov) and
K7's twin (the screened coordinate descent) against adelie_tpu, float64 on
the CPU.

The same numpy inputs go through both packages.  Bars: K7's twin within
1e-12 of the JAX package's ``screened_cd_fit`` (the same sweeps, flags
and convergence); the solvers' coefficients within 1e-8, losses within
1e-10, the same screen sets, KKT rounds and sweep counts; ``css_cov``'s
subsets equal (the problems have no near-ties: their scores are drawn
from continuous data, so no two differ by a few ulps).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adelie_tpu as ja
import adelie_tpu_torch as ta
from adelie_tpu.solver.screened_cd import screened_cd_fit as ja_fit
from adelie_tpu_torch.solver import screened_cd_kernels as kc
from adelie_tpu_torch.solver._pinball import lstsq_quad
from adelie_tpu_torch.solver.screened_cd import screened_cd_fit

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _screened_problem(mode, warm, S=40, seed=0):
    """A padded screened problem: Q's triangles rounded apart (as the
    solvers' Grams are), an invalid tail, a slot with d = 0."""
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((3 * S, S))
    Q = Z.T @ Z / (3 * S)
    Q = Q + np.triu(1e-9 * rng.standard_normal((S, S)), 1)
    valid = np.ones(S, bool)
    valid[-4:] = False
    diag = np.where(valid, np.diag(Q), 0.0)
    diag[7] = 0.0
    grad = Z.T @ rng.standard_normal(3 * S) / (3 * S)
    if mode == "box":
        lo, hi = -rng.uniform(0, 0.3, S), rng.uniform(0, 0.3, S)
        hi[::5] = 1e100
    else:
        lo = 0.05 * rng.uniform(0.5, 1.5, S)
        hi = 0.05 * rng.uniform(0.5, 1.5, S)
    beta = np.zeros(S)
    if warm:
        beta = np.where(valid & (rng.random(S) < 0.3),
                        np.clip(0.05 * rng.standard_normal(S), lo, hi), 0.0)
        grad = grad - Q @ beta
    return (Q, diag, beta, grad, lo, hi, valid, beta != 0)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("mode", ["box", "pinball"])
def test_screened_cd_twin_vs_jax(mode, warm):
    args = _screened_problem(mode, warm)
    jb, jg, jact, jloss, jit, jdone = ja_fit(
        *map(jnp.asarray, args), jnp.asarray(0.3), jnp.asarray(1e-10),
        jnp.asarray(100000, jnp.int32), jnp.asarray(3, jnp.int32),
        mode=mode)
    tb, tg, tact, tloss, tit, tdone = screened_cd_fit(
        *map(torch.as_tensor, args), 0.3, 1e-10, 100000, 3, mode)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-12)
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    assert abs(tloss - float(jloss)) <= 1e-12
    assert (tit, tdone) == (int(jit), bool(jdone)) and tdone


def test_screened_cd_reads_columns_and_counts():
    """The update of slot i reads column i of a non-symmetric Q (a
    transposed view is read as it is), the sweep cap stops the fit, and
    ``launches`` counts no twin run."""
    Q, *rest = _screened_problem("box", False)
    t = [torch.as_tensor(a) for a in (Q, *rest)]
    n0 = kc.launches["screened_cd_solve"]
    b1, g1, a1, info1 = kc.screened_cd_solve(*t, 0.3, 1e-10, 100000, 0,
                                             "box")
    Qt = torch.as_tensor(np.ascontiguousarray(Q.T))
    b2, g2, a2, info2 = kc.screened_cd_solve(Qt.T, *t[1:], 0.3, 1e-10,
                                             100000, 0, "box")
    assert torch.equal(b1, b2) and torch.equal(g1, g2)
    assert info1.tolist() == info2.tolist()
    b3, *_, info3 = kc.screened_cd_solve(Qt, *t[1:], 0.3, 1e-10, 100000, 0,
                                         "box")
    assert not torch.equal(b1, b3)          # rows are not columns
    _, _, _, info4 = kc.screened_cd_solve(*t, 0.3, 1e-10, 2, 0, "box")
    assert info4.tolist()[1:3] == [2.0, 0.0]
    assert kc.launches["screened_cd_solve"] == n0
    with pytest.raises(ValueError, match="mode"):
        kc.screened_cd_solve(*t, 0.3, 1e-10, 10, 0, "boxes")


@pytest.mark.parametrize("mode", ["box", "pinball"])
def test_screened_cd_counts_distinct_rows(mode):
    """The twin's ``moved`` marks the distinct slots that moved: between
    the slots whose beta changed and min(moves, valid slots), results
    unchanged; on a diagonal Q every valid slot with a nonzero target
    moves once; on the floor none."""
    Q, diag, beta, grad, lo, hi, valid, act = _screened_problem(mode, True)
    t = [torch.as_tensor(a) for a in (Q, diag, beta, grad, lo, hi, valid,
                                      act)]
    S = len(diag)
    moved = np.zeros(S, bool)
    b, g, a, info = kc.screened_cd_solve_ref(*t, 0.3, 1e-10, 100000, 0, mode,
                                             moved=moved)
    b0, g0, a0, info0 = kc.screened_cd_solve(*t, 0.3, 1e-10, 100000, 0, mode)
    assert torch.equal(b, b0) and torch.equal(g, g0) and torch.equal(a, a0)
    assert info.tolist() == info0.tolist()
    moves, rows = info.tolist()[3], int(moved.sum())
    changed = int((b.numpy() != beta).sum())
    assert changed <= rows <= min(moves, valid.sum()) and rows < moves
    assert not moved[~valid].any()
    I = torch.eye(S, dtype=torch.float64)
    g = torch.as_tensor(grad)
    g[::3] = 0.0
    one = torch.ones(S, dtype=torch.float64)
    z = torch.zeros(S, dtype=torch.float64)
    lo_i, hi_i = (-10 * one, 10 * one) if mode == "box" else (z, z)
    off = torch.zeros(S, dtype=torch.bool)
    moved = np.zeros(S, bool)
    _, _, _, info = kc.screened_cd_solve_ref(
        I, one, z, g, lo_i, hi_i, t[6], off, 0.0, 1e-10, 100000, 0, mode,
        moved=moved)
    want = ((g != 0) & t[6]).numpy()
    assert info.tolist()[3] == want.sum()
    np.testing.assert_array_equal(moved, want)
    moved = np.zeros(S, bool)
    _, _, _, info = kc.screened_cd_solve_ref(
        I, one, z, g, z, z, t[6], off, 0.0, 1e-10, 100000, 0, "box",
        moved=moved)
    assert info.tolist()[3] == 0 and not moved.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("mode", ["box", "pinball"])
def test_screened_cd_segments_keep_the_twins_bits(mode, warm, dtype):
    """The card's segmented scheme, driven by ``run_segments`` with the
    kernels' plain stand-ins (a full sweep, the compact block, an active
    segment that logs its deltas, the replay of the log on the slots not
    listed) and a log of one sweep, so that every active sweep is a segment
    and a replay, or of three: beta, grad, flags and info equal the twin's
    bit for bit, also when the sweep cap cuts an active phase; and no step
    runs that the state read before it shows has nothing to do."""
    args = [torch.as_tensor(a) for a in _screened_problem(mode, warm)]
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    n0 = dict(kc.launches)
    for max_iters, log_sweeps in ((100000, 1), (6, 1), (100000, 3)):
        ref = kc.screened_cd_solve_ref(*args, 0.3, 1e-10, max_iters, 3, mode)
        stats = {}
        out = kc.screened_cd_solve_segmented(*args, 0.3, 1e-10, max_iters, 3,
                                             mode, log_sweeps=log_sweeps,
                                             stats=stats)
        for name, x, y in zip(("beta", "grad", "active"), out[:3], ref[:3]):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        assert out[3].tolist() == ref[3].tolist()
        sweeps = ref[3][1].item() - 3
        # every step had work: a read after each full sweep and segment,
        # a gather a phase, a replay a segment (some slots are never
        # listed); with a log of one sweep, a segment an active sweep
        assert stats["reads"] == stats["full"] + stats["rounds"]
        assert stats["active"] == stats["replay"] == stats["rounds"]
        assert 0 < stats["gather"] <= stats["full"]
        if log_sweeps == 1:
            assert stats["full"] + stats["rounds"] == sweeps
            assert stats["rounds"] > (5 if max_iters > 6 else 0)
        else:
            assert stats["full"] + stats["rounds"] < sweeps
    assert kc.launches == n0


@pytest.fixture(scope="module")
def bvls_problem():
    rng = np.random.default_rng(5)
    n, p = 90, 30
    X = rng.standard_normal((n, p))
    y = X @ rng.standard_normal(p) + rng.standard_normal(n)
    return dict(X=X, y=y, w=rng.uniform(0.5, 1.5, n) / n,
                lo=-rng.uniform(0, 0.3, p), hi=rng.uniform(0, 0.3, p))


def _same_fit(js, ts, extra=()):
    np.testing.assert_allclose(ts.beta, js.beta, atol=1e-8)
    assert abs(ts.loss - js.loss) <= 1e-10
    assert list(ts.screen_set) == list(js.screen_set)
    np.testing.assert_array_equal(ts.active_set, js.active_set)
    assert (ts.iters, ts.n_kkt) == (js.iters, js.n_kkt)
    np.testing.assert_allclose(ts.resid, js.resid, atol=1e-8)
    np.testing.assert_allclose(ts.grad, js.grad, atol=1e-8)
    for name in extra:
        np.testing.assert_allclose(getattr(ts, name), getattr(js, name),
                                   rtol=1e-10)


@pytest.mark.parametrize("case", ["nnls", "weighted_box", "warm"])
def test_bvls_vs_jax(bvls_problem, case):
    """Non-negative least squares (kappa = min(n, p)), a weighted box in
    KKT rounds of 4 violators, and a continuation from the first fit's
    state."""
    X, y = bvls_problem["X"], bvls_problem["y"]
    p = X.shape[1]
    if case == "nnls":
        args, kw = (X, y, np.zeros(p), np.full(p, np.inf)), {}
    else:
        args = (X, y, bvls_problem["lo"], bvls_problem["hi"])
        kw = dict(weights=bvls_problem["w"], kappa=4)
    js = ja.bvls(*args, **kw)
    ts = ta.bvls(*args, device="cpu", **kw)
    if case == "warm":
        js = ja.bvls(*args, warm_start=js, **kw)
        ts = ta.bvls(*args, warm_start=ts, device="cpu", **kw)
    _same_fit(js, ts, extra=("X_vars", "y_var"))


def test_bvls_on_an_snp_matrix(tmp_path):
    """BVLS through a packed SNP matrix in device memory (K3's twin for
    ``X^T W r``): the same fit as on its dense float64 copy."""
    rng = np.random.default_rng(8)
    n, p = 120, 40
    G = rng.integers(0, 3, (n, p)).astype(np.int8)
    y = G[:, :5] @ rng.uniform(0.2, 1.0, 5) + rng.standard_normal(n)
    io = ta.io.snp_unphased(str(tmp_path / "g.snpdat"))
    io.write(G)
    io.read()
    Xs = ta.matrix.snp_unphased(io, dtype=np.float64, device="cpu")
    lo, hi = np.zeros(p), np.full(p, 0.8)
    ts = ta.bvls(Xs, y, lo, hi)
    js = ja.bvls(G.astype(np.float64), y, lo, hi)
    _same_fit(js, ts)


def _pinball_problem(m, d, rank, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, d))
    Z = rng.standard_normal((rank, d))
    S = Z.T @ Z / rank
    return (A, S, rng.standard_normal(d), rng.uniform(0.1, 1.0, m),
            rng.uniform(0.1, 1.0, m))


@pytest.mark.parametrize("case", ["full_rank", "singular_S", "constraint"])
def test_pinball_vs_jax(case):
    """A full-rank S; a singular S (rank 10 of 12: y_var from its
    minimum-norm solution); A as a sparse constraint matrix."""
    if case == "singular_S":
        A, S, v, pn, pp = _pinball_problem(8, 12, 10, seed=2)
    else:
        A, S, v, pn, pp = _pinball_problem(30, 10, 20, seed=1)
    js = ja.pinball(A, S, v, pn, pp, tol=1e-10)
    At = A
    if case == "constraint":
        A = np.where(np.abs(A) > 0.5, A, 0.0)
        js = ja.pinball(ja.matrix.sparse(A, method="constraint"), S, v, pn,
                        pp, tol=1e-10)
        At = ta.matrix.sparse(A, method="constraint", device="cpu")
    ts = ta.pinball(At, S, v, pn, pp, tol=1e-10, device="cpu")
    _same_fit(js, ts, extra=("y_var",))


def test_lstsq_quad_on_a_singular_matrix():
    """``v' S^+ v`` on singular S against numpy's ``lstsq``."""
    rng = np.random.default_rng(4)
    for rank in (3, 7, 12):
        Z = rng.standard_normal((rank, 12))
        S = Z.T @ Z
        v = rng.standard_normal(12)
        want = v @ np.linalg.lstsq(S, v, rcond=None)[0]
        got = lstsq_quad(torch.as_tensor(S), torch.as_tensor(v))
        assert abs(got - want) <= 1e-9 * max(1.0, abs(want))


@pytest.fixture(scope="module")
def css_S():
    rng = np.random.default_rng(6)
    Z = rng.standard_normal((200, 25)) @ rng.standard_normal((25, 25))
    return np.corrcoef(Z.T)


@pytest.mark.parametrize("method", ["greedy", "swapping"])
@pytest.mark.parametrize("loss", ["least_squares", "subset_factor",
                                  "min_det"])
def test_css_cov_vs_jax(css_S, method, loss):
    js = ja.css_cov(css_S, 6, method=method, loss=loss)
    ts = ta.css_cov(css_S, 6, method=method, loss=loss, device="cpu")
    assert list(ts.subset) == list(js.subset)
    assert (ts.method, ts.loss, ts.subset_size) == (method, loss, 6)


def test_css_cov_options(css_S):
    """A given start for swapping, an empty greedy set and the errors."""
    start = [0, 1, 2, 3]
    js = ja.css_cov(css_S, subset=start, method="swapping")
    ts = ta.css_cov(torch.as_tensor(css_S), subset=start,
                    method="swapping")
    assert list(ts.subset) == list(js.subset)
    assert len(ta.css_cov(css_S, 0, method="greedy", device="cpu")
               .subset) == 0
    with pytest.raises(ValueError, match="loss"):
        ta.css_cov(css_S, 3, loss="l2", device="cpu")
    with pytest.raises(ValueError, match="subset_size"):
        ta.css_cov(css_S, 99, method="greedy", device="cpu")


def test_entry_points_without_jax():
    """The port imports, and fits each new entry point on the CPU, with
    ``jax`` and ``adelie_tpu`` made unimportable."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["adelie_tpu"] = None
import numpy as np
import adelie_tpu_torch as ta
rng = np.random.default_rng(0)
X = rng.standard_normal((40, 8)); y = X[:, 0] + rng.standard_normal(40)
A, v = X.T @ X / 40, X.T @ y / 40
assert ta.gaussian_cov(A, v, device="cpu").error == ""
assert ta.bvls(X, y, np.zeros(8), np.ones(8), device="cpu").n_kkt > 0
assert len(ta.pinball(X[:5].T, np.eye(5), y[:5], np.ones(8), np.ones(8),
                      device="cpu").beta) == 8
assert len(ta.css_cov(A, 3, method="greedy", device="cpu").subset) == 3
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        out.stdout + out.stderr


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.ones((4, 3))
    for call in (lambda: ta.gaussian_cov(np.eye(3), np.ones(3)),
                 lambda: ta.bvls(X, np.ones(4), np.zeros(3), np.ones(3)),
                 lambda: ta.pinball(X, np.eye(3), np.ones(3), np.ones(4),
                                    np.ones(4)),
                 lambda: ta.css_cov(np.eye(3), 1, method="greedy")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
