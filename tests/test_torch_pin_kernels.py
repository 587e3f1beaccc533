"""The pin-solve kernels' twins of adelie_tpu_torch against the JAX package.

K1's twin is held against the Pallas kernel ``pin_lasso_solve_pallas`` in
interpret mode (float32) and against JAX's ``pin_cov_solve`` (float64); K2's
twin against ``cd_sweep_rows_pallas`` in interpret mode; the port's
``pin_cov_solve`` against JAX's at a screen capacity past 1024, where K2 and
the filtered full sweep run.  Inputs are made with numpy and handed to both
packages.  The CUDA kernels themselves are checked against these twins on
the card by ``chip_smoke.py``.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adelie_tpu.solver.pin import pin_cov_solve as jax_pin_cov_solve
from adelie_tpu.solver.pin import screen_eigh as jax_screen_eigh
from adelie_tpu.solver.pin_pallas import (
    cd_sweep_rows_pallas,
    pin_lasso_solve_pallas,
)
from adelie_tpu_torch.solver import pin as tpin
from adelie_tpu_torch.solver import pin_kernels as tk

torch.set_num_threads(1)
# Pallas interpret mode traces deeply nested loop bodies
sys.setrecursionlimit(100000)


def _problem(n, S, n_invalid, seed, dtype):
    """The screen problem of tests/test_pin_pallas.py, in numpy.
    ``n_invalid``: the last slots invalid, or "holes": every fifth slot from
    the fourth invalid, between valid ones."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, S))
    A = (X.T @ X / n).astype(dtype)
    y = X[:, 0] - X[:, min(5, S - 1)] + 0.1 * rng.standard_normal(n)
    grad = (X.T @ y / n).astype(dtype)
    valid = np.ones(S, bool)
    if n_invalid == "holes":
        valid[3::5] = False
    elif n_invalid:
        valid[-n_invalid:] = False
    diag = np.where(valid, np.diag(A), 0).astype(dtype)
    pen = rng.uniform(0.5, 1.5, S).astype(dtype)
    return A, grad, diag, valid, pen


K1_CASES = [
    (32, 0, 0.05, 1.0),
    (64, 5, 0.02, 1.0),
    (64, 3, 0.05, 0.7),
    (64, "holes", 0.03, 1.0),
]


def _slots(diag, valid, pen, act):
    """K1's slot buffers for one slot a position (q = 1): ``slot_begin,
    slot_size, eigvals, penalty, is_active`` as torch tensors."""
    S = len(valid)
    t = torch.from_numpy
    return (torch.arange(S, dtype=torch.int64), t(valid.astype(np.int32)),
            t(np.ascontiguousarray(diag[:, None])), t(pen), t(act))


@pytest.mark.parametrize("S,n_invalid,lmda,alpha", K1_CASES)
def test_k1_twin_matches_pallas_kernel_f32(S, n_invalid, lmda, alpha):
    """The twin on the slot buffers against the Pallas kernel on positional
    arrays; "holes" puts invalid slots between valid ones, and a cold start
    begins every case with an empty active list."""
    A, grad, diag, valid, pen = _problem(300, S, n_invalid, S, np.float32)
    beta0 = np.zeros(S, np.float32)
    act0 = np.zeros(S, bool)
    f = np.float32
    out_p = pin_lasso_solve_pallas(
        jnp.asarray(A), jnp.asarray(grad), jnp.asarray(beta0),
        jnp.asarray(diag), jnp.asarray(valid), jnp.asarray(act0),
        jnp.asarray(pen), f(lmda), f(alpha), f(1e-9), f(1e-12), f(100000),
        f(0.0), interpret=True,
    )
    t = torch.from_numpy
    beta, grad_n, act, info = tk.pin_lasso_solve(
        t(A), t(grad), t(beta0), *_slots(diag, valid, pen, act0),
        lmda, alpha, 1e-9, 100000, 0.0,
    )
    rsq, iters, done = info.tolist()
    assert tk.launches == {"pin_lasso_solve": 0, "pin_lasso_solve_rows": 0}
    np.testing.assert_allclose(beta.numpy(), np.asarray(out_p[0]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(grad_n.numpy(), np.asarray(out_p[1]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(rsq, float(out_p[3]), rtol=1e-5)
    np.testing.assert_array_equal(act.numpy(), np.asarray(out_p[2]))
    assert int(iters) == int(out_p[4])
    assert bool(done) == bool(out_p[5]) is True


@pytest.mark.parametrize("S,n_invalid,lmda,alpha", K1_CASES)
@pytest.mark.parametrize("warm", [False, True])
def test_k1_twin_matches_jax_pin_cov_solve_f64(S, n_invalid, lmda, alpha,
                                               warm):
    A, grad, diag, valid, pen = _problem(300, S, n_invalid, S, np.float64)
    rng = np.random.default_rng(S + 1)
    if warm:
        beta0 = np.where(valid & (rng.random(S) < 0.3),
                         0.1 * rng.standard_normal(S), 0.0)
        grad = grad - A @ beta0
        act0 = beta0 != 0
    else:
        beta0 = np.zeros(S)
        act0 = np.zeros(S, bool)
    slot_begin = np.arange(S, dtype=np.int32)
    slot_size = valid.astype(np.int32)
    eigvals, eigvecs = jax_screen_eigh(jnp.asarray(A), jnp.asarray(slot_begin),
                                       jnp.asarray(slot_size), 1)
    out_x = jax_pin_cov_solve(
        jnp.asarray(A), jnp.asarray(grad), jnp.asarray(beta0),
        jnp.asarray(slot_begin), jnp.asarray(slot_size), eigvals, eigvecs,
        jnp.asarray(pen), jnp.asarray(act0), lmda, alpha, 1e-12, 1e-12,
        1e-12, 1000, 100000, 0.25,
    )
    t = torch.from_numpy
    beta, grad_n, act, rsq, iters, done = tpin.pin_cov_solve(
        t(A), t(grad), t(beta0), t(slot_begin), t(slot_size),
        t(np.array(eigvals)), t(np.array(eigvecs)), t(pen), t(act0), lmda,
        alpha, 1e-12, 1e-12, 1e-12, 1000, 100000, 0.25,
    )
    np.testing.assert_allclose(beta.numpy(), np.asarray(out_x[0]), atol=1e-10)
    np.testing.assert_allclose(grad_n.numpy(), np.asarray(out_x[1]),
                               atol=1e-10)
    np.testing.assert_array_equal(act.numpy(), np.asarray(out_x[2]))
    assert abs(rsq - float(out_x[3])) <= 1e-10
    assert iters == int(out_x[4])
    assert done == bool(out_x[5]) is True


def _k2_problem(dtype):
    """The sweep problem of tests/test_pin_pallas.py:134-180."""
    rng = np.random.default_rng(0)
    S, C = 128, 40
    B = rng.standard_normal((100, S)).astype(dtype) / 10
    A = (B.T @ B + np.eye(S, dtype=dtype)).astype(dtype)
    beta = (rng.standard_normal(S) * 0.1).astype(dtype)
    grad = rng.standard_normal(S).astype(dtype)
    pos = (np.arange(C) * 3 % S).astype(np.int32)
    akk = A[pos, pos].copy()
    pk = np.ones(C, dtype)
    return A, beta, grad, pos, akk, pk


def test_k2_twin_matches_pallas_kernel_f32():
    A, beta, grad, pos, akk, pk = _k2_problem(np.float32)
    n = 25
    l1, l2, rsq0 = np.float32(0.3), np.float32(0.1), np.float32(0.25)
    b2, g2, moved, convg, rsq = cd_sweep_rows_pallas(
        jnp.asarray(A), jnp.asarray(beta), jnp.asarray(grad),
        jnp.asarray(pos), jnp.asarray(akk), jnp.asarray(pk),
        jnp.asarray(n, jnp.int32), jnp.asarray(l1), jnp.asarray(l2),
        jnp.asarray(rsq0), interpret=True)
    t = torch.from_numpy
    bt, gt, mt, info = tk.cd_sweep_rows_ref(
        t(A), t(beta), t(grad), t(pos), t(akk), t(pk),
        torch.tensor([n], dtype=torch.int32), float(l1), float(l2),
        float(rsq0),
    )
    assert tk.launches == {"pin_lasso_solve": 0, "pin_lasso_solve_rows": 0}
    np.testing.assert_allclose(bt.numpy(), np.asarray(b2), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gt.numpy(), np.asarray(g2), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(moved) != 0)
    assert not mt.numpy()[n:].any()
    np.testing.assert_allclose(info.tolist(), [float(convg), float(rsq)],
                               rtol=1e-5)


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_zero_denominator_keeps_beta(kernel):
    """A coordinate with a_ii + l2 p_i = 0 (zero-variance column, alpha = 1)
    keeps its coefficient in both twins; the others still move."""
    S = 64
    rng = np.random.default_rng(3)
    B = rng.standard_normal((200, S)) / 10
    A = B.T @ B
    A[7, :] = 0.0
    A[:, 7] = 0.0
    grad = rng.standard_normal(S)
    beta = np.zeros(S)
    beta[7] = 0.5
    t = torch.from_numpy
    if kernel == "k1":
        diag = np.diag(A).copy()
        b, g, act, info = tk.pin_lasso_solve(
            t(A), t(grad), t(beta),
            *_slots(diag, np.ones(S, bool), np.ones(S), np.zeros(S, bool)),
            0.05, 1.0, 1e-12, 100000, 0.0,
        )
        assert info.tolist()[2] == 1.0
        assert not act[7]
    else:
        pos = np.arange(S, dtype=np.int32)
        b, g, moved, info = tk.cd_sweep_rows_ref(
            t(A), t(beta), t(grad), t(pos), t(np.diag(A).copy()),
            torch.ones(S, dtype=torch.float64),
            torch.tensor([S], dtype=torch.int32), 0.05, 0.0, 0.0,
        )
        assert not moved[7] and moved.any()
    assert b[7].item() == 0.5
    assert np.isfinite(b.numpy()).all() and np.isfinite(g.numpy()).all()
    assert (b.numpy() != beta).sum() > 0


PAST_1024_CASES = [
    (np.float64, "cold"), (np.float64, "warm"), (np.float64, "invalid"),
    (np.float64, "unpenalized"), (np.float32, "cold"), (np.float32, "warm"),
]


@pytest.mark.parametrize("dtype,case", PAST_1024_CASES,
                         ids=[f"{np.dtype(d).name}-{c}"
                              for d, c in PAST_1024_CASES])
def test_pin_cov_solve_past_1024_matches_jax_f64(dtype, case):
    """S_cap = 2048 takes K2's twin (the whole solve, with the filtered full
    sweep) in the port, the fori-loop sweeps with the same filter in JAX.

    Cases: float64 and float32; a cold start; a warm start whose active
    set and coefficients are given; invalid slots interleaved with the
    valid ones; one slot with penalty 0.  Bars: float64 beta within atol
    1e-8, float32 within rtol 1e-5 of max |beta|; active flags, iters and done equal."""
    rng = np.random.default_rng(5)
    p = 96
    B = rng.standard_normal((200, p)) / 14
    A_small = B.T @ B + 0.5 * np.eye(p)
    g_small = rng.standard_normal(p)
    S_cap = tk.MAX_PALLAS_S + 1024
    A = np.zeros((S_cap, S_cap))
    A[:p, :p] = A_small
    g = np.zeros(S_cap)
    g[:p] = g_small
    sb = np.arange(S_cap, dtype=np.int32)
    valid = np.arange(S_cap) < p
    if case == "invalid":
        valid[3:p:7] = False
    pen = np.ones(S_cap)
    if case == "unpenalized":
        pen[4] = 0.0
    beta0 = np.zeros(S_cap)
    act = np.zeros(S_cap, bool)
    if case == "warm":
        beta0[:p] = np.where(rng.random(p) < 0.2,
                             0.3 * rng.standard_normal(p), 0.0)
        g = g - A @ beta0
        act = beta0 != 0
    ssz = valid.astype(np.int32)
    ev = np.where(valid, np.diag(A), 0.0)[:, None]
    A, g, beta0, ev, pen = (x.astype(dtype) for x in (A, g, beta0, ev, pen))
    out_x = jax_pin_cov_solve(
        jnp.asarray(A), jnp.asarray(g), jnp.asarray(beta0), jnp.asarray(sb),
        jnp.asarray(ssz), jnp.asarray(ev),
        jnp.ones((S_cap, 1, 1), dtype), jnp.asarray(pen), jnp.asarray(act),
        *(dtype(x) for x in (0.2, 1.0, 1e-12, 1e-14, 1e-12)), 1000, 100000,
        dtype(0.0),
    )
    t = torch.from_numpy
    beta, _, act_t, rsq, iters, done = tpin.pin_cov_solve(
        t(A), t(g), t(beta0), t(sb), t(ssz), t(ev),
        torch.ones((S_cap, 1, 1), dtype=t(A).dtype), t(pen), t(act), 0.2,
        1.0, 1e-12, 1e-14, 1e-12, 1000, 100000, 0.0,
    )
    assert tk.launches == {"pin_lasso_solve": 0, "pin_lasso_solve_rows": 0}
    assert beta.dtype == t(A).dtype
    if dtype == np.float64:
        np.testing.assert_allclose(beta.numpy(), np.asarray(out_x[0]),
                                   atol=1e-8)
    else:
        # relative to the largest coefficient: the two packages round the
        # row AXPYs apart, and a small coefficient carries that absolute
        # difference
        want = np.asarray(out_x[0])
        np.testing.assert_allclose(beta.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(act_t.numpy(), np.asarray(out_x[2]))
    assert done == bool(out_x[5]) is True
    assert iters == int(out_x[4])
    if case == "unpenalized":
        assert act_t[4] and beta[4] != 0
    if case == "invalid":
        assert not act_t.numpy()[~valid].any()
