"""adelie_tpu_torch.bcd against adelie_tpu.bcd, float64 on the CPU.

The same numpy block problems go through both packages' public functions.
Bars: the Newton family (``newton``, ``newton_abs``, ``newton_brent``,
``brent``) and the scalar functions at atol 1e-9; proximal gradient
(``ista``, ``fista``, ``fista_adares``) at the solver tolerance, 1e-9.
The cases cover the general root find, the zero case (||v|| <= l1), the
ridge closed form (l1 = 0), zero eigenvalues and padded lanes (L = 0 and
v = 0, which must give x = 0).
"""

import numpy as np
import pytest
import torch

import adelie_tpu.bcd as jb
import adelie_tpu_torch.bcd as tb

NEWTON = ("newton", "newton_abs", "newton_brent", "brent")
PROX = ("ista", "fista", "fista_adares")


def _case(name, p=8, seed=0):
    """(quad, linear, l1, l2) of a named block problem."""
    rng = np.random.default_rng(seed)
    quad = np.abs(rng.standard_normal(p)) + 0.1
    linear = 2.0 * rng.standard_normal(p)
    l1, l2 = 0.5 * np.linalg.norm(linear), 0.3
    if name == "zero":
        l1 = 2.0 * np.linalg.norm(linear)
    elif name == "ridge":
        l1 = 0.0
    elif name == "zero_eig":
        # zero curvature along two directions, bounded because the
        # gradient there is under l1 (the root bounds' v_S branch)
        quad[[1, 4]] = 0.0
        linear[[1, 4]] = 0.1
        l1, l2 = 0.5 * np.linalg.norm(linear), 0.0
    elif name == "padded":
        quad[5:] = 0.0
        linear[5:] = 0.0
        l1 = 0.5 * np.linalg.norm(linear)
    elif name == "wide":
        return _case("general", p=50, seed=seed + 1)
    elif name == "scalar":
        return _case("general", p=1, seed=seed + 2)
    return quad, linear, l1, l2


CASES = ("general", "zero", "ridge", "zero_eig", "padded", "wide", "scalar")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("solver", NEWTON + PROX)
def test_solve_matches_jax(solver, case):
    quad, linear, l1, l2 = _case(case)
    kw = dict(quad=quad, linear=linear, l1=l1, l2=l2, solver=solver)
    if solver in PROX:
        kw.update(tol=1e-12, max_iters=100_000)
    want = jb.solve(**kw)
    got = tb.solve(**kw)
    assert isinstance(got["beta"], np.ndarray)
    assert isinstance(got["iters"], int)
    np.testing.assert_allclose(got["beta"], want["beta"], rtol=0, atol=1e-9)
    if case in ("zero", "padded"):
        assert np.all(got["beta"][np.asarray(linear) == 0] == 0)
    if case == "zero":
        assert np.all(got["beta"] == 0)


@pytest.mark.parametrize("case", ("general", "zero_eig", "padded", "wide"))
def test_scalar_functions_match_jax(case):
    quad, linear, l1, l2 = _case(case)
    kw = dict(quad=quad, linear=linear, l1=l1)
    lo = tb.root_lower_bound(**kw)
    hi = tb.root_upper_bound(**kw)
    assert lo == pytest.approx(jb.root_lower_bound(**kw), rel=0, abs=1e-9)
    assert hi == pytest.approx(jb.root_upper_bound(**kw), rel=0, abs=1e-9)
    for h in (0.0, lo, 0.5 * (lo + hi), hi):
        assert tb.root_function(h, **kw) == pytest.approx(
            jb.root_function(h, **kw), rel=1e-12, abs=1e-12)
    root = tb.root(**kw, l2=l2)
    assert root == pytest.approx(jb.root(**kw, l2=l2), rel=0, abs=1e-9)
    x = tb.solve(**kw, l2=l2)["beta"]
    assert tb.objective(x, **kw, l2=l2) == pytest.approx(
        jb.objective(x, **kw, l2=l2), rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_newton_solver_keeps_dtype_and_device(dtype):
    """``newton_solver`` takes tensors and returns ``(x, iters)``: x a
    tensor of v's dtype on v's device, as the JAX function returns an array
    of v's dtype; float32 within float32 rounding of the float64 solve."""
    quad, linear, l1, l2 = _case("general")
    x, iters = tb.newton_solver(torch.as_tensor(quad, dtype=dtype),
                                torch.as_tensor(linear, dtype=dtype), l1, l2)
    assert x.dtype == dtype and x.device.type == "cpu"
    assert isinstance(iters, int) and iters > 0
    want, _ = jb.newton_solver(quad, linear, l1, l2)
    bar = 1e-9 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(x.double().numpy(), np.asarray(want),
                               rtol=0, atol=bar)


def test_unknown_names_raise():
    quad, linear, l1, l2 = _case("general")
    with pytest.raises(ValueError, match="newt"):
        tb.solve(quad=quad, linear=linear, l1=l1, l2=l2, solver="newt")
    with pytest.raises(ValueError, match="secant"):
        tb.newton_solver(quad, linear, l1, l2, method="secant")


def test_lane_sum_is_k6_order():
    """``lane_sum`` adds lane partials (stride 32) and folds them in
    halves: the kernel's warp order, exactly reproduced by an explicit
    loop, and equal to ``sum`` up to rounding."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 4, 32, 64, 128):
        x = rng.standard_normal(n).astype(np.float32)
        W = min(n, 32)
        lanes = [np.float32(0.0)] * W
        for r in range(n // W):
            for lane in range(W):
                lanes[lane] = np.float32(lanes[lane] + x[r * W + lane])
        h = W // 2
        while h:
            lanes = [np.float32(lanes[i] + lanes[i + h]) for i in range(h)]
            h //= 2
        assert tb.lane_sum(x) == lanes[0]
        assert tb.lane_sum(x) == pytest.approx(float(x.sum()), abs=1e-5)
