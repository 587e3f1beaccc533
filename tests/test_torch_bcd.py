"""adelie_tpu_torch.bcd against adelie_tpu.bcd, float64 on the CPU.

The same numpy block problems go through both packages' public functions.
Bars: the Newton family (``newton``, ``newton_abs``, ``newton_brent``,
``brent``) and the scalar functions at atol 1e-9; proximal gradient
(``ista``, ``fista``, ``fista_adares``) at the solver tolerance, 1e-9.
The cases cover the general root find, the zero case (||v|| <= l1), the
ridge closed form (l1 = 0), zero eigenvalues and padded lanes (L = 0 and
v = 0, which must give x = 0).  In float32, where a third of the Newton
walks never meet ``tol`` and end by the cycle rule, the twin's walk is held
bit for bit against the walk without that exit, and the JAX package's
float32 solve at 1e-5 of max(|x|, 1), the float32 bar of
``test_newton_solver_keeps_dtype_and_device``.
"""

import jax
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


def capped_problems(n, seed=0):
    """``n`` float32 block problems of size 4: L at scales 1e-2 to 10, l1 a
    uniform share of ||v||, l2 0 or 0.1.  About a third of their Newton
    walks reach 1,000 steps without meeting tol = 1e-12."""
    rng = np.random.default_rng(seed)
    scale = 10 ** rng.uniform(-2, 1, n)
    L = (np.abs(rng.standard_normal((n, 4))) * scale[:, None]) \
        .astype(np.float32)
    v = rng.standard_normal((n, 4)).astype(np.float32)
    l1 = (rng.uniform(0, 1, n) * np.linalg.norm(v, axis=1)) \
        .astype(np.float32)
    l2 = rng.choice([0.0, 0.1], n).astype(np.float32)
    return L, v, l1, l2


def full_walk(buf1, v, l1, h0, tol, max_iters):
    """Guarded Newton with no cycle exit: (h, iters, the distance back to
    the last h's previous occurrence, 0 if none)."""
    dt = v.dtype.type
    h = dt(h0)
    fh, dfh = tb._newton_step(buf1, v, l1, h, tb._tiny(dt))
    seen = [h.tobytes()]
    while np.abs(fh) > tol and len(seen) <= max_iters:
        h = np.maximum(h - fh / dfh, dt(0.0))
        fh, dfh = tb._newton_step(buf1, v, l1, h, tb._tiny(dt))
        seen.append(h.tobytes())
    past = seen[-2::-1]
    return h, len(seen) - 1, past.index(seen[-1]) + 1 if seen[-1] in past \
        else 0


def test_newton_cycle_exit_is_the_full_walk():
    """``block_update_np`` with the cycle exit against the walk without it,
    on 300 seeded float32 problems: the same h and x bit for bit and the
    same iters.  Every walk at the cap ends on a cycle; fixed points
    (period 1) and periods of 2 or more both occur."""
    L, v, l1, l2 = capped_problems(300)
    tol = np.float32(1e-12)
    periods = []
    for i in range(len(L)):
        x, iters, general, run, cycled = tb.block_update_np(
            L[i], v[i], l1[i], l2[i], tol, 1000)
        if not general:
            continue
        buf1 = L[i] + l2[i]
        h0 = tb._newton_abs_init(buf1, v[i], l1[i], tol)
        h, it_full, period = full_walk(buf1, v[i], l1[i], h0, tol, 1000)
        x_full = (h * v[i]) / (buf1 * h + l1[i])
        assert x.tobytes() == x_full.tobytes() and iters == it_full
        if it_full < 1000:
            assert not cycled and run == it_full
        else:
            assert cycled and run < 1000 and period > 0
            periods.append(period)
    assert len(periods) >= 60
    assert 1 in periods and max(periods) >= 2


def test_newton_solver_float32_matches_jax():
    """The same 300 float32 problems through ``newton_solver`` and the JAX
    package's (vmapped, one compile): x within 1e-5 of max(|x|, 1); the
    walks' counts differ where the two packages sum in other orders."""
    L, v, l1, l2 = capped_problems(300)
    xj, _ = jax.jit(jax.vmap(jb.newton_solver))(L, v, l1, l2)
    xj = np.asarray(xj)
    assert xj.dtype == np.float32
    for i in range(len(L)):
        x, _ = tb.newton_solver(L[i], v[i], float(l1[i]), float(l2[i]))
        assert x.dtype == torch.float32
        bar = 1e-5 * max(float(np.abs(xj[i]).max()), 1.0)
        np.testing.assert_allclose(x.numpy(), xj[i], rtol=0, atol=bar)
