#!/usr/bin/env python3
"""How far above a float64 FISTA optimum pinball's stopping rules leave
the objective, in both packages, on the CPU in float64.

    python3 tools/pinball_plateau_gap.py [--jax-only] [--fista-steps=N] [D ...]

(default sizes 64 128 256).  Each problem is built as ``chip_smoke.py``'s
A2 builds its own, at m = 4 D: A (m, D) Gaussian, S a Wishart (D, D)
from 4 D samples, v Gaussian, penalties U(0.5, 1.5), seed 41 (D = 1024
is A2's problem).  Each package fits it with ``pinball(..., tol=1e-12)``:
the JAX package's ``adelie_tpu.pinball`` and the port's on
``device="cpu"`` (``--jax-only`` skips the port, whose plain CPU twin is a
Python loop over the coordinates and slow past D = 256).  The oracle is
tests/test_aux_solvers.py's FISTA in numpy float64, N steps (default
100,000) to a step of 1e-14; N = 0 skips it.  Printed for each fit: the
objective (12 digits), its gap to FISTA's, relative to |FISTA's
objective| and to ``y_var`` (the solver stops its KKT rounds once the
loss moves by less than 1e-6 y_var), the largest beta gap, the KKT
rounds, the sweeps, and the violators a further KKT round would have
screened (nonzero when that stop ended the fit before a clean round).
It imports both packages: run it from the repo root with the JAX
package's CPU settings (``JAX_PLATFORMS=cpu``).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def problem(d, seed=41):
    """chip_smoke.py's A2 problem at m = 4 d."""
    m = 4 * d
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, d))
    Z = rng.standard_normal((4 * d, d))
    S = Z.T @ Z / (4 * d)
    v = rng.standard_normal(d)
    pn, pp = rng.uniform(0.5, 1.5, m), rng.uniform(0.5, 1.5, m)
    return A, S, v, pn, pp


def objective(A, S, v, pn, pp, b):
    Q = A @ S @ A.T
    return float(0.5 * b @ Q @ b - (A @ v) @ b
                 + pn @ np.maximum(-b, 0) + pp @ np.maximum(b, 0))


def fista(A, S, v, pn, pp, max_iters=100000, tol=1e-14):
    """tests/test_aux_solvers.py's oracle."""
    Q = A @ S @ A.T
    lin = A @ v
    t = 1.0 / max(np.linalg.eigvalsh(Q)[-1], 1e-10)
    x = np.zeros(A.shape[0])
    z = x.copy()
    s = 1.0
    for _ in range(max_iters):
        u = z - t * (Q @ z - lin)
        x_new = np.where(u > t * pp, u - t * pp,
                         np.where(u < -t * pn, u + t * pn, 0.0))
        s_new = 0.5 * (1 + np.sqrt(1 + 4 * s * s))
        z = x_new + ((s - 1) / s_new) * (x_new - x)
        if np.linalg.norm(x_new - x) < tol:
            return x_new
        x, s = x_new, s_new
    return x


def report(name, st, A, S, v, pn, pp, x_f, oracle, wall):
    beta = np.asarray(st.beta, np.float64)
    ours = objective(A, S, v, pn, pp, beta)
    grad = np.asarray(st.grad, np.float64)
    viols = np.maximum(grad - pp, -pn - grad)
    left = int(((viols > 0) & ~np.asarray(st.is_screen, bool)).sum())
    gap = "no FISTA"
    if x_f is not None:
        gap = (f"gap {ours - oracle:.3e} ({(ours - oracle) / abs(oracle):.2e}"
               f" of |FISTA's|, {(ours - oracle) / st.y_var:.2e} y_var), "
               f"beta within {np.abs(beta - x_f).max():.2e}")
    print(f"  {name}: objective {ours:.12g}, {gap}, y_var {st.y_var:.10g}, "
          f"KKT rounds {st.n_kkt}, sweeps {st.iters}, violators left "
          f"{left}, {wall:.1f} s", flush=True)


def main(argv):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import adelie_tpu as ja
    import adelie_tpu_torch as ta

    jax_only = "--jax-only" in argv
    steps = 100000
    sizes = []
    for a in argv[1:]:
        if a.startswith("--fista-steps="):
            steps = int(a.split("=", 1)[1])
        elif a != "--jax-only":
            sizes.append(int(a))
    for d in sizes or (64, 128, 256):
        A, S, v, pn, pp = problem(d)
        t0 = time.perf_counter()
        x_f = fista(A, S, v, pn, pp, max_iters=steps) if steps else None
        oracle = None if x_f is None else objective(A, S, v, pn, pp, x_f)
        print(f"m={4 * d} d={d}: FISTA "
              f"{'skipped' if x_f is None else f'{oracle:.12g}'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        js = ja.pinball(A, S, v, pn, pp, tol=1e-12)
        report("adelie_tpu", js, A, S, v, pn, pp, x_f, oracle,
               time.perf_counter() - t0)
        if jax_only:
            continue
        t0 = time.perf_counter()
        ts = ta.pinball(A, S, v, pn, pp, tol=1e-12, device="cpu")
        report("adelie_tpu_torch", ts, A, S, v, pn, pp, x_f, oracle,
               time.perf_counter() - t0)


if __name__ == "__main__":
    main(sys.argv)
