#!/usr/bin/env python3
"""How far a fixed-screen pin state leaves a path's coefficients, on the
problems of ``chip_smoke.py``'s phase V5.

    python3 tools/pin_state_gap.py CELL DEVICE DTYPE TOL [TOL ...]

CELL is ``big-S`` (phase 6's problem, n = 4,000, p = 2,500, 40 lambdas),
``headline`` (phase 5's, n = 40,000, p = 2,000, 100 lambdas) or
``grouped`` (the headline in 500 groups of 4); DEVICE ``cpu`` or
``cuda``; DTYPE ``float32`` or ``float64``.  For each TOL the script fits
the path (``grpnet``, no intercept, no early exit) and then
``state.gaussian_pin_naive`` on that path's last screen over its lambdas
at the same ``tol``, and prints the walls and the largest gap in beta
over the path, relative to the path's max |beta|.  Both fits stop when
their coordinate descent meets ``tol``, so the gap is what two solutions
that each meet it may differ by: ``chip_smoke.py`` holds V5 at 1e-4 of
max |beta| and runs its big-S cell at the ``tol`` this script shows to
need it.  On the CPU the kernels' twins run (minutes a fit at these
sizes).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv):
    import chip_smoke as cs
    import adelie_tpu_torch as ad

    cell, device, dtype = argv[:3]
    tols = [float(t) for t in argv[3:]]
    if cell == "big-S":
        X, y, kw = cs.big_s_problem()
    else:
        X, y = cs.headline_problem(40000, 2000, 60, seed=0)
        kw = dict(lmda_path_size=100, min_ratio=1e-2, intercept=False,
                  early_exit=False)
        if cell == "grouped":
            kw["groups"] = np.arange(0, 2000, 4)
    kw = dict(kw, device=device)
    X, y = X.astype(dtype), y.astype(dtype)
    Xm = ad.matrix.dense(X, device=device)
    extra = {"groups": kw["groups"]} if "groups" in kw else {}
    for tol in tols:
        t0 = time.perf_counter()
        path = ad.grpnet(Xm, ad.glm.gaussian(y), **dict(kw, tol=tol))
        t1 = time.perf_counter()
        pin = ad.state.gaussian_pin_naive(
            X=Xm, y=y, screen_set=path.screen_set, lmda_path=path.lmdas,
            intercept=False, tol=tol, **extra).solve()
        t2 = time.perf_counter()
        B = path.betas.toarray()
        gap = float(np.abs(pin.betas.toarray() - B).max() / np.abs(B).max())
        print(f"{cell} {device} {dtype} tol {tol:.0e}: path {t1 - t0:.3f} s "
              f"({len(path.lmdas)} lambdas, error {path.error!r}), pin state "
              f"{t2 - t1:.3f} s on {len(path.screen_set)} groups; beta gap "
              f"{gap:.3e} of max |beta|", flush=True)


if __name__ == "__main__":
    if len(sys.argv) < 5:
        print(__doc__)
        sys.exit(2)
    main(sys.argv[1:])
