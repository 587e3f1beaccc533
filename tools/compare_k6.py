#!/usr/bin/env python3
"""Time K6 and the grouped cells of several trees on one card, in turns.

    python3 tools/compare_k6.py [--k6-only] LABEL=DIR [LABEL=DIR ...]

Each DIR is the root of a checkout (a ``git archive`` of a commit,
unpacked in a directory that ``.gitignore`` lists, or the repo itself),
measured by its own ``chip_smoke.py`` in a process of its own started in
that root, in the order given: name a tree more than once to take turns,
as in ``parent=build/parent change=. change=. parent=build/parent``.  A
process measures:

* K6 alone (CUDA events, no twin) on phase 4b's problems: a whole solve and
  us an update at S = 1024 qmax 4 cold in float32 and float64, the floor
  (every update 0) in both, S = 4096 qmax 4 and S = 1024 qmax 32 cold in
  float32;
* unless ``--k6-only``, the grouped headline (phase 5b: n = 40,000,
  p = 2,000 in 500 groups of 4, 100 lambdas, float32): a warm-up fit, five
  timed fits (median wall), the first timed fit's Newton counts, a hash of
  its lambdas and coefficients, and one fit under ``torch.profiler`` (K6's
  device time); and the grouped phased cell (phase 10b: 50,000 samples,
  10,000 SNPs x 3 ancestries, one group a SNP, 50 lambdas, float32), the
  same with three timed fits.

The script fails unless every run gives the same lambdas, coefficients,
Newton steps (as the full walks count them) and histogram.  It prints one
JSON line a run and a summary by label.  Needs one CUDA device.
"""

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

K6_CASES = ((1024, 4, "float32", "cold"), (1024, 4, "float64", "cold"),
            (1024, 4, "float32", "floor"), (1024, 4, "float64", "floor"),
            (4096, 4, "float32", "cold"), (1024, 32, "float32", "cold"))


def digest(state):
    import numpy as np

    h = hashlib.sha256(np.ascontiguousarray(state.lmdas).tobytes())
    h.update(np.ascontiguousarray(state.betas.toarray()).tobytes())
    return h.hexdigest()[:16]


def k6_device_ms(prof):
    if prof is None:
        return None
    return sum(ms for name, (_, ms) in prof[2].items()
               if "pin_group_solve_kernel" in name)


def cell(cs, ad, pg, Xm, y, kw, timed):
    """Warm-up, ``timed`` fits, one profiled: walls, Newton counts of the
    first timed fit, the hash of its path, K6's device time."""
    import numpy as np

    cs.fit(ad, Xm, y, **kw)
    pg.reset_newton()
    walls, first = [], None
    for i in range(timed):
        wall, st = cs.fit(ad, Xm, y, **kw)
        walls.append(wall)
        if i == 0:
            first = (dict(pg.newton), digest(st), len(st.lmdas))
    prof = cs.profile_fit(ad, Xm, y, **kw)
    newton, path, n_lmdas = first
    return dict(wall_median=float(np.median(walls)), walls=walls,
                lambdas=n_lmdas, path=path, newton=newton,
                k6_device_ms=k6_device_ms(prof),
                busy_ms=None if prof is None else prof[1],
                profiled_wall=None if prof is None else prof[0])


def worker(label, k6_only):
    """One tree's measurements, from its root (its own chip_smoke.py)."""
    sys.path.insert(0, str(Path.cwd()))
    import numpy as np
    import torch

    import chip_smoke as cs
    import adelie_tpu_torch as ad
    from adelie_tpu_torch import _build
    from adelie_tpu_torch.solver import pin_group_kernels as pg

    torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(tree=label, card=cs.nvidia_smi())
    _build.load()
    k6 = {}
    for S, qmax, dt, case in K6_CASES:
        seed = S + 5 if case == "floor" else S + qmax
        args = cs.k6_problem(S, qmax, getattr(torch, dt), seed, case)
        ms = cs.cuda_ms(lambda: pg.pin_group_solve(*args), reps=10)
        updates = pg.pin_group_solve(*args)[3][3].item()
        k6[f"S={S} qmax={qmax} {dt} {case}"] = dict(
            ms=ms, us_per_update=ms * 1e3 / updates)
    out["k6"] = k6
    if k6_only:
        print("RESULT " + json.dumps(out), flush=True)
        return
    X, y = cs.headline_problem(40000, 2000, 60, seed=0)
    Xm = ad.matrix.dense(X, device="cuda")
    kw = dict(lmda_path_size=100, min_ratio=1e-2, intercept=False,
              early_exit=False, device="cuda", groups=np.arange(0, 2000, 4))
    out["grouped_headline"] = cell(cs, ad, pg, Xm, y, kw, timed=5)
    del Xm, X
    io, y10 = cs.snp_problem(cs.PHASED_S * cs.PHASED_A, cs.PHASED_N, 20,
                             seed=10, lut=cs.code_lut(False))
    Xm10 = ad.matrix.snp_phased_ancestry(io, dtype=np.float32,
                                         device="cuda")
    kw10 = dict(lmda_path_size=50, min_ratio=5e-2, device="cuda",
                groups=cs.PHASED_A * np.arange(cs.PHASED_S))
    out["grouped_phased"] = cell(cs, ad, pg, Xm10, y10, kw10, timed=3)
    print("RESULT " + json.dumps(out), flush=True)


def main(trees, k6_only):
    script = str(Path(__file__).resolve())
    runs = []
    for label, tree in trees:
        t0 = time.perf_counter()
        cmd = [sys.executable, script, "--worker", label]
        proc = subprocess.run(cmd + (["--k6-only"] if k6_only else []),
                              cwd=tree, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"the {label} run in {tree} failed "
                             f"(exit {proc.returncode})")
        run = json.loads(lines[-1][len("RESULT "):])
        run["seconds"] = time.perf_counter() - t0
        print(json.dumps(run), flush=True)
        runs.append(run)
    cells = () if k6_only else ("grouped_headline", "grouped_phased")
    for key in cells:
        seen = {(r[key]["path"], r[key]["newton"]["iters"],
                 tuple(r[key]["newton"]["hist"])) for r in runs}
        if len(seen) != 1:
            raise SystemExit(f"{key}: the trees' paths or Newton counts "
                             f"differ: {seen}")
    summary = dict(card=runs[0]["card"], same_paths_and_newton=bool(cells))
    for label in dict(trees):
        rs = [r for r in runs if r["tree"] == label]
        summary[label] = dict(
            k6={k: [r["k6"][k]["us_per_update"] for r in rs]
                for k in rs[0]["k6"]},
            **{key: dict(wall_median=[r[key]["wall_median"] for r in rs],
                         k6_device_ms=[r[key]["k6_device_ms"] for r in rs],
                         steps_run=[r[key]["newton"].get("steps_run")
                                    for r in rs],
                         iters=rs[0][key]["newton"]["iters"])
               for key in cells})
    print("SUMMARY " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    argv = sys.argv[1:]
    k6_only = "--k6-only" in argv
    argv = [a for a in argv if a != "--k6-only"]
    if len(argv) == 2 and argv[0] == "--worker":
        worker(argv[1], k6_only)
    elif argv and all("=" in a for a in argv):
        main([tuple(a.split("=", 1)) for a in argv], k6_only)
    else:
        raise SystemExit(__doc__)
