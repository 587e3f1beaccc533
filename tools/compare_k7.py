#!/usr/bin/env python3
"""Time K7 and the standalone-solver cells of several trees on one card,
in turns.

    python3 tools/compare_k7.py [--no-a2] LABEL=DIR [LABEL=DIR ...]

Each DIR is the root of a checkout (a ``git archive`` of a commit,
unpacked in a directory that ``.gitignore`` lists, or the repo itself),
whose own ``adelie_tpu_torch`` is measured in a process of its own started
in that root, in the order given: name a tree more than once to take
turns, as in ``parent=build/parent change=. change=. parent=build/parent``.
Every tree gets the same inputs, made by this script's own
``chip_smoke.py`` (``k7_problem``, ``headline_problem``).  A process
measures:

* K7 alone (``screened_cd_solve``, CUDA events, no twin) on phase 4c's
  problems: float32 and float64, box and pinball, S in {64, 1000, 2048,
  8192}, cold and warm (3 calls at S >= 2048, else 10), the floor at S =
  1000 and 8192 in float32, and the dense warm start at S = 8192 in
  float64: ms a fit, us an update and a move;
* A1, ``bvls`` as non-negative least squares on the headline's X and y
  (n = 40,000, p = 2,000, float32): a warm-up and five timed fits (median
  wall), and the first timed fit's peak device memory above what was
  allocated before it;
* unless ``--no-a2``, A2, ``pinball`` on A (4,096, 1,024), float64, tol
  1e-12: one timed fit (about two minutes on the first K7): its wall,
  KKT rounds, sweeps, objective and peak device memory.

The script fails unless every run gives the same bits (a hash of each K7
case's beta, grad, flags and info; A1's and A2's coefficients).  It
prints one JSON line a run and a summary by label.  Needs one CUDA
device.
"""

import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CASES = tuple((S, dt, mode, case, 3 if S >= 2048 else 10)
              for dt in ("float32", "float64")
              for mode in ("box", "pinball")
              for S in (64, 1000, 2048, 8192)
              for case in ("cold", "warm")) + (
    (1000, "float32", "box", "floor", 10),
    (8192, "float32", "box", "floor", 10),
    (8192, "float64", "box", "dense", 3))


def problems():
    """This script's own chip_smoke.py, whichever tree is measured."""
    spec = importlib.util.spec_from_file_location("k7_inputs",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(*arrays):
    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def peak_start():
    """The device memory allocated now, the peak counter reset."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_gib(base):
    """The peak device memory since ``peak_start`` above its ``base``."""
    import torch

    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def worker(label, with_a2):
    """One tree's measurements, from its root."""
    sys.path.insert(0, str(Path.cwd()))
    import numpy as np
    import torch

    import adelie_tpu_torch as ad
    from adelie_tpu_torch import _build
    from adelie_tpu_torch.solver import screened_cd_kernels as kc

    cs = problems()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(tree=label, card=cs.nvidia_smi())
    _build.load()
    k7 = {}
    for i, (S, dt, mode, case, reps) in enumerate(CASES):
        args = cs.k7_problem(S, getattr(torch, dt), mode, S + i, case)
        ms = cs.cuda_ms(lambda: kc.screened_cd_solve(*args), reps=reps)
        b, g, a, info = kc.screened_cd_solve(*args)
        info = info.tolist()
        k7[f"{mode} S={S} {dt} {case}"] = dict(
            ms=ms, us_per_update=ms * 1e3 / max(info[4], 1),
            us_per_move=ms * 1e3 / max(info[3], 1), sweeps=info[1],
            bits=digest(b.cpu().numpy(), g.cpu().numpy(), a.cpu().numpy(),
                        np.array(info)))
        del args
        torch.cuda.empty_cache()
    out["k7"] = k7
    X, y = cs.headline_problem(40000, 2000, 60, seed=0)
    Xm = ad.matrix.dense(X, device="cuda")
    lo, hi = np.zeros(2000, np.float32), np.full(2000, np.inf, np.float32)
    cs.timed(lambda: ad.bvls(Xm, y, lo, hi))
    walls, st = [], None
    for i in range(5):
        if i == 0:
            peak = peak_start()
        wall, st = cs.timed(lambda: ad.bvls(Xm, y, lo, hi))
        if i == 0:
            peak = peak_gib(peak)
        walls.append(wall)
    out["a1"] = dict(wall_median=float(np.median(walls)), walls=walls,
                     sweeps=int(st.iters), peak_gib=peak,
                     bits=digest(st.beta))
    del Xm, X
    torch.cuda.empty_cache()
    if with_a2:
        rng = np.random.default_rng(41)
        A = rng.standard_normal((4096, 1024))
        Z = rng.standard_normal((4096, 1024))
        Sg = Z.T @ Z / 4096
        v = rng.standard_normal(1024)
        pn, pp = rng.uniform(0.5, 1.5, 4096), rng.uniform(0.5, 1.5, 4096)
        peak = peak_start()
        wall, st = cs.timed(lambda: ad.pinball(A, Sg, v, pn, pp, tol=1e-12))
        out["a2"] = dict(wall=wall, sweeps=int(st.iters), kkt=int(st.n_kkt),
                         loss=float(st.loss), peak_gib=peak_gib(peak),
                         bits=digest(st.beta))
    print("RESULT " + json.dumps(out), flush=True)


def main(trees, with_a2):
    script = str(Path(__file__).resolve())
    runs = []
    for label, tree in trees:
        t0 = time.perf_counter()
        cmd = [sys.executable, script, "--worker", label]
        proc = subprocess.run(cmd + ([] if with_a2 else ["--no-a2"]),
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
    for key in runs[0]["k7"]:
        if len({r["k7"][key]["bits"] for r in runs}) != 1:
            raise SystemExit(f"K7 {key}: the trees' results differ")
    for cell in ("a1", "a2") if with_a2 else ("a1",):
        if len({(r[cell]["bits"], r[cell]["sweeps"]) for r in runs}) != 1:
            raise SystemExit(f"{cell}: the trees' fits differ")
    summary = dict(card=runs[0]["card"], same_bits=True)
    for label in dict(trees):
        rs = [r for r in runs if r["tree"] == label]
        summary[label] = dict(
            k7={k: [r["k7"][k]["ms"] for r in rs] for k in rs[0]["k7"]},
            k7_us_per_move={k: [r["k7"][k]["us_per_move"] for r in rs]
                            for k in rs[0]["k7"]},
            a1_wall_median=[r["a1"]["wall_median"] for r in rs],
            a1_peak_gib=[r["a1"]["peak_gib"] for r in rs],
            a2_wall=[r["a2"]["wall"] for r in rs] if with_a2 else None,
            a2_peak_gib=([r["a2"]["peak_gib"] for r in rs] if with_a2
                         else None),
            a2_sweeps=rs[0]["a2"]["sweeps"] if with_a2 else None)
    print("SUMMARY " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    argv = sys.argv[1:]
    with_a2 = "--no-a2" not in argv
    argv = [a for a in argv if a != "--no-a2"]
    if len(argv) == 2 and argv[0] == "--worker":
        worker(argv[1], with_a2)
    elif argv and all("=" in a for a in argv):
        main([tuple(a.split("=", 1)) for a in argv], with_a2)
    else:
        raise SystemExit(__doc__)
