#!/usr/bin/env python3
"""Drive adelie_tpu_torch's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (phases 8, 12, 13 and 14 a few):

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from adelie_tpu_torch/csrc;
3. K1 ``pin_lasso_solve`` (the whole pin solve up to S = 1024) against
   its twin, bit-equal: float32 and float64 at S in {64, 1000, 1024} from
   a cold start, and at S = 1024 from warm starts whose active list K1
   keeps resident (float32) and streams (float64); the time per update
   beside the kernel's floor (every delta 0) at S = 128 and 1024, and
   beside the first K1's time; then a float64 BASIL fit with a
   ``screen_cap_min`` of 6 and of 10, not multiples of 4, whose screen
   capacities round up to multiples of 4 (K1 at S = 8 or 12), against
   the fit at the default capacity;
4. K2 ``pin_lasso_solve_rows`` (the whole pin solve past S = 1024)
   against its twin, bit-equal: float32 and float64 at S in {2048, 8192}
   from a cold and a warm start, with invalid slots and a penalty of 0 at
   S = 2048, and, with rows the ring streams in segments and a list in
   global memory, at S = 16384 in float64 and S = 32768 and 65536 in
   float32; the time per update beside the kernel's floor (the same
   kernel on a list whose every delta is 0);
4b. K6 ``pin_group_solve`` (the whole pin solve of a screen holding groups
    of size > 1) against its twin on the CPU: float32 and float64, S in
    {64, 1024, 4096} (and 16,384 in float64, grad and beta in global
    memory), qmax in {2, 4, 8, 32} (and 64 in float64, V read from global
    memory), groups of mixed sizes (one of
    size 1), a rank-deficient block and a zero penalty, from a cold start
    (alpha 1) and a warm one (alpha 0.5), and four float32 warm cases whose
    root finds reach ``newton_max_iters`` (S in {1024, 4096}, qmax in
    {4, 16}): beta, grad, active flags and info bit-equal to the twin's in
    every case; each case's finds at the cap, cycle exits, Newton steps
    run and time per update beside the chain's floor (every update 0) in
    float32 at S = 1024 and 4096 and float64 at 1024;
5. the headline fit: ``grpnet(X, glm.gaussian(y))`` on "cuda" at
   n = 40,000, p = 2,000, 100 lambdas, float32 (bench.py's problem), with a
   per-lambda KKT check in numpy float64, and one more fit under
   ``torch.profiler`` (K1's device time and the idle share);
5b. the grouped headline: phase 5's problem in 500 groups of 4 (K6 for
    every pin solve but the first dry fit's, whose screen holds no group):
    a warm-up, five timed fits (median wall; the first two bit-equal),
    K6's launches, the Newton iterations' histogram (the share of root
    finds that ran ``newton_max_iters``), the steps run and the cycle
    exits, three of the warm-up fit's K6 calls with root finds at the cap
    replayed on the host by the twin with full Newton walks (beta, grad,
    flags and counts equal to the kernel's, or the run fails), K6's bound
    over the fit's calls, a group KKT check per lambda in float64, peak
    memory, one more fit under ``torch.profiler``;
6. the big-S fit, whose screen set passes 1024, so K2 carries it: a
   warm-up fit whose every K2 solve is held bit-equal to the twin on the
   CPU on copies of its inputs, a timed fit (one K2 launch per pin solve
   past 1024, read from the state) and one under ``torch.profiler``;
7. a float64 fit on "cuda" and on "cpu", and (7b) one whose screen passes
   1024, so K2 on the card meets its twin on the CPU, with every K2 solve
   of the card's fit replayed on the CPU twin;
   (7c) a float64 fit of ``data.dense(2000, 300, 60)`` (groups of
   unequal sizes) on "cuda" and on "cpu": K6 against its twin in a path;
8. K3 ``snp_mul`` and K4 ``snp_mul_no_na`` against their twins: float
   checks at (p, n) = (300, 257), (513, 1,000), (513, 4,091) and
   (20,000, 50,000), whose rows of nb = ceil(n / 4) bytes start at every
   offset mod 4 (nb % 4 = 1, 2, 3, 0), in float32 and float64 against the
   twin in float64; then exact checks with integer inputs (bit-equal) at
   the GWAS shape, p = 200,000 with n = 50,000 (rows 4-byte aligned) and
   n = 50,001 (not), each timed; phases 9 and 10 time them on their
   matrices beside their times before the redesign;
9. the GWAS fit: ``grpnet(matrix.snp_unphased(io), glm.gaussian(y))`` at
   n = 50,000 samples, p = 200,000 SNPs (2.5 GB packed; bench.py's GWAS
   problem), 50 lambdas, float32, intercept, with a per-lambda KKT check
   in float64 on the card, and one more fit under ``torch.profiler``
   (device busy time by kernel); then K3's time on that matrix beside its
   twin's, its bound and a cuBLAS gemv on the decoded float32 matrix;
10. the phased-ancestry fit: n = 50,000, 10,000 SNPs x 3 ancestries,
    ``groups=None``, 50 lambdas, float32, the same KKT check and profile;
    then K4's times as K3's;
    (10b) the same panel grouped one SNP a group (its three ancestry
    columns), K4 and K6, with a group KKT check, the Newton counts, K6's
    bound over the fit's calls and a profiled fit (K6's device time);
11. a ``.snpdat`` file written and read by ``adelie_tpu_torch.io``, fitted
    in float64 on "cuda" and on "cpu";
12. K5 ``snp_mul_many`` against its twin: float checks at fifteen
    (p, n, C) (every nb % 4, C from 1 to 200 on both sides of every
    boundary of the kernel's 2-, 8-, 32- and 64-column variants and of its
    column blocks, C = 50 and 100 among them, tensors starting unaligned)
    in float32 and float64; exact checks with integer inputs at a
    north-star tile (65,536 x 100,000) for C in {1, 2, 20, 50, 100} and on
    both sides of each boundary; on float inputs at that tile, each column
    bit-equal across C in {1, 2, 50, 100, 129}; the wrapper's column
    widths against the library's; the same exact checks through the
    streamed ``mul_many`` over four tiles for C in {2, 20, 100};
13. the host-streamed path against the in-device one: phase 9's GWAS
    panel and phase 11's ``.snpdat`` problem (``tile_snps=256``, a ragged
    last tile) fitted streamed on "cuda", with the speculative union off,
    against phase 9's and phase 11's in-device fits;
14. the north star: ``grpnet(matrix.snp_unphased(io, streaming=True),
    glm.gaussian(y))`` over 1,000,000 SNPs x 100,000 samples (25 GB packed
    in host memory; benchmark/north_star_data.py's panel, made here), 50
    lambdas, float32, one warm-up fit, one timed, one profiled, a KKT
    check in float64 from one plain pass over the panel, one chunk pass
    (``mul_many`` at the path's C) against a copy-only pass, K5's device
    time by variant against the tile copies' in the profiled fit, and
    K5's times on its first tile at C in {1, 2, 50, 100}.  The panel is cut in whole tiles, and the cut
    printed, if the host's available memory cannot hold it and 16 GB
    more.

Each main path has its launch counts: the counters are zeroed just before
phase 5's timed fit and read just after it (K1), zeroed before phase 5b's
first timed fit and read after it (K6), zeroed before phase 6's timed fit
and read after it (K2), zeroed before phase 9 and read after it (K3),
zeroed before phase 10 and read after it (K4; and before and after 10b's
timed fit, K4 and K6), and zeroed before phase 14's timed fit and read
after it (K5, with no K3).  Every kernel must have run on its path.  Any failed
phase exits non-zero.  The last three lines are the kernels' JSON, the
card's name and power limit, and ``{"ok": true, "device": ...}``.  Needs
one CUDA device; exits 1 without one.
"""

import json
import subprocess
import sys
import time


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    raise SystemExit(1)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


# --------------------------------------------------------------------------- #
# phases 3 and 4: each kernel against its twin                                 #
# --------------------------------------------------------------------------- #


def k1_problem(S, dtype, seed, case="cold"):
    """A well-conditioned screen problem for K1 on the card, as slot
    buffers (one slot a position): A = X^T X / n with n = 4 S
    (eigenvalues in about [0.25, 2.25]), the last three slots invalid,
    lambda 0.05 max |grad|.  ``case``: "cold" (beta 0, nothing active: the
    first K1's phase-3 problem); "warm" (``frac`` of the valid coordinates
    given beta and active, the gradient moved to match, every seventh slot
    invalid as well); "floor" (every eigenvalue 0 and alpha 1, so every
    update has a zero denominator and keeps its coefficient: the chain
    with no AXPY, over an active list of ``frac`` of the slots and a full
    sweep)."""
    import numpy as np
    import torch

    case, frac = (case, 0.0) if isinstance(case, str) else case
    rng = np.random.default_rng(seed)
    n = 4 * S
    X = torch.as_tensor(rng.standard_normal((n, S)), device="cuda")
    beta_true = np.where(rng.random(S) < 0.2, rng.standard_normal(S), 0.0)
    y = X @ torch.as_tensor(beta_true, device="cuda") \
        + 0.5 * torch.as_tensor(rng.standard_normal(n), device="cuda")
    A64 = X.T @ X / n
    g = X.T @ y / n
    valid = np.ones(S, bool)
    valid[-3:] = False
    pen = rng.uniform(0.5, 1.5, S)
    beta0 = np.zeros(S)
    act0 = np.zeros(S, bool)
    if case == "warm":
        valid[5::7] = False
        beta0 = np.where(valid & (rng.random(S) < frac),
                         0.05 * rng.standard_normal(S), 0.0)
        g = g - A64 @ torch.as_tensor(beta0, device="cuda")
        act0 = beta0 != 0
    elif case == "floor":
        act0 = valid & (rng.random(S) < frac)
    A = A64.to(dtype).contiguous()
    ev = torch.where(torch.as_tensor(valid, device="cuda"), torch.diagonal(A),
                     0)
    if case == "floor":
        ev = torch.zeros_like(ev)
    lmda = 0.05 * float(g.abs().max())
    dev = dict(device="cuda")
    return (A, g.to(dtype), torch.as_tensor(beta0, dtype=dtype, **dev),
            torch.arange(S, dtype=torch.int64, **dev),
            torch.as_tensor(valid.astype(np.int32), **dev),
            ev[:, None].contiguous(), torch.as_tensor(pen, dtype=dtype, **dev),
            torch.as_tensor(act0, **dev), lmda, 1.0, 1e-7, 100000, 0.0)


def counted_twin(tk, run):
    """``run()`` with the twins' passes counted: listed updates, moved
    updates and distinct moved rows.  Returns (run's result, counts)."""
    count = dict(listed=0, moved=0, rows=set())
    inner = tk.cd_sweep_rows_ref

    def counted(A, beta, grad, pos, akk, pk, n, l1, l2, rsq):
        out = inner(A, beta, grad, pos, akk, pk, n, l1, l2, rsq)
        k = int(n.item())
        moved = out[2][:k]
        count["listed"] += k
        count["moved"] += int(moved.sum())
        count["rows"].update(pos[:k][moved].tolist())
        return out

    tk.cd_sweep_rows_ref = counted
    try:
        return run(), count
    finally:
        tk.cd_sweep_rows_ref = inner


def solve_case(what, kernel, twin, args, reps):
    """A whole-solve kernel (K1 or K2) against its twin on the same inputs:
    bit-equal beta, grad and active flags, equal (rsq, iters, done), a
    converged solve.  The twin's passes are counted for the per-update time
    and the bound."""
    from adelie_tpu_torch.solver import pin_kernels as tk

    ms = cuda_ms(lambda: kernel(*args), reps=reps)
    b_k, g_k, a_k, info_k = kernel(*args)
    (plain_ms, (b_t, g_t, a_t, info_t)), count = counted_twin(
        tk, lambda: host_ms(lambda: twin(*args)))
    for name, x, y in (("beta", b_k, b_t), ("grad", g_k, g_t),
                       ("active", a_k, a_t)):
        if not same_bits(x, y):
            err = float((x.double() - y.double()).abs().max())
            fail(f"{what}: {name} differs from the twin (max |diff| "
                 f"{err:.3e})")
    if info_k.tolist() != info_t.tolist():
        fail(f"{what}: (rsq, iters, done) {info_k.tolist()} against the "
             f"twin's {info_t.tolist()}")
    rsq, iters, done = info_k.tolist()
    if done != 1.0:
        fail(f"{what}: the solve did not converge (iters {iters})")
    listed = max(count["listed"], 1)
    return dict(ms=ms, plain_ms=plain_ms, iters=int(iters),
                listed=count["listed"], moved=count["moved"],
                rows=len(count["rows"]), us_per_update=ms * 1e3 / listed,
                max_abs_err=0.0, n_active=int(a_k.sum()),
                out=(b_k, g_k, a_k, info_k))


def k1_case(S, dtype, seed, case="cold"):
    """K1 against its twin, bit-equal (``solve_case``); with the active
    list at entry and the rows K1 keeps resident at this S and dtype."""
    from adelie_tpu_torch import _build
    from adelie_tpu_torch.solver import pin_kernels as tk

    args = k1_problem(S, dtype, seed, case)
    r = solve_case(f"K1 S={S} {dtype} {case}", tk.pin_lasso_solve,
                   tk.pin_lasso_solve_ref, args, reps=10)
    del r["out"]
    return dict(r, S=S, dtype=str(dtype), case=case,
                active0=int(args[7].sum()),
                resident=_build.load().adelie_pin_lasso_solve_resident_rows(
                    S, dtype.itemsize))


# K1 before this redesign (one thread a coordinate, every sweep over all S
# slots, each row read after its update's barrier): its phase-3 times on
# the "cold" problems, which the redesign solves by the same updates
# (NVIDIA H100 80GB HBM3, 700.00 W; the earlier chip_smoke.py, phase 3).
# At S = 64 the earlier kernel was faster: 64 threads on a block barrier,
# against 288 threads, a named barrier and the lists' prefix sums.
K1_OLD_MS = {(64, "torch.float32"): 0.215, (1000, "torch.float32"): 3.483,
             (1024, "torch.float32"): 3.542, (64, "torch.float64"): 0.229,
             (1000, "torch.float64"): 3.873, (1024, "torch.float64"): 3.930}
# K2 before its redesign: one launch per sweep, 0.414 ms for a pass of
# 400 listed updates at S = 2048 in float32 (the same card; the earlier
# chip_smoke.py, phase 4)
K2_OLD_US_PER_UPDATE = 0.414e3 / 400


def odd_cap_case(ad, tk, cap_min):
    """Phase 3: a ``screen_cap_min`` that is not a multiple of 4, on the
    card.  The screen capacities round up to one, so BASIL's first screens
    run K1 at S = 8 or 12, and the float64 path is the default capacity's
    (lambdas to rtol 1e-10, beta to atol 1e-6, as the CPU tests hold it).
    Returns the capacities and K1's launches."""
    import numpy as np

    X, y = headline_problem(120, 40, 6, seed=5)
    X, y = X.astype(np.float64), y.astype(np.float64)

    def path():
        return fit(ad, ad.matrix.dense(X, device="cuda"), y,
                   lmda_path_size=20, device="cuda")[1]

    ad.set_configs("screen_all_max", 0)
    try:
        ref = path()
        ad.set_configs("screen_cap_min", cap_min)
        n0 = tk.launches["pin_lasso_solve"]
        st = path()
        n_k1 = tk.launches["pin_lasso_solve"] - n0
    finally:
        ad.set_configs("screen_all_max", None)
        ad.set_configs("screen_cap_min", None)
    caps = st.benchmark["pin_caps"]
    what = f"K1 with screen_cap_min {cap_min}"
    if st.error or ref.error or n_k1 <= 0:
        fail(f"{what}: errors {st.error!r}, {ref.error!r}, {n_k1} launches")
    if any(c % 4 for c in caps) or min(caps) >= 2 * cap_min:
        fail(f"{what}: screen capacities {sorted(set(caps))}")
    d_beta = float(np.abs(st.betas.toarray() - ref.betas.toarray()).max())
    if (len(st.lmdas) != len(ref.lmdas)
            or not np.allclose(st.lmdas, ref.lmdas, rtol=1e-10, atol=0)
            or d_beta > 1e-6):
        fail(f"{what}: path differs from the default capacity's "
             f"({len(st.lmdas)} against {len(ref.lmdas)} lambdas, max "
             f"|d beta| {d_beta:.2e})")
    return sorted(set(caps)), n_k1


def same_bits(a, b):
    """Bit-equal tensors (so -0.0 differs from 0.0)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        view = torch.int32 if a.element_size() == 4 else torch.int64
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return torch.equal(a.cpu(), b.cpu())


def k2_problem(S, dtype, seed, case):
    """A pin problem for K2 on the card: A = I + B^T B / 256 (B 256 x S,
    eigenvalues in [1, about (1 + sqrt(S / 256))^2]), one slot a position,
    lambda letting about 200 coordinates in at the start.  ``case``:
    "cold" (beta 0, nothing active); "warm" (5 % of beta given and active,
    the gradient moved to match); "holes" (every seventh slot invalid, one
    slot with penalty 0, alpha 0.7); "floor" (every eigenvalue 0 and
    alpha 1, so every listed update has a zero denominator and keeps its
    coefficient: the chain with no AXPY, the kernel's per-update floor)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dev = dict(device="cuda")
    B = torch.as_tensor(rng.standard_normal((256, S)), **dev)
    if S <= 16384:
        A64 = torch.eye(S, dtype=torch.float64, **dev) + B.T @ B / 256
    else:
        # made in the solve's dtype, in place: at S = 65536 the float64
        # expression would need 96 GB
        A64 = B.to(dtype).T @ B.to(dtype)
        A64 /= 256
        A64.diagonal().add_(1)
    del B
    g = torch.as_tensor(rng.standard_normal(S), **dev)
    valid = np.ones(S, bool)
    pen = rng.uniform(0.5, 1.5, S)
    alpha = 1.0
    if case == "holes":
        valid[5::7] = False
        pen[3] = 0.0
        alpha = 0.7
    beta0 = np.zeros(S)
    if case == "warm":
        beta0 = np.where(valid & (rng.random(S) < 0.05),
                         0.1 * rng.standard_normal(S), 0.0)
        g = g - A64 @ torch.as_tensor(beta0, **dev)
    lmda = float(torch.quantile(g.abs(), 1 - 200 / S))
    if case == "floor":
        lmda = 1e-3 * float(g.abs().max())
    A = A64.to(dtype).contiguous()  # no copy when made in its dtype
    del A64
    ev = torch.where(torch.as_tensor(valid, **dev), torch.diagonal(A), 0)
    if case == "floor":
        ev = torch.zeros_like(ev)
    tol = 1e-7 if dtype == torch.float32 else 1e-12
    args = (A, g.to(dtype), torch.as_tensor(beta0, dtype=dtype, **dev),
            torch.arange(S, dtype=torch.int64, **dev),
            torch.as_tensor(valid.astype(np.int32), **dev),
            ev[:, None].contiguous(), torch.as_tensor(pen, dtype=dtype, **dev),
            torch.as_tensor(beta0 != 0, **dev), lmda, alpha, tol, 100000, 0.0)
    return args


def k2_case(S, dtype, seed, case):
    """K2 against its twin on the same inputs, bit-equal (``solve_case``)."""
    from adelie_tpu_torch.solver import pin_kernels as tk

    args = k2_problem(S, dtype, seed, case)
    r = solve_case(f"K2 S={S} {dtype} {case}", tk.pin_lasso_solve_rows,
                   tk.pin_lasso_solve_rows_ref, args, reps=5)
    return dict(r, S=S, dtype=str(dtype), case=case, args=args)


def k2_kept(run):
    """``run()`` with every K2 call of ``pin_cov_solve`` kept: a copy of its
    inputs and its results, on the CPU.  Returns (run's result, calls)."""
    import torch

    from adelie_tpu_torch.solver import pin

    inner = pin.pin_lasso_solve_rows
    calls = []

    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x

    def kept(*args):
        held = [cpu(x) for x in args]  # before the launch: inputs as given
        out = inner(*args)
        calls.append((held, [cpu(x) for x in out]))
        return out

    pin.pin_lasso_solve_rows = kept
    try:
        return run(), calls
    finally:
        pin.pin_lasso_solve_rows = inner


def k2_replay(what, calls):
    """Each kept K2 call's inputs through the twin on the CPU: its beta,
    grad, active flags and (rsq, iters, done) must equal the kernel's bit
    for bit.  Returns the number of calls."""
    from adelie_tpu_torch.solver import pin_kernels as tk

    for i, (args, out) in enumerate(calls):
        twin = tk.pin_lasso_solve_rows_ref(*args)
        for name, x, y in zip(("beta", "grad", "active", "info"), out, twin):
            if not same_bits(x, y):
                fail(f"{what}: K2 solve {i} (S={args[0].shape[0]}): {name} "
                     "differs from the twin on the same inputs")
    return len(calls)


# --------------------------------------------------------------------------- #
# phase 4b: K6 against its twin                                                #
# --------------------------------------------------------------------------- #


def k6_problem(S, qmax, dtype, seed, case, n=None):
    """A grouped pin problem for K6: groups of mixed sizes 1 .. qmax (one
    of size 1 and one of size qmax among them) filling S - qmax positions,
    A = X^T X / n with n = 2 S unless given, one block rank-deficient (a column repeated
    in its group: a zero eigenvalue), one group with penalty 0, eight
    invalid slots after the valid ones, the blocks' eigendecomposition by
    the port's ``screen_eigh``; lambda 0.3 of the largest group norm of the
    gradient.  ``case``: "cold" (alpha 1, beta 0, only the unpenalized
    group active); "warm" (alpha 0.5, a fifth of the groups given beta and
    active, the gradient moved to match); "floor" (lambda 2 lambda_max,
    beta 0, nothing active: every update is 0 and moves nothing, the
    chain's per-update floor).  Returns the wrapper's arguments."""
    import numpy as np
    import torch

    from adelie_tpu_torch.solver.pin import screen_eigh

    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < S - 2 * qmax:
        sizes.append(int(rng.integers(1, qmax + 1)))
    sizes += [1, qmax]
    sizes = np.asarray(sizes)
    begins = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    G = len(sizes)
    n = n or 2 * S
    X = rng.standard_normal((n, S))
    g_def = int(np.flatnonzero(sizes >= 2)[0])
    b = begins[g_def]
    X[:, b + sizes[g_def] - 1] = X[:, b]          # a zero eigenvalue
    X[:, int(sizes.sum()):] = 0.0                 # positions past the groups
    y = X[:, :40] @ rng.standard_normal(40) + rng.standard_normal(n)
    dev = dict(device=DEV)
    Xd = torch.as_tensor(X, **dev)
    A64 = Xd.T @ Xd / n
    g = Xd.T @ torch.as_tensor(y, **dev) / n
    del Xd
    pen = np.sqrt(sizes).astype(float)
    g_zero = G // 2
    pen[g_zero] = 0.0
    alpha = 0.5 if case == "warm" else 1.0
    beta0 = np.zeros(S)
    act0 = np.zeros(G, bool)
    if case == "cold":
        act0[g_zero] = True
    if case == "warm":
        act0 = rng.random(G) < 0.2
        for i in np.flatnonzero(act0):
            beta0[begins[i]:begins[i] + sizes[i]] = \
                0.05 * rng.standard_normal(sizes[i])
        g = g - A64 @ torch.as_tensor(beta0, **dev)
    gh = g.cpu().numpy()
    norms = np.asarray([np.linalg.norm(gh[b:b + q])
                        for b, q in zip(begins, sizes)])
    lmda_max = float(np.max(norms[pen > 0] / (alpha * pen[pen > 0])))
    lmda = (2.0 if case == "floor" else 0.3) * lmda_max
    pad = 8
    slot_begin = torch.as_tensor(np.concatenate([begins, np.zeros(pad, int)]),
                                 dtype=torch.int64, **dev)
    slot_size = torch.as_tensor(np.concatenate([sizes, np.zeros(pad, int)]),
                                dtype=torch.int32, **dev)
    A = A64.to(dtype).contiguous()
    ev, V = screen_eigh(A, slot_begin, slot_size, qmax)
    if case == "floor":
        act0[:] = False
    pen_t = torch.as_tensor(np.concatenate([pen, np.ones(pad)]), dtype=dtype,
                            **dev)
    act_t = torch.as_tensor(np.concatenate([act0, np.zeros(pad, bool)]),
                            **dev)
    tol = 1e-7 if dtype == torch.float32 else 1e-12
    return (A, g.to(dtype).contiguous(),
            torch.as_tensor(beta0, dtype=dtype, **dev), slot_begin, slot_size,
            ev.contiguous(), V.contiguous(), pen_t, act_t, lmda, alpha, tol,
            1e-12, 1e-12, 1000, 100000, 0.0)


def k6_case(S, qmax, dtype, seed, case, reps=3, n=None):
    """K6 against its twin (on the CPU, on copies of the same inputs):
    the same active flags and beta within 1e-10 (float64) or 1e-4 of
    max |beta| (float32), a converged solve; whether beta, grad and
    (rsq, iters, done) are also bit-equal.  Returns the numbers of the
    case: ms a solve, us an update, the twin's ms, the moved groups' rows
    (for the bound) and the Newton counts."""
    import numpy as np
    import torch

    from adelie_tpu_torch.solver import pin_group_kernels as pg

    what = f"K6 S={S} qmax={qmax} {dtype} {case}"
    args = k6_problem(S, qmax, dtype, seed, case, n)
    ms = cuda_ms(lambda: pg.pin_group_solve(*args), reps=reps)
    b_k, g_k, a_k, info_k = pg.pin_group_solve(*args)
    torch.cuda.synchronize()
    cpu_args = [x.cpu() if torch.is_tensor(x) else x for x in args]
    moved = set()
    inner = pg._group_sweep

    def counted(carry, c, listed):
        before = carry[0].copy()
        out = inner(carry, c, listed)
        for i in listed:
            b, q = int(c["begin"][i]), int(c["size"][i])
            if not np.array_equal(before[b:b + q], out[0][b:b + q]):
                moved.add(int(i))
        return out

    pg._group_sweep = counted
    try:
        t0 = time.perf_counter()
        b_t, g_t, a_t, info_t = pg.pin_group_solve_ref(*cpu_args)
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        pg._group_sweep = inner
    info_k, info_t = info_k.tolist(), info_t.tolist()
    if info_k[2] != 1.0:
        fail(f"{what}: the solve did not converge (info {info_k[:3]})")
    if not torch.equal(a_k.cpu(), a_t):
        fail(f"{what}: active flags differ from the twin's")
    err = float((b_k.cpu().double() - b_t.double()).abs().max())
    scale = float(b_t.double().abs().max())
    bar = 1e-10 if dtype == torch.float64 else 1e-4 * max(scale, 1e-30)
    if not err <= bar:
        fail(f"{what}: max |beta - twin| {err:.3e} past the bar {bar:.1e}")
    bits = (same_bits(b_k.cpu(), b_t) and same_bits(g_k.cpu(), g_t)
            and info_k == info_t)
    sizes = args[4].cpu().numpy()
    rows = int(sum(sizes[i] for i in moved))
    updates = max(int(info_k[3]), 1)
    nb = pg.NEWTON_BINS
    return dict(S=S, qmax=qmax, dtype=str(dtype), case=case, ms=ms,
                plain_ms=plain_ms, max_abs_err=err, bit_equal=bits,
                iters=int(info_k[1]), updates=int(info_k[3]),
                us_per_update=ms * 1e3 / updates, finds=int(info_k[4]),
                steps=int(info_k[5]), hist=[int(x) for x in info_k[6:6 + nb]],
                steps_run=int(info_k[6 + nb]),
                cycle_exits=int(info_k[7 + nb]), moved_groups=len(moved),
                rows=rows, n_active=int(a_k.sum()), itemsize=dtype.itemsize,
                G=int(sizes.shape[0]))


def k6_ops(S, qmax, rows, updates, steps_run):
    """FP32 operations of K6's work: an AXPY of S a moved coordinate's
    row, the two rotations and dbeta (6 qmax^2 an update), 10 qmax a
    Newton step run."""
    return 2 * S * rows + 6 * qmax * qmax * updates + 10 * qmax * steps_run


def k6_bound(r):
    """K6's bound for a case: the rows of the moved groups and V read once,
    beta, grad and the slot buffers in and out, over HBM, or ``k6_ops``
    (a floor: the chain, not the bytes, sets K6's time)."""
    S, G, q, it = r["S"], r["G"], r["qmax"], r["itemsize"]
    nbytes = (r["rows"] * S * it + G * q * q * it + G * q * it
              + 4 * S * it + G * 22)
    return bound(nbytes, k6_ops(S, q, r["rows"], r["updates"],
                                r["steps_run"]))


def k6_kept(run, keep=3):
    """``run()`` with every K6 call of ``pin_cov_solve`` measured: its S,
    slots G, qmax, coordinates whose beta changed (the moved rows of
    ``k6_bound``), updates and Newton steps run.  The inputs and results of
    the calls that have root finds at newton_max_iters are held on the
    host, and ``keep`` of them, spread over the path, returned.  Returns
    (run's result, the calls' numbers, the kept calls)."""
    import numpy as np
    import torch

    from adelie_tpu_torch.solver import pin
    from adelie_tpu_torch.solver import pin_group_kernels as pg

    inner = pin.pin_group_solve
    calls, held = [], []
    nb = pg.NEWTON_BINS

    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x

    def kept(*args):
        host = [cpu(x) for x in args] if keep else None  # as given
        out = inner(*args)
        info = out[3].tolist()
        A, beta = args[0], args[2]
        calls.append(dict(S=A.shape[0], G=args[5].shape[0],
                          qmax=args[5].shape[1],
                          rows=int((out[0] != beta).sum()),
                          itemsize=A.element_size(), updates=int(info[3]),
                          steps_run=int(info[6 + nb])))
        if keep and info[5 + nb] > 0:
            held.append((host, [cpu(x) for x in out]))
        return out

    pin.pin_group_solve = kept
    try:
        result = run()
    finally:
        pin.pin_group_solve = inner
    if len(held) > keep:
        held = [held[i] for i in np.linspace(0, len(held) - 1, keep)
                .round().astype(int)]
    return result, calls, held


def k6_cell_bound(calls):
    """K6's bound over a fit's calls (``k6_kept``): the sum of each
    call's ``k6_bound``."""
    total = [k6_bound(c) for c in calls]
    ms = sum(b[0] for b in total)
    by_bytes = sum(b[0] for b in total if b[1] == "bytes")
    return ms, "bytes" if by_bytes >= ms / 2 else "operations"


def full_newton_phase(walks):
    """``bcd._newton_phase`` with no cycle exit: every walk takes its steps
    until it meets tol or max_iters.  A walk that reaches max_iters adds
    (its cycle's period, the steps before the cycle) to ``walks``, or None
    if no h repeated."""
    import numpy as np

    from adelie_tpu_torch import bcd

    def walk(buf1, v, l1, h0, tol, max_iters):
        dt = v.dtype.type
        h = dt(h0)
        fh, dfh = bcd._newton_step(buf1, v, l1, h, bcd._tiny(dt))
        it, first, cycle = 0, {h.tobytes(): 0}, None
        while np.abs(fh) > tol and it < max_iters:
            h = np.maximum(h - fh / dfh, dt(0.0))
            fh, dfh = bcd._newton_step(buf1, v, l1, h, bcd._tiny(dt))
            it += 1
            if cycle is None:
                seen = first.setdefault(h.tobytes(), it)
                if seen != it:
                    cycle = (it - seen, seen)
        if it == max_iters:
            walks.append(cycle)
        return h, it, it, False

    return walk


def walks_line(walks):
    """The periods and tails of capped walks (``full_newton_phase``)."""
    import numpy as np

    cyc = [w for w in walks if w is not None]
    if not cyc:
        return f"{len(walks)} capped walks, none periodic"
    per = np.asarray([w[0] for w in cyc])
    tail = np.asarray([w[1] for w in cyc])
    counts = ", ".join(f"{k}: {int((per == k).sum())}" for k in (1, 2, 3, 4))
    return (f"{len(cyc)} of {len(walks)} capped walks periodic; periods "
            f"{counts}, 5-8: {int(((per >= 5) & (per <= 8)).sum())}, "
            f"more: {int((per > 8).sum())} (max {int(per.max())}); steps "
            f"before the cycle: mean {tail.mean():.1f}, max {int(tail.max())}")


def k6_replay_full(what, held):
    """Each held K6 call (``k6_kept``) through the twin with full Newton
    walks on the host: its beta, grad, active flags and (rsq, iters, done,
    updates, finds, steps, histogram) must equal the kernel's bit for bit,
    so the kernel's exit ends every capped walk where the full walk ends
    and counts its steps.  Returns (calls, finds at newton_max_iters,
    their cycle exits, the capped walks' (period, tail))."""
    from adelie_tpu_torch import bcd
    from adelie_tpu_torch.solver import pin_group_kernels as pg

    nb = pg.NEWTON_BINS
    walks = []
    inner = bcd._newton_phase
    bcd._newton_phase = full_newton_phase(walks)
    capped = exits = 0
    try:
        for i, (args, out) in enumerate(held):
            twin = pg.pin_group_solve_ref(*args)
            for name, x, y in zip(("beta", "grad", "active"), out, twin):
                if not same_bits(x, y):
                    fail(f"{what}: K6 call {i} (S={args[0].shape[0]}): "
                         f"{name} differs from the full walks' twin")
            k, t = out[3].tolist(), twin[3].tolist()
            if k[:6 + nb] != t[:6 + nb] or t[7 + nb] != 0:
                fail(f"{what}: K6 call {i}: counts {k} against the full "
                     f"walks' {t}")
            capped += int(k[5 + nb])
            exits += int(k[7 + nb])
    finally:
        bcd._newton_phase = inner
    return len(held), capped, exits, walks


def newton_line(nw):
    """The Newton counts of a fit (``pin_group_kernels.newton``)."""
    h = nw["hist"]
    finds = max(nw["solves"], 1)
    return (f"Newton: {nw['updates']} group updates, {nw['solves']} root "
            f"finds, {nw['iters']} Newton steps of the full walks "
            f"({nw['iters'] / finds:.1f} a find), {nw['steps_run']} run; "
            f"steps a find: 0: {h[0]}, " + ", ".join(
                f"[{1 << (b - 1)}, {1 << b}): {h[b]}" for b in range(1, 11))
            + f", newton_max_iters: {h[11]} ({h[11] / finds:.3f} of the "
            f"finds, {nw['cycle_exits']} ended by the cycle rule)")


# phase 4b's float32 cases whose root finds hit newton_max_iters, so that
# the walks end by the cycle rule: (S, qmax), each warm (alpha 0.5)
K6_CAPPED = ((1024, 4), (1024, 16), (4096, 4), (4096, 16))


def k6_line(r):
    """A phase-4b case's line: the check, the Newton counts, the times."""
    h = r["hist"]
    return (f"S={r['S']} qmax={r['qmax']} {r['dtype']} {r['case']}: active "
            f"flags equal to the twin's, max |beta - twin| "
            f"{r['max_abs_err']:.2e}"
            + (" (beta, grad and info bit-equal)" if r["bit_equal"]
               else " (not bit-equal)")
            + f"; iters {r['iters']}, updates {r['updates']} (moved groups "
            f"{r['moved_groups']}, active {r['n_active']}), Newton finds "
            f"{r['finds']}: {h[-1]} at newton_max_iters, {r['cycle_exits']} "
            f"ended by the cycle rule, {r['steps']} steps of the full walks, "
            f"{r['steps_run']} run; kernel {r['ms']:.3f} ms = "
            f"{r['us_per_update']:.3f} us an update; twin "
            f"{r['plain_ms']:.1f} ms")


def k6_phase(card):
    """Phase 4b: K6 against its twin in every case, bit-equal, then the
    chain's floor (every update 0) in float32 at S = 1024 and 4096 and in
    float64 at 1024.  Returns (the cases' results, the floors')."""
    import torch

    k6 = []
    for dtype in (torch.float32, torch.float64):
        for S, qmax in ((64, 2), (64, 8), (1024, 4), (1024, 32), (4096, 4),
                        (4096, 8)):
            for case in ("cold", "warm"):
                k6.append(k6_case(S, qmax, dtype, seed=S + qmax, case=case))
    # past about S = 13,000 in float64, grad, beta and the lists leave
    # shared memory for global memory (n = 4,096 samples: a Gram of rank
    # 4,096, many zero eigenvalues)
    k6.append(k6_case(16384, 4, torch.float64, seed=16388, case="cold",
                      reps=1, n=4096))
    # past STAGE_QMAX = 32, V and the coupling block are read from global
    # memory, not staged
    k6.append(k6_case(1024, 64, torch.float64, seed=1088, case="cold"))
    for S, qmax in K6_CAPPED:
        r = k6_case(S, qmax, torch.float32, seed=S + qmax + 1, case="warm")
        if r["hist"][-1] <= 0:
            fail(f"K6 S={S} qmax={qmax} float32 warm: no root find reached "
                 "newton_max_iters")
        k6.append(r)
    for r in k6:
        phase("K6", f"{k6_line(r)} | {card}")
    n_bits = sum(r["bit_equal"] for r in k6)
    phase("K6", f"{n_bits} of {len(k6)} cases bit-equal to the twin; "
          f"{sum(r['cycle_exits'] for r in k6)} of "
          f"{sum(r['hist'][-1] for r in k6)} finds at newton_max_iters "
          f"ended by the cycle rule | {card}")
    if n_bits != len(k6):
        fail("K6: " + ", ".join(
            f"S={r['S']} qmax={r['qmax']} {r['dtype']} {r['case']}"
            for r in k6 if not r["bit_equal"]) + " not bit-equal to the twin")
    floors = []
    for S, dtype in ((1024, torch.float32), (4096, torch.float32),
                     (1024, torch.float64)):
        r = k6_case(S, 4, dtype, seed=S + 5, case="floor")
        floors.append(r)
        phase("K6", f"floor S={S} qmax=4 {dtype}: {r['updates']} updates, "
              f"{r['moved_groups']} moving (the unpenalized group's ridge "
              f"update), the rest 0 (lambda above lambda_max); "
              f"{r['ms']:.3f} ms = {r['us_per_update']:.3f} us an update: "
              f"the chain's rotation, norm test and barrier | {card}")
    return k6, floors


def group_kkt_check(what, G, B, lmdas, groups, sizes, penalty, alpha):
    """The group KKT conditions per lambda, in float64: ``G`` (L, p) the
    gradients X^T W r of each lambda's fit (r with its intercept), ``B``
    (L, p) its coefficients.  Over zero groups ||G_g|| - lambda alpha p_g,
    over nonzero groups ||G_g - lambda p_g (alpha b_g / ||b_g|| +
    (1 - alpha) b_g)||, both <= 1e-2 lambda.  Returns the worst / lambda."""
    import numpy as np
    import torch

    dev = G.device
    p = G.shape[1]
    Q = int(sizes.max())
    lane = np.arange(Q)
    cols = np.where(lane[None, :] < sizes[:, None], groups[:, None] + lane,
                    p)
    cols = torch.as_tensor(cols, device=dev)
    pad = torch.zeros((G.shape[0], 1), dtype=torch.float64, device=dev)
    Gg = torch.cat([G, pad], 1)[:, cols]                  # (L, ng, Q)
    Bg = torch.cat([B, pad], 1)[:, cols]
    lm = torch.as_tensor(np.asarray(lmdas, np.float64), device=dev)
    pen = torch.as_tensor(np.asarray(penalty, np.float64), device=dev)
    bn = Bg.norm(dim=2)
    nz = bn > 0
    v0 = torch.where(nz, 0.0, Gg.norm(dim=2) - lm[:, None] * alpha
                     * pen[None, :]).amax(dim=1)
    sub = lm[:, None, None] * pen[None, :, None] * (
        alpha * Bg / torch.where(nz, bn, 1.0)[:, :, None]
        + (1 - alpha) * Bg)
    v1 = torch.where(nz, (Gg - sub).norm(dim=2), 0.0).amax(dim=1)
    worst = float((torch.maximum(v0, v1) / lm).max())
    if not worst <= 1e-2:
        fail(f"{what}: group KKT violation {worst:.3e} lambda")
    return worst


def dense_grad(X, y, state):
    """(G, B) of a dense fit with weights 1/n for ``group_kkt_check``: the
    gradients X^T (y - X b - b0) / n and the coefficients, (L, p) float64
    on the card."""
    import numpy as np
    import torch

    Xd = torch.as_tensor(np.asarray(X), device=DEV).double()
    B = torch.as_tensor(state.betas.toarray(), device=DEV).double()
    b0 = torch.as_tensor(np.asarray(state.intercepts, np.float64), device=DEV)
    y64 = torch.as_tensor(np.asarray(y, np.float64), device=DEV)
    R = y64[:, None] - Xd @ B.T - b0[None, :]
    return (Xd.T @ R).T / Xd.shape[0], B


# --------------------------------------------------------------------------- #
# phases 5 to 7: the main path                                                 #
# --------------------------------------------------------------------------- #


def kkt_check(what, X, y, state):
    """Per lambda, in numpy float64 (intercept False, weights 1/n, unit
    penalties): over zero coefficients max |x_j^T r| / n - lambda and over
    nonzeros |x_j^T r / n - lambda sign(beta_j)|, both <= 1e-2 lambda."""
    import numpy as np

    B = np.asarray(state.betas.todense(), np.float64)      # (L, p)
    Xd = np.asarray(X, np.float64)
    R = np.asarray(y, np.float64)[:, None] - Xd @ B.T      # (n, L)
    G = (Xd.T @ R) / Xd.shape[0]                           # (p, L)
    worst = 0.0
    for i, lm in enumerate(np.asarray(state.lmdas)):
        g, b = G[:, i], B[i]
        nz = b != 0
        v0 = np.max(np.abs(g[~nz]), initial=0.0) - lm
        v1 = np.max(np.abs(g[nz] - lm * np.sign(b[nz])), initial=0.0)
        worst = max(worst, max(v0, v1) / lm)
    if not worst <= 1e-2:
        fail(f"{what}: KKT violation {worst:.3e} lambda")
    return worst


def headline_problem(n, p, k, seed):
    """bench.py's problem: f32 Gaussian X, k true nonzeros, noise 0.5,
    X and y centered."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    beta = np.zeros(p)
    nz = rng.choice(p, k, replace=False)
    beta[nz] = rng.standard_normal(k)
    y = (X @ beta + 0.5 * rng.standard_normal(n)).astype(np.float32)
    X -= X.mean(axis=0)
    y -= y.mean()
    return X, y


def big_s_problem():
    """Phase 6: the headline's problem at n = 4,000, p = 2,500 with 1,500
    true nonzeros, 40 lambdas: the screen passes 1024, so K2 carries it."""
    X, y = headline_problem(4000, 2500, 1500, seed=1)
    return X, y, dict(lmda_path_size=40, intercept=False, early_exit=False,
                      device="cuda")


def big_s_check_problem():
    """Phase 7b: tests/test_torch_grpnet.py's big-S problem in float64:
    n = 50, p = 1,100, the strong rule screens past 1024 (the test's
    tol = 1e-12; phase 7b also fits it at 1e-16)."""
    import numpy as np

    rng = np.random.default_rng(3)
    X = rng.standard_normal((50, 1100))
    beta = np.zeros(1100)
    beta[rng.choice(1100, 5, replace=False)] = rng.standard_normal(5)
    y = X @ beta + 0.5 * rng.standard_normal(50) + 1.0
    return X, y, dict(screen_rule="strong", early_exit=False,
                      lmda_path_size=8, min_ratio=0.02)


def fit(ad, Xm, y, **kw):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ad.grpnet(Xm, ad.glm.gaussian(y), **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, state


# --------------------------------------------------------------------------- #
# bounds: the least time the card could take for a kernel's work             #
# --------------------------------------------------------------------------- #

# NVIDIA H100 SXM data sheet, at the full 700 W: HBM3 bytes/s, FP32 FLOP/s
# outside the tensor cores
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12


def bound(nbytes, ops):
    """(bound ms, what bounds it) for ``nbytes`` moved and ``ops`` FP32
    operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def snp_bound(p, n, has_na):
    """K3/K4 in float32: the packed bytes, u padded to 4 nb, the output
    (and impute) once; 2 p n operations."""
    nb = (n + 3) // 4
    return bound(p * nb + 4 * (4 * nb) + 4 * p * (2 if has_na else 1),
                 2 * p * n)


# --------------------------------------------------------------------------- #
# phase 8: K3 and K4 against their twins                                      #
# --------------------------------------------------------------------------- #

GWAS_N, GWAS_P = 50_000, 200_000
PHASED_N, PHASED_S, PHASED_A = 50_000, 10_000, 3
DEV = "cuda"


def code_lut(no_na):
    """256-entry byte maps.  ``no_na=False``: bench.py's LUT (bench.py:565-
    576), a uniform byte to one whose four codes follow the 86/10/4 %
    mix of 0/1/2.  ``no_na=True``: a byte with its code-3 lanes made 2."""
    import numpy as np

    codes = np.arange(256)
    lanes = np.stack([(codes >> (2 * k)) & 3 for k in range(4)], axis=1)
    if no_na:
        fixed = np.minimum(lanes, 2)
        return (fixed << (2 * np.arange(4))).sum(axis=1).astype(np.uint8)
    probs = np.array([0.86, 0.10, 0.04])
    valid = np.all(lanes <= 2, axis=1)
    byte_p = np.where(valid, np.prod(probs[np.minimum(lanes, 2)], axis=1),
                      0.0)
    cdf = np.cumsum(byte_p / byte_p.sum())
    return np.searchsorted(cdf, (np.arange(256) + 0.5) / 256).astype(np.uint8)


def card_bytes(p, nb, gen, lut=None, block=10_000):
    """(p, nb) random uint8 on the card, through ``lut`` when given."""
    import torch

    out = torch.randint(0, 256, (p, nb), dtype=torch.uint8, device=DEV,
                        generator=gen)
    if lut is not None:
        lut_t = torch.as_tensor(lut, device=DEV)
        for s in range(0, p, block):
            out[s:s + block] = lut_t[out[s:s + block].long()]
    return out


def snp_float_case(kernel, twin, p, n, dtype, no_na, seed):
    """Kernel in ``dtype`` against the twin in float64 on the same inputs:
    |got - ref| <= tol (|X|^T |u|)_j, tol 1e-4 in float32 and 1e-12 in
    float64 (the kernel sums in another order than the twin)."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    nb = (n + 3) // 4
    # from the second row on, so the tensor itself starts at offset nb
    packed = card_bytes(p + 1, nb, gen, code_lut(True) if no_na else None)[1:]
    u = torch.randn(n, dtype=torch.float64, device=DEV, generator=gen)
    imp = 2 * torch.rand(p, dtype=torch.float64, device=DEV, generator=gen)
    extra = () if no_na else (imp.to(dtype),)
    got = kernel(packed, u.to(dtype), *extra).double()
    u64 = u.to(dtype).double()
    imp64 = imp.to(dtype).double()
    ref = twin(packed, u64, *(() if no_na else (imp64,)))
    scale = twin(packed, u64.abs(), *(() if no_na else (imp64.abs(),)))
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    err = (got - ref).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > tol * scale).any()):
        fail(f"{kernel.__name__} p={p} n={n} {dtype}: worst |diff| / "
             f"(|X|^T|u|) {float((err / scale).max()):.3e} > {tol}")
    return float(err.max())


def decoded_f32(packed, n, imp=None, block=2048):
    """The (p, n) float32 matrix the packed bytes stand for (the twin's
    decode, block by block): the product the packed design replaces."""
    import torch

    from adelie_tpu_torch.matrix import snp_kernels as sk

    p = packed.shape[0]
    Xd = torch.empty((p, n), dtype=torch.float32, device=DEV)
    for s in range(0, p, block):
        blk = sk.unpack_cols(packed[s:s + block], n, torch.float32)
        if imp is not None:
            blk = torch.where(blk == 3, imp[None, s:s + block], blk)
        Xd[s:s + block] = blk.T
    return Xd


def snp_exact_case(kernel, twin, p, n, no_na, seed):
    """Integer u in {-2..2} and impute in {0, 1, 2} at (p, n), float32:
    every partial sum is an integer below 2^24, so kernel and twin agree
    bit for bit in any order.  Returns the kernel's time on these bytes
    (all four codes for K3: a quarter of the lanes are NA)."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    nb = (n + 3) // 4
    packed = card_bytes(p, nb, gen, code_lut(True) if no_na else None)
    u = torch.randint(-2, 3, (n,), device=DEV, generator=gen).float()
    imp = torch.randint(0, 3, (p,), device=DEV, generator=gen).float()
    extra = () if no_na else (imp,)
    got, ref = kernel(packed, u, *extra), twin(packed, u, *extra)
    if not torch.equal(got, ref):
        bad = int((got != ref).sum())
        fail(f"{kernel.__name__} p={p} n={n} integer inputs: {bad} rows "
             "differ from the twin")
    return cuda_ms(lambda: kernel(packed, u, *extra), reps=10)


def snp_timing(kernel, twin, packed, n, imp, seed):
    """The kernel's, the twin's and a cuBLAS gemv's time on ``packed`` (a
    main path's matrix) with a random float32 u; the gemv multiplies the
    decoded float32 matrix, the product the packed design replaces."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    u = torch.randn(n, device=DEV, generator=gen)
    extra = () if imp is None else (imp,)
    ms = cuda_ms(lambda: kernel(packed, u, *extra), reps=10)
    plain_ms = cuda_ms(lambda: twin(packed, u, *extra), reps=3)
    note = ""
    try:
        Xd = decoded_f32(packed, n, imp)
    except torch.cuda.OutOfMemoryError:
        rows = packed.shape[0] // 2
        note = f" (gemv timed at p={rows}: the decoded matrix did not fit)"
        torch.cuda.empty_cache()
        Xd = decoded_f32(packed[:rows], n, None if imp is None else imp[:rows])
    library_ms = cuda_ms(lambda: torch.mv(Xd, u), reps=10)
    del Xd
    torch.cuda.empty_cache()
    b_ms, b_by = snp_bound(packed.shape[0], n, imp is not None)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, note=note,
                bound_ms=b_ms, bound_by=b_by)


# K3 and K4 before their redesign (four decodes a byte, an fma a code):
# 1.875 ms on the GWAS matrix and 0.263 ms on the phased one, float32
# (NVIDIA H100 80GB HBM3, 700.00 W; the earlier chip_smoke.py, phases 9
# and 10)
SNP_OLD_MS = {"snp_mul": 1.875, "snp_mul_no_na": 0.263}


def timing_line(r, name):
    return (f"kernel {r['ms']:.3f} ms (before: {SNP_OLD_MS[name]:.3f}), "
            f"twin {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), cuBLAS gemv on the "
            f"decoded f32 matrix {r['library_ms']:.3f} ms{r['note']}")


# --------------------------------------------------------------------------- #
# phases 9 to 11: the SNP paths                                               #
# --------------------------------------------------------------------------- #


class PackedIO:
    """An in-memory SNP handler, as bench.py's GWAS problem builds one."""

    def __init__(self, packed, n):
        import numpy as np

        self.packed = packed
        self.impute = np.zeros(packed.shape[0])
        self._n = n

    def rows(self):
        return self._n

    def snps(self):
        return self.packed.shape[0]

    cols = snps


def snp_problem(p, n, k, seed, lut, block=10_000):
    """bench.py:556-604's problem: packed bytes drawn as uint8 in blocks
    through ``lut``, ``y`` from ``k`` decoded causal columns plus noise
    0.5, float32."""
    import numpy as np

    from adelie_tpu_torch.matrix._snp import unpack_2bit_np

    rng = np.random.default_rng(seed)
    nb = (n + 3) // 4
    packed = np.empty((p, nb), np.uint8)
    for s in range(0, p, block):
        e = min(s + block, p)
        packed[s:e] = lut[rng.integers(0, 256, size=(e - s, nb),
                                       dtype=np.uint8)]
    sig = rng.choice(p, k, replace=False)
    cols = unpack_2bit_np(packed[sig], n).astype(np.float32)
    beta = rng.standard_normal(k).astype(np.float32)
    y = cols.T @ beta + 0.5 * rng.standard_normal(n).astype(np.float32)
    return PackedIO(packed, n), y


def snp_kkt_check(what, Xm, y, state, block=2048):
    """Per lambda, in float64 on the card, with the intercept: the
    gradient g = X^T W (y - X beta - beta_0), W = 1/n, over column blocks
    decoded by ``gather`` (never K3).  Over zero coefficients
    max |g_j| - lambda, over nonzeros |g_j - lambda sign(beta_j)|, both
    <= 1e-2 lambda."""
    import torch

    G, Bfull, lm = snp_grad(Xm, y, state, block)
    nz = Bfull != 0
    g = G.T                                                         # (L, p)
    v0 = torch.where(nz, 0.0, g.abs()).amax(dim=1) - lm
    v1 = torch.where(nz, (g - lm[:, None] * Bfull.sign()).abs(),
                     0.0).amax(dim=1)
    worst = float((torch.maximum(v0, v1) / lm).max())
    if not worst <= 1e-2:
        fail(f"{what}: KKT violation {worst:.3e} lambda")
    return worst


def snp_grad(Xm, y, state, block=2048):
    """``snp_kkt_check``'s gradients G (p, L) = X^T W (y - X beta -
    beta_0), coefficients (L, p) and lambdas, float64 on the card."""
    import numpy as np
    import torch

    n, p = Xm.shape
    act = np.unique(state.betas.tocsr().indices)
    Ba = torch.as_tensor(state.betas.tocsc()[:, act].toarray(),
                         dtype=torch.float64, device=DEV)           # (L, k)
    y64 = torch.as_tensor(np.asarray(y, np.float64), device=DEV)
    b0 = torch.as_tensor(np.asarray(state.intercepts, np.float64),
                         device=DEV)
    Xa = Xm.gather(torch.as_tensor(act, device=DEV)).double()      # (n, k)
    R = (y64[:, None] - Xa @ Ba.T - b0[None, :]) / n                # (n, L)
    G = torch.empty((p, R.shape[1]), dtype=torch.float64, device=DEV)
    for s in range(0, p, block):
        idx = torch.arange(s, min(s + block, p), device=DEV)
        G[s:s + block] = Xm.gather(idx).double().T @ R
    lm = torch.as_tensor(np.asarray(state.lmdas), device=DEV)
    Bfull = torch.zeros((len(lm), p), dtype=torch.float64, device=DEV)
    Bfull[:, torch.as_tensor(act, device=DEV)] = Ba
    return G, Bfull, lm


def profile_fit(ad, Xm, y, **kw):
    """One more fit under ``torch.profiler``: (wall s, device busy ms,
    {kernel: (launches, device ms)}), busiest first.  The profiler has not
    been tried on every machine, so a failure of its own (starting,
    stopping, reading its table) is reported as ``None`` and the phase goes
    on: it measures, it checks nothing.  The fit runs outside those guards,
    so a fault of the port fails the phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def failed(exc):
        print(f"profiler: {type(exc).__name__}: {exc}", flush=True)

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except (RuntimeError, AttributeError) as exc:
        return failed(exc)
    try:
        wall, _ = fit(ad, Xm, y, **kw)
    finally:
        try:
            prof.stop()
        except (RuntimeError, AttributeError) as exc:
            failed(exc)
            prof = None
    if prof is None:
        return None
    try:
        kernels = {e.key: (e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA}
    except (RuntimeError, AttributeError) as exc:
        return failed(exc)
    kernels = dict(sorted(kernels.items(), key=lambda kv: -kv[1][1]))
    return wall, sum(ms for _, ms in kernels.values()), kernels


def profile_line(prof):
    """The profiled fit's wall, its kernels' busy time and idle share (no
    kernel running; copies, which overlap kernels on the streamed path,
    are summed apart) and its four busiest kernels."""
    if prof is None or prof[1] <= 0:
        return "profiled fit: device time not measured"
    wall, _, events = prof
    copies = {k: v for k, v in events.items() if k.startswith("Mem")}
    kernels = {k: v for k, v in events.items() if k not in copies}
    busy = sum(ms for _, ms in kernels.values())
    copy_ms = sum(ms for _, ms in copies.values())
    top = "; ".join(f"{name[:48]} x{c} {ms:.1f} ms"
                    for name, (c, ms) in list(kernels.items())[:4])
    return (f"profiled fit: wall {wall:.3f} s, kernels busy {busy:.1f} ms, "
            f"idle share {1 - busy / (wall * 1e3):.3f}, copies "
            f"{copy_ms:.1f} ms; {top}")


def zero_counts(*counters):
    for c in counters:
        for key in c:
            c[key] = 0


# --------------------------------------------------------------------------- #
# phases 12 to 14: K5 and the host-streamed path                              #
# --------------------------------------------------------------------------- #

NS_N, NS_P, NS_TILE = 100_000, 1_000_000, 65_536
NS_POOL = 1 << 28


def many_bound(T, n, C):
    """K5 in float32: the packed tile, U, impute and the output once;
    2 T n C operations."""
    nb = (n + 3) // 4
    return bound(T * nb + 4 * C * n + 4 * T + 4 * T * C, 2 * T * n * C)


def many_float_case(p, n, C, dtype, seed):
    """K5 in ``dtype`` against its twin in float64, as snp_float_case:
    |got - ref| <= tol (|X|^T |U_c|)_j, tol 1e-4 (f32) and 1e-12 (f64)."""
    import torch

    from adelie_tpu_torch.matrix import snp_kernels as sk

    gen = torch.Generator(device=DEV).manual_seed(seed)
    nb = (n + 3) // 4
    packed = card_bytes(p + 1, nb, gen)[1:]
    U = torch.randn((C, n), dtype=torch.float64, device=DEV, generator=gen)
    imp = 2 * torch.rand(p, dtype=torch.float64, device=DEV, generator=gen)
    got = sk.snp_mul_many(packed, U.to(dtype), imp.to(dtype)).double()
    U64, imp64 = U.to(dtype).double(), imp.to(dtype).double()
    ref = sk.snp_mul_many_ref(packed, U64, imp64)
    scale = sk.snp_mul_many_ref(packed, U64.abs(), imp64.abs())
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    err = (got - ref).abs()
    if tuple(got.shape) != (p, C) or not bool(torch.isfinite(got).all()) \
            or bool((err > tol * scale).any()):
        fail(f"K5 p={p} n={n} C={C} {dtype}: worst |diff| / (|X|^T|U|) "
             f"{float((err / scale).max()):.3e} > {tol}")
    return float(err.max())


def int_inputs(p, n, C, gen):
    """Uniform bytes (all four codes, a quarter of them NA), U in {-2..2}
    and impute in {0, 1, 2}: every partial sum of a product is an integer
    below 2^24 while n <= 2.7e6, so any order of the sums is exact."""
    import torch

    packed = card_bytes(p, (n + 3) // 4, gen)
    U = torch.randint(-2, 3, (C, n), device=DEV, generator=gen).float()
    imp = torch.randint(0, 3, (p,), device=DEV, generator=gen).float()
    return packed, U, imp


def many_exact_tile(T, n, Cs, seed):
    """K5 bit-equal to its twin on integer inputs at one tile, for each C
    in ``Cs`` (the first ``C`` rows of one integer U)."""
    import torch

    from adelie_tpu_torch.matrix import snp_kernels as sk

    gen = torch.Generator(device=DEV).manual_seed(seed)
    packed, U, imp = int_inputs(T, n, max(Cs), gen)
    for C in Cs:
        got, ref = sk.snp_mul_many(packed, U[:C], imp), sk.snp_mul_many_ref(
            packed, U[:C], imp)
        if not torch.equal(got, ref):
            fail(f"K5 T={T} n={n} C={C} integer inputs: "
                 f"{int((got != ref).sum())} entries differ from the twin")


def stream_exact_case(ad, n, Cs, seed):
    """The streamed ``mul_many`` over four tiles of different bytes (the
    last ragged), for each C in ``Cs``, bit-equal to the twin on each
    tile: a tile buffer rewritten before its kernel ran would show here."""
    import numpy as np
    import torch

    from adelie_tpu_torch.matrix import snp_kernels as sk

    gen = torch.Generator(device=DEV).manual_seed(seed)
    p = 3 * NS_TILE + 4321
    packed, U, imp = int_inputs(p, n, max(Cs), gen)
    io = PackedIO(packed.cpu().numpy(), n)
    io.impute = imp.cpu().numpy()
    Xm = ad.matrix.snp_unphased(io, streaming=True, dtype=np.float32,
                                device=DEV)
    before = sk.launches["snp_mul_many"]
    for C in Cs:
        ref = torch.cat([sk.snp_mul_many_ref(packed[s:s + NS_TILE], U[:C],
                                             imp[s:s + NS_TILE])
                         for s in range(0, p, NS_TILE)])
        got = Xm.mul_many(U[:C])
        if not torch.equal(got, ref):
            fail(f"streamed mul_many, {Xm._ntiles} tiles, C={C}: "
                 f"{int((got != ref).sum())} entries differ from the twin")
    if DEV == "cuda" and \
            sk.launches["snp_mul_many"] - before != len(Cs) * Xm._ntiles:
        fail("streamed mul_many did not launch K5 once a tile")
    return p, Xm._ntiles


def meminfo():
    """(MemTotal, MemAvailable) of the host in bytes."""
    vals = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, rest = line.split(":", 1)
            vals[key] = int(rest.split()[0]) * 1024
    return vals["MemTotal"], vals["MemAvailable"]


def north_star_panel(P, N, seed=11):
    """benchmark/north_star_data.py's panel and response, in memory: a
    256 MB pool of LUT-mapped bytes (bench.py's 86/10/4 % dosage mix),
    each SNP row a random window into it, and y from 60 causal SNPs plus
    noise at 0.5 std.  Returns (io, y, causal)."""
    import numpy as np

    from adelie_tpu_torch.matrix._snp import unpack_2bit_np

    nb = (N + 3) // 4
    lut = code_lut(False)
    rng = np.random.default_rng(seed)
    pool = np.empty(NS_POOL, np.uint8)
    slab = min(1 << 25, NS_POOL)
    for s0 in range(0, NS_POOL, slab):
        pool[s0:s0 + slab] = lut[rng.integers(0, 256, size=slab,
                                              dtype=np.uint8)]
    offsets = rng.integers(0, NS_POOL - nb, size=P, dtype=np.int64)
    # row by row, as north_star_data.py does (np.take of a sliding-window
    # view of the pool would first copy the whole view: hundreds of GB)
    packed = np.empty((P, nb), np.uint8)
    for i, o in enumerate(offsets.tolist()):
        packed[i] = pool[o:o + nb]
    del pool
    rng = np.random.default_rng(seed + 1)
    causal = np.sort(rng.choice(P, 60, replace=False))
    cols = unpack_2bit_np(packed[causal], N).astype(np.float32)
    beta = rng.standard_normal(60).astype(np.float32)
    g = cols.T @ beta
    y = g + np.float32(0.5 * g.std()) * \
        rng.standard_normal(N).astype(np.float32)
    io = PackedIO(packed, N)
    io.impute = np.zeros(P, np.float32)
    return io, y, causal


def stream_kkt_check(what, io, y, state, block=2048, tile=NS_TILE):
    """As snp_kkt_check, for a host-streamed fit, from the io's own arrays
    and nothing of the streamed matrix: every lambda's residual in one
    (n, L) float64 block, and one more pass over the panel, a tile at a
    time by a plain synchronous copy, that decodes with plain torch code
    and multiplies with torch.matmul in float64, never K5."""
    import numpy as np
    import torch

    from adelie_tpu_torch.matrix import snp_kernels as sk

    n, p = io.rows(), io.snps()
    imp = torch.as_tensor(np.asarray(io.impute, np.float64), device=DEV)

    def decode(rows, imp_rows):
        blk = sk.unpack_cols(rows, n, torch.float64)
        return torch.where(blk == 3, imp_rows[None, :], blk)

    act = np.unique(state.betas.tocsr().indices)
    Ba = torch.as_tensor(state.betas.tocsc()[:, act].toarray(),
                         dtype=torch.float64, device=DEV)
    y64 = torch.as_tensor(np.asarray(y, np.float64), device=DEV)
    b0 = torch.as_tensor(np.asarray(state.intercepts, np.float64),
                         device=DEV)
    Xa = decode(torch.from_numpy(io.packed[act]).to(DEV),
                imp[torch.as_tensor(act, device=DEV)])
    R = (y64[:, None] - Xa @ Ba.T - b0[None, :]) / n
    del Xa
    G = torch.empty((p, R.shape[1]), dtype=torch.float64, device=DEV)
    for s in range(0, p, tile):
        e = min(s + tile, p)
        rows = torch.from_numpy(io.packed[s:e]).to(DEV)
        for a in range(s, e, block):
            b = min(a + block, e)
            G[a:b] = decode(rows[a - s:b - s], imp[a:b]).T @ R
        del rows
    lm = torch.as_tensor(np.asarray(state.lmdas), device=DEV)
    Bfull = torch.zeros((len(lm), p), dtype=torch.float64, device=DEV)
    Bfull[:, torch.as_tensor(act, device=DEV)] = Ba
    nz = Bfull != 0
    g = G.T
    v0 = torch.where(nz, 0.0, g.abs()).amax(dim=1) - lm
    v1 = torch.where(nz, (g - lm[:, None] * Bfull.sign()).abs(),
                     0.0).amax(dim=1)
    worst = float((torch.maximum(v0, v1) / lm).max())
    if not worst <= 1e-2:
        fail(f"{what}: KKT violation {worst:.3e} lambda")
    return worst


def many_timing(tile, n, Cs, imp, seed):
    """For each C in ``Cs``: K5's, its twin's and torch.matmul's time on one
    device tile, and the time to build K5's operand (once a streamed
    pass; K5 is timed on it, as the pass launches it).  The matmul
    multiplies the decoded float32 tile, decoded once and cut to half its
    rows (and said so) if it does not fit."""
    import torch

    from adelie_tpu_torch.matrix import snp_kernels as sk

    gen = torch.Generator(device=DEV).manual_seed(seed)
    U = torch.randn((max(Cs), n), device=DEV, generator=gen)
    res = {}
    for C in Cs:
        Uc = U[:C]
        op_ms = cuda_ms(lambda: sk.many_operand(Uc, tile.shape[1]), reps=5)
        op = sk.many_operand(Uc, tile.shape[1])
        ms = cuda_ms(lambda: sk.snp_mul_many(tile, Uc, imp, operand=op),
                     reps=5)
        plain_ms = cuda_ms(lambda: sk.snp_mul_many_ref(tile, Uc, imp),
                           reps=1)
        b_ms, b_by = many_bound(tile.shape[0], n, C)
        res[C] = dict(ms=ms, plain_ms=plain_ms, operand_ms=op_ms,
                      bound_ms=b_ms, bound_by=b_by)
        del op
    T = tile.shape[0]
    note = ""
    try:
        Xd = decoded_f32(tile, n, imp)
    except torch.cuda.OutOfMemoryError:
        T //= 2
        note = (f" (torch.matmul timed at {T} x {n}: the decoded tile did "
                "not fit)")
        torch.cuda.empty_cache()
        Xd = decoded_f32(tile[:T], n, imp[:T])
    for C in Cs:
        Ut = U[:C].T.contiguous()
        res[C]["library_ms"] = cuda_ms(lambda: torch.matmul(Xd, Ut), reps=5)
        res[C]["note"] = note
    del Xd
    torch.cuda.empty_cache()
    return res


def many_cross_c(T, n, Cs, seed):
    """Float inputs at one tile (uniform bytes, a quarter of the codes NA;
    normal U, uniform impute): column c of ``snp_mul_many(tile, U[:C])``
    has the same bits at every C in ``Cs``, the property the streamed
    driver's tie at ``lmda_max`` relies on."""
    import torch

    from adelie_tpu_torch.matrix import snp_kernels as sk

    gen = torch.Generator(device=DEV).manual_seed(seed)
    packed = card_bytes(T, (n + 3) // 4, gen)
    U = torch.randn((max(Cs), n), device=DEV, generator=gen)
    imp = 2 * torch.rand(T, device=DEV, generator=gen)
    outs = {C: sk.snp_mul_many(packed, U[:C], imp).view(torch.int32)
            for C in Cs}
    for a in Cs:
        for b in Cs:
            if a < b and not torch.equal(outs[a], outs[b][:, :a]):
                bad = int((outs[a] != outs[b][:, :a]).sum())
                fail(f"K5 T={T} n={n}: {bad} entries of the first {a} "
                     f"columns differ between C={a} and C={b}")


def chunk_pass_line(prof, passes):
    """From the profiled north-star fit: each K5 variant's launches and
    device time (the chunk pass's C takes its own variant, the set-up and
    dry fits' C <= 2 another), beside one pass's share of the tile copies'
    device time."""
    if prof is None or prof[1] <= 0:
        return "chunk pass against the copies: device time not measured"
    events = prof[2]
    k5 = "; ".join(f"{k[k.index('snp_mul_many'):].split('(')[0]} x{c} "
                   f"{ms:.1f} ms"
                   for k, (c, ms) in events.items() if "snp_mul_many" in k)
    copies = sum(ms for k, (_, ms) in events.items()
                 if k.startswith("Memcpy HtoD"))
    return (f"K5 by variant in the profiled fit: {k5}; tile copies "
            f"{copies:.1f} ms (H2D) over {passes} passes, "
            f"{copies / max(passes, 1):.1f} ms a pass")


def main():
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        fail(f"cannot import numpy/torch: {exc}")
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 1
    try:
        import adelie_tpu_torch as ad
        from adelie_tpu_torch import _build
        from adelie_tpu_torch.solver import pin_kernels as tk
    except ImportError as exc:
        print(f"adelie_tpu_torch is not importable here: {exc}",
              file=sys.stderr)
        return 1
    if "jax" in sys.modules or "adelie_tpu" in sys.modules:
        fail("jax was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    phase("device", f"{card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {count} device(s)")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    phase("build", f"{build_s:.1f} s, nvcc {_build.build_seconds:.1f} s; "
          + " / ".join(regs))

    # 3. K1 against its twin: the whole solve, bit-equal
    k1 = []
    for dtype in (torch.float32, torch.float64):
        for S in (64, 1000, 1024):
            k1.append(k1_case(S, dtype, seed=S))
    # warm starts: an active list K1 keeps resident (32 rows of the 49 it
    # holds at S = 1024 in float32) and one it streams (32 of 22 in
    # float64)
    for dtype in (torch.float32, torch.float64):
        k1.append(k1_case(1024, dtype, seed=7, case=("warm", 0.04)))
    for r in k1:
        old = K1_OLD_MS.get((r["S"], r["dtype"])) if r["case"] == "cold" \
            else None
        phase("K1", f"S={r['S']} {r['dtype']} {r['case']}: bit-equal to the "
              f"twin; iters {r['iters']}, active {r['active0']} at entry "
              f"(K1 keeps {r['resident']} rows resident), {r['n_active']} at "
              f"exit, updates {r['listed']} (moved {r['moved']}); kernel "
              f"{r['ms']:.3f} ms = {r['us_per_update']:.3f} us an update"
              + (f" (before: {old:.3f} ms = {old * 1e3 / r['listed']:.3f} "
                 "us an update)" if old else "")
              + f"; twin {r['plain_ms']:.1f} ms | {card}")
    warm = [r for r in k1 if r["case"] != "cold"]
    if not (warm[0]["active0"] <= warm[0]["resident"]
            and warm[1]["active0"] > warm[1]["resident"]):
        fail(f"K1 warm starts: active lists {warm[0]['active0']} and "
             f"{warm[1]['active0']} against {warm[0]['resident']} and "
             f"{warm[1]['resident']} resident rows: not one of each mode")
    for S in (128, 1024):
        r = k1_case(S, torch.float32, seed=S + 1, case=("floor", 0.03))
        phase("K1", f"floor S={S} float32: {r['listed']} updates ("
              f"{r['active0']} active, then the valid list; K1 keeps "
              f"{r['resident']} rows resident), every delta 0 (zero "
              f"denominators: no AXPY), bit-equal to the twin; "
              f"{r['ms']:.3f} ms = {r['us_per_update']:.3f} us an update: "
              f"the chain's barrier, broadcast and rows | {card}")
    for cap_min in (6, 10):
        caps, n_k1 = odd_cap_case(ad, tk, cap_min)
        phase("K1", f"screen_cap_min {cap_min}, f64 BASIL fit n=120 p=40: "
              f"screen capacities {caps}, {n_k1} K1 launches, the same path "
              f"as the default capacity's | {card}")
    torch.cuda.empty_cache()

    # 4. K2 against its twin: the whole solve, bit-equal
    k2 = []
    for dtype in (torch.float32, torch.float64):
        for S in (2048, 8192):
            for case in ("cold", "warm"):
                k2.append(k2_case(S, dtype, seed=S, case=case))
        k2.append(k2_case(2048, dtype, seed=3, case="holes"))
    # rows of 128 KB and more: the ring streams them in segments (two at
    # S = 16384 f64 and 32768 f32, three at 65536 f32), and the list lives
    # in global memory; S = 65536 is the screen capacity of a 32,769 to
    # 65,536 screen, a 16 GB float32 Gram
    k2.append(k2_case(16384, torch.float64, seed=5, case="cold"))
    for S in (32768, 65536):
        k2.append(k2_case(S, torch.float32, seed=S, case="cold"))
        del k2[-1]["args"], k2[-1]["out"]
        torch.cuda.empty_cache()
    for r in k2:
        phase("K2", f"S={r['S']} {r['dtype']} {r['case']}: bit-equal to the "
              f"twin; iters {r['iters']} active {r['n_active']} updates "
              f"{r['listed']} (moved {r['moved']}, rows {r['rows']}); kernel "
              f"{r['ms']:.3f} ms = {r['us_per_update']:.3f} us an update "
              f"(before: one launch a sweep, {K2_OLD_US_PER_UPDATE:.3f} us an "
              f"update at S=2048 f32); twin {r['plain_ms']:.1f} ms | {card}")
    k2_floor = {}
    for S in (2048, 8192):
        r = k2_case(S, torch.float32, seed=S + 1, case="floor")
        k2_floor[S] = r["us_per_update"]
        phase("K2", f"floor S={S} float32: {r['listed']} listed updates, "
              f"every delta 0 (zero denominators: no AXPY), bit-equal to the "
              f"twin; {r['ms']:.3f} ms = {r['us_per_update']:.3f} us an "
              f"update: the chain's barrier, broadcast and row ring | {card}")
    for r in k2:
        r.pop("args", None), r.pop("out", None)
    torch.cuda.empty_cache()

    # 4b. K6 against its twin: the whole grouped solve
    from adelie_tpu_torch.solver import pin_group_kernels as pg

    k6, _ = k6_phase(card)
    torch.cuda.empty_cache()

    # 5. the headline fit (warm-up, then the timed main-path fit)
    X, y = headline_problem(40000, 2000, 60, seed=0)
    Xm = ad.matrix.dense(X, device="cuda")
    kw = dict(lmda_path_size=100, min_ratio=1e-2, intercept=False,
              early_exit=False, device="cuda")
    warm_s, _ = fit(ad, Xm, y, **kw)
    torch.cuda.reset_peak_memory_stats()
    for key in tk.launches:
        tk.launches[key] = 0
    wall_s, state = fit(ad, Xm, y, **kw)
    counts_5 = dict(tk.launches)
    if state.error != "" or len(state.lmdas) != 100:
        fail(f"headline fit: error {state.error!r}, {len(state.lmdas)} "
             "lambdas")
    kkt5 = kkt_check("headline fit", X, y, state)
    peak_S = int(max(state.screen_sizes))
    phase("headline", f"n=40000 p=2000 f32 100 lambdas: wall {wall_s:.3f} s "
          f"(warm-up {warm_s:.3f} s), peak screen {peak_S}, launches "
          f"{counts_5}, worst KKT {kkt5:.2e} lambda, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts_5["pin_lasso_solve"] <= 0:
        fail("headline fit launched K1 no time")
    prof5 = profile_fit(ad, Xm, y, **kw)
    k1_prof = [] if prof5 is None else [
        v for name, v in prof5[2].items() if "pin_lasso_solve_kernel" in name]
    k1_line = "K1 device time not measured"
    if k1_prof:
        k1_n, k1_dev = map(sum, zip(*k1_prof))
        k1_line = (f"K1 device time {k1_dev:.1f} ms in {k1_n} launches, "
                   f"{k1_dev / k1_n:.3f} ms a launch")
    phase("headline", f"{profile_line(prof5)}; {k1_line} | {card}")

    # 5b. the grouped headline: phase 5's problem in 500 groups of 4, K6
    # for every pin solve (warm-up, five timed fits, one profiled)
    groups5 = np.arange(0, 2000, 4)
    kw5g = dict(kw, groups=groups5)
    # the warm-up fit's K6 calls: their bound, and a sample of those with
    # root finds at newton_max_iters replayed with full walks on the host
    (warm5g, _), calls5g, held5g = k6_kept(lambda: fit(ad, Xm, y, **kw5g))
    torch.cuda.reset_peak_memory_stats()
    zero_counts(tk.launches, pg.launches)
    pg.reset_newton()
    wall, st5g = fit(ad, Xm, y, **kw5g)
    counts5g = {**tk.launches, **pg.launches}
    newton5g = {k: (list(v) if isinstance(v, list) else v)
                for k, v in pg.newton.items()}
    peak5g = torch.cuda.max_memory_allocated() / 2**30
    walls5g = [wall]
    for i in range(4):
        wall, st = fit(ad, Xm, y, **kw5g)
        walls5g.append(wall)
        if i == 0:
            st5g_b = st
    if st5g.error != "" or len(st5g.lmdas) != 100:
        fail(f"grouped headline: error {st5g.error!r}, {len(st5g.lmdas)} "
             "lambdas")
    # a screen with no group (the first dry fit's) has qmax 1 and runs K1,
    # as the JAX package's q = 1 path; every other solve is K6's
    caps5g = st5g.benchmark["pin_caps"]
    if (counts5g["pin_group_solve"] <= 0 or counts5g["pin_lasso_solve_rows"]
            or counts5g["pin_group_solve"] + counts5g["pin_lasso_solve"]
            != len(caps5g)):
        fail(f"grouped headline: launches {counts5g} for {len(caps5g)} pin "
             "solves: one K6 or K1 launch a solve, K6 at least once")
    same5g = (np.array_equal(st5g.lmdas, st5g_b.lmdas)
              and np.array_equal(st5g.betas.toarray(),
                                 st5g_b.betas.toarray()))
    if not same5g:
        fail("grouped headline: two timed fits differ (beta or lambdas)")
    G5, B5 = dense_grad(X, y, st5g)
    kkt5g = group_kkt_check("grouped headline", G5, B5, st5g.lmdas, groups5,
                            np.full(500, 4), np.full(500, 2.0), 1.0)
    del G5, B5
    phase("headline-grouped", f"n=40000 p=2000 f32 500 groups of 4, 100 "
          f"lambdas: wall median {np.median(walls5g):.3f} s of five "
          f"({min(walls5g):.3f}-{max(walls5g):.3f}; warm-up {warm5g:.3f} s),"
          f" two timed fits bit-equal, peak screen "
          f"{int(max(st5g.screen_sizes))} groups, pin solves' S in "
          f"[{min(caps5g)}, {max(caps5g)}], launches {counts5g}, worst "
          f"group KKT {kkt5g:.2e} lambda (float64), peak memory "
          f"{peak5g:.2f} GiB | {card}")
    phase("headline-grouped", f"{newton_line(newton5g)} | {card}")
    if not (newton5g["steps_run"] <= newton5g["iters"]
            and newton5g["cycle_exits"] <= newton5g["hist"][-1]):
        fail(f"grouped headline: Newton counts {newton5g}")
    n_rep, capped_rep, exits_rep, walks5g = k6_replay_full(
        "grouped headline", held5g)
    k6_cell5g = k6_cell_bound(calls5g)
    phase("headline-grouped", f"full walks: {n_rep} K6 calls of the warm-up "
          f"fit (S {[c[0][0].shape[0] for c in held5g]}) with {capped_rep} "
          f"finds at newton_max_iters ({exits_rep} ended by the cycle rule) "
          f"replayed on the host with no exit: beta, grad, active flags, "
          f"Newton steps and histogram equal the kernel's; "
          f"{walks_line(walks5g)}; K6 bound over the fit's "
          f"{len(calls5g)} calls {k6_cell5g[0]:.4f} ms ({k6_cell5g[1]}) | "
          f"{card}")
    del held5g
    prof5g = profile_fit(ad, Xm, y, **kw5g)
    k6_prof = [] if prof5g is None else [
        v for name, v in prof5g[2].items() if "pin_group_solve_kernel" in name]
    k6_line = "K6 device time not measured"
    if k6_prof:
        k6_n, k6_dev = map(sum, zip(*k6_prof))
        k6_line = (f"K6 device time {k6_dev:.1f} ms in {k6_n} launches, "
                   f"{k6_dev / k6_n:.3f} ms a launch, "
                   f"{k6_dev * 1e3 / max(newton5g['updates'], 1):.3f} us a "
                   "group update")
    phase("headline-grouped", f"{profile_line(prof5g)}; {k6_line} | {card}")
    # a state holds its screen block on the card
    del Xm, st, st5g, st5g_b

    # 6. a screen set past 1024: K2 carries the pin solves (warm-up, the
    # timed main-path fit, one profiled fit)
    X6, y6, kw6 = big_s_problem()
    Xm6 = ad.matrix.dense(X6, device="cuda")
    (warm6, _), calls6 = k2_kept(lambda: fit(ad, Xm6, y6, **kw6))
    t0 = time.perf_counter()
    n6 = k2_replay("big-S warm-up fit", calls6)
    phase("big-S", f"warm-up fit: each of its {n6} K2 solves (S in "
          f"{sorted({c[0][0].shape[0] for c in calls6})}) bit-equal to the "
          f"twin on the CPU on copies of its inputs "
          f"({time.perf_counter() - t0:.1f} s)")
    del calls6
    zero_counts(tk.launches)
    wall6, state6 = fit(ad, Xm6, y6, **kw6)
    counts_6 = dict(tk.launches)
    if state6.error != "" or len(state6.lmdas) != 40:
        fail(f"S > 1024 fit: error {state6.error!r}")
    kkt6 = kkt_check("S > 1024 fit", X6, y6, state6)
    peak6 = int(max(state6.screen_sizes))
    solves6 = sum(c > tk.MAX_PALLAS_S for c in state6.benchmark["pin_caps"])
    phase("big-S", f"n=4000 p=2500 f32 40 lambdas: wall {wall6:.3f} s "
          f"(warm-up {warm6:.3f} s), peak screen {peak6}, pin solves past "
          f"{tk.MAX_PALLAS_S} {solves6}, launches {counts_6}, worst KKT "
          f"{kkt6:.2e} lambda, host stopwatch: fits "
          f"{sum(state6.benchmark['fit_screen']):.3f} s, screens "
          f"{sum(state6.benchmark['screen']):.3f} s | {card}")
    if peak6 <= tk.MAX_PALLAS_S or counts_6["pin_lasso_solve_rows"] <= 0:
        fail("the S > 1024 fit did not go through K2")
    if counts_6["pin_lasso_solve_rows"] != solves6:
        fail(f"K2 launched {counts_6['pin_lasso_solve_rows']} times for "
             f"{solves6} pin solves past {tk.MAX_PALLAS_S}: not one a solve")
    if hasattr(_build.load(), "adelie_cd_sweep_rows_f32"):
        fail("the per-sweep kernel is still in the library")
    prof6 = profile_fit(ad, Xm6, y6, **kw6)
    phase("big-S", f"{profile_line(prof6)} | {card}")
    if prof6 is not None:
        names = list(prof6[2])
        if any("cd_sweep_rows" in k for k in names) or not any(
                "pin_lasso_solve_rows" in k for k in names):
            fail(f"big-S profile: kernels {names[:8]}")
    del Xm6

    # 7. the card against the port's CPU path, float64
    rng = np.random.default_rng(7)
    X7 = rng.standard_normal((2000, 500))
    y7 = X7[:, :20] @ rng.standard_normal(20) + rng.standard_normal(2000)
    s_gpu = ad.grpnet(X7, ad.glm.gaussian(y7), device="cuda")
    s_cpu = ad.grpnet(X7, ad.glm.gaussian(y7), device="cpu")
    if s_gpu.error or s_cpu.error or len(s_gpu.lmdas) != len(s_cpu.lmdas):
        fail(f"cuda vs cpu: errors {s_gpu.error!r} {s_cpu.error!r}, "
             f"{len(s_gpu.lmdas)} vs {len(s_cpu.lmdas)} lambdas")
    lm_err = float(np.max(np.abs(s_gpu.lmdas / s_cpu.lmdas - 1)))
    b_err = float(np.max(np.abs(s_gpu.betas.toarray()
                                - s_cpu.betas.toarray())))
    phase("cuda-vs-cpu", f"n=2000 p=500 f64: {len(s_gpu.lmdas)} lambdas, "
          f"max lambda rel diff {lm_err:.1e}, max beta diff {b_err:.3e}")
    if lm_err > 1e-10 or b_err > 1e-6:
        fail("the card's fit differs from the CPU path")

    # 7b. past 1024, float64: K2 on the card, its twin on the CPU.  The
    # Grams and gradients come from cuBLAS and from CPU BLAS, and the
    # filtered sweep picks its movers by exact comparisons (ROADMAP.md
    # section 3 item 6), so two fits that each meet tol part where a
    # last-bit difference flips a mover.  The witness that the gap is the
    # inputs' and not the kernel's: every K2 solve of the card's fit, run
    # by the CPU twin on copies of its inputs (the card's Gram and
    # gradient), gives the kernel's bits.  Bars: lambda 1e-10 relative at
    # both tols; beta 1e-4 at the test's tol = 1e-12 (the gap read on the
    # card was 1.14e-5, PERF.md) and phase 7's 1e-6 at tol = 1e-16.
    X7b, y7b, kw7b = big_s_check_problem()
    for tol, beta_bar in ((1e-12, 1e-4), (1e-16, 1e-6)):
        zero_counts(tk.launches)
        s_gpu, calls7b = k2_kept(lambda: ad.grpnet(
            X7b, ad.glm.gaussian(y7b), device="cuda", **kw7b, tol=tol))
        k2_7b = tk.launches["pin_lasso_solve_rows"]
        s_cpu = ad.grpnet(X7b, ad.glm.gaussian(y7b), device="cpu", **kw7b,
                          tol=tol)
        if s_gpu.error or s_cpu.error or len(s_gpu.lmdas) != len(s_cpu.lmdas):
            fail(f"big-S cuda vs cpu at tol {tol}: errors {s_gpu.error!r} "
                 f"{s_cpu.error!r}, {len(s_gpu.lmdas)} vs "
                 f"{len(s_cpu.lmdas)} lambdas")
        solves7b = sum(c > tk.MAX_PALLAS_S
                       for c in s_gpu.benchmark["pin_caps"])
        if k2_7b <= 0 or k2_7b != solves7b:
            fail(f"the big-S cuda fit at tol {tol} launched K2 {k2_7b} "
                 f"times for {solves7b} solves past {tk.MAX_PALLAS_S}")
        n7b = k2_replay(f"big-S cuda fit at tol {tol}", calls7b)
        lm_err = float(np.max(np.abs(s_gpu.lmdas / s_cpu.lmdas - 1)))
        b_err = float(np.max(np.abs(s_gpu.betas.toarray()
                                    - s_cpu.betas.toarray())))
        phase("cuda-vs-cpu", f"n=50 p=1100 strong rule f64 tol {tol:.0e}: "
              f"{len(s_gpu.lmdas)} lambdas, peak screen "
              f"{max(s_gpu.screen_sizes)}, K2 launches {k2_7b} for "
              f"{solves7b} solves past {tk.MAX_PALLAS_S}, each bit-equal to "
              f"the CPU twin on its inputs ({n7b}); max lambda rel diff "
              f"{lm_err:.1e}, max beta diff {b_err:.3e} (bar {beta_bar:.0e})")
        if lm_err > 1e-10 or b_err > beta_bar:
            fail(f"the card's big-S fit at tol {tol} differs from the CPU "
                 "path")

    # 7c. groups of unequal sizes, float64: K6 on the card, its twin on
    # the CPU
    d7 = ad.data.dense(2000, 300, 60, seed=17)
    kw7c = dict(groups=d7["groups"], penalty=d7["penalty"])
    zero_counts(pg.launches)
    s_gpu = ad.grpnet(d7["X"], d7["glm"], device="cuda", **kw7c)
    k6_7c = pg.launches["pin_group_solve"]
    t0 = time.perf_counter()
    s_cpu = ad.grpnet(d7["X"], d7["glm"], device="cpu", **kw7c)
    cpu7c = time.perf_counter() - t0
    if s_gpu.error or s_cpu.error or len(s_gpu.lmdas) != len(s_cpu.lmdas):
        fail(f"grouped cuda vs cpu: errors {s_gpu.error!r} {s_cpu.error!r}, "
             f"{len(s_gpu.lmdas)} vs {len(s_cpu.lmdas)} lambdas")
    lm_err = float(np.max(np.abs(s_gpu.lmdas / s_cpu.lmdas - 1)))
    b_err = float(np.max(np.abs(s_gpu.betas.toarray()
                                - s_cpu.betas.toarray())))
    phase("cuda-vs-cpu", f"data.dense(2000, 300, 60) f64, group sizes "
          f"{int(d7['group_sizes'].min())}-{int(d7['group_sizes'].max())}: "
          f"{len(s_gpu.lmdas)} lambdas, K6 launches {k6_7c}, max lambda rel "
          f"diff {lm_err:.1e}, max beta diff {b_err:.3e} (the CPU twin's fit "
          f"{cpu7c:.1f} s)")
    if k6_7c <= 0 or lm_err > 1e-10 or b_err > 1e-6:
        fail("the card's grouped fit differs from the CPU path")

    # 8. K3 and K4 against their twins
    from adelie_tpu_torch.matrix import snp_kernels as sk

    snp = {"snp_mul": ("K3", sk.snp_mul, sk.snp_mul_ref, False),
           "snp_mul_no_na": ("K4", sk.snp_mul_no_na, sk.snp_mul_no_na_ref,
                             True)}
    float_shapes = ((300, 257), (513, 1000), (513, 4091), (20_000, GWAS_N))
    snp_err = {}
    for name, (label, kern, twin, no_na) in snp.items():
        errs = [snp_float_case(kern, twin, p, n, dtype, no_na, seed=p + n)
                for p, n in float_shapes
                for dtype in (torch.float32, torch.float64)]
        snp_err[name] = max(errs)
        phase(label, f"vs twin in f64, (p, n) in {float_shapes} (nb % 4 = "
              f"{[(n + 3) // 4 % 4 for _, n in float_shapes]}), f32 and f64:"
              f" max |diff| {max(errs):.3e}, within 1e-4 / 1e-12 of "
              "(|X|^T|u|)_j")
    for name, (label, kern, twin, no_na) in snp.items():
        for n in (GWAS_N, GWAS_N + 1):
            ms = snp_exact_case(kern, twin, GWAS_P, n, no_na,
                                seed=n + (8 if no_na else 9))
            phase(label, f"integer inputs at p={GWAS_P} n={n} (nb % 4 = "
                  f"{(n + 3) // 4 % 4}) f32: bit-equal to the twin; kernel "
                  f"{ms:.3f} ms on these bytes | {card}")
    snp_time = {}

    # 9. the GWAS fit (warm-up, then the timed main-path fit)
    t0 = time.perf_counter()
    io9, y9 = snp_problem(GWAS_P, GWAS_N, 40, seed=7, lut=code_lut(False))
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xm9 = ad.matrix.snp_unphased(io9, dtype=np.float32, device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    kw9 = dict(lmda_path_size=50, min_ratio=5e-2, device="cuda")
    warm9, _ = fit(ad, Xm9, y9, **kw9)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(tk.launches, sk.launches)
    wall9, st9 = fit(ad, Xm9, y9, **kw9)
    counts9 = {**tk.launches, **sk.launches}
    devs9 = np.asarray(st9.devs)
    if st9.error != "" or not np.isfinite(devs9).all() or devs9[-1] <= 0.1:
        fail(f"GWAS fit: error {st9.error!r}, devs[-1] {devs9[-1]:.3f}")
    peak9 = torch.cuda.max_memory_allocated() / 2**30
    prof9 = profile_fit(ad, Xm9, y9, **kw9)
    kkt9 = snp_kkt_check("GWAS fit", Xm9, y9, st9)
    L9 = len(st9.lmdas)
    phase("gwas", f"n={GWAS_N} p={GWAS_P} f32 {L9} lambdas: wall "
          f"{wall9:.3f} s (warm-up {warm9:.3f} s; synthesis {synth_s:.1f} s,"
          f" upload {upload_s:.2f} s), peak screen "
          f"{int(max(st9.screen_sizes))}, devs[-1] {devs9[-1]:.4f}, worst "
          f"KKT {kkt9:.2e} lambda, peak memory {peak9:.2f} GiB, launches "
          f"{counts9}, K3 per lambda {counts9['snp_mul'] / L9:.2f} | {card}")
    phase("gwas", f"{profile_line(prof9)} | {card}")
    if counts9["snp_mul"] <= 0:
        fail("the GWAS fit launched K3 no time")
    snp_time["snp_mul"] = snp_timing(sk.snp_mul, sk.snp_mul_ref, Xm9._packed,
                                     GWAS_N, Xm9._impute, seed=90)
    k3_path_ms = counts9["snp_mul"] * snp_time["snp_mul"]["ms"]
    phase("K3", f"on the GWAS matrix, p={GWAS_P} n={GWAS_N} f32: "
          f"{timing_line(snp_time['snp_mul'], 'snp_mul')}; launches x "
          f"kernel ms {k3_path_ms:.1f} ms, "
          f"{k3_path_ms / (wall9 * 1e3):.2f} of the path's wall | {card}")
    # io9, y9 and st9 stay for phase 13
    del Xm9
    torch.cuda.empty_cache()

    # 10. phased ancestry at full width
    p10 = PHASED_S * PHASED_A
    io10, y10 = snp_problem(p10, PHASED_N, 20, seed=10, lut=code_lut(False))
    Xm10 = ad.matrix.snp_phased_ancestry(io10, dtype=np.float32,
                                         device="cuda")
    zero_counts(tk.launches, sk.launches)
    wall10, st10 = fit(ad, Xm10, y10, **kw9)
    counts10 = {**tk.launches, **sk.launches}
    if st10.error != "":
        fail(f"phased fit: error {st10.error!r}")
    prof10 = profile_fit(ad, Xm10, y10, **kw9)
    kkt10 = snp_kkt_check("phased fit", Xm10, y10, st10)
    phase("phased", f"n={PHASED_N} s={PHASED_S} A={PHASED_A} (p={p10}) f32 "
          f"{len(st10.lmdas)} lambdas: wall {wall10:.3f} s, peak screen "
          f"{int(max(st10.screen_sizes))}, worst KKT {kkt10:.2e} lambda, "
          f"launches {counts10} | {card}")
    phase("phased", f"{profile_line(prof10)} | {card}")
    if counts10["snp_mul_no_na"] <= 0:
        fail("the phased fit launched K4 no time")
    snp_time["snp_mul_no_na"] = snp_timing(
        sk.snp_mul_no_na, sk.snp_mul_no_na_ref, Xm10._packed, PHASED_N, None,
        seed=100)
    k4_path_ms = counts10["snp_mul_no_na"] * snp_time["snp_mul_no_na"]["ms"]
    phase("K4", f"on the phased matrix, p={p10} n={PHASED_N} f32: "
          f"{timing_line(snp_time['snp_mul_no_na'], 'snp_mul_no_na')}; "
          f"launches x kernel ms {k4_path_ms:.1f} ms, "
          f"{k4_path_ms / (wall10 * 1e3):.2f} of the path's wall | {card}")

    # 10b. the same panel grouped one SNP a group: its three ancestry
    # columns s A + a in one group, so K4 and K6 carry the fit
    groups10 = PHASED_A * np.arange(PHASED_S)
    kw10g = dict(kw9, groups=groups10)
    (warm10g, _), calls10g, _ = k6_kept(
        lambda: fit(ad, Xm10, y10, **kw10g), keep=0)
    zero_counts(tk.launches, sk.launches, pg.launches)
    pg.reset_newton()
    wall10g, st10g = fit(ad, Xm10, y10, **kw10g)
    counts10g = {**tk.launches, **sk.launches, **pg.launches}
    newton10g = dict(pg.newton)
    if st10g.error != "":
        fail(f"grouped phased fit: error {st10g.error!r}")
    if counts10g["snp_mul_no_na"] <= 0 or counts10g["pin_group_solve"] <= 0:
        fail(f"grouped phased fit: launches {counts10g}; K4 and K6 must "
             "carry it")
    G10, B10, lm10 = snp_grad(Xm10, y10, st10g)
    kkt10g = group_kkt_check("grouped phased fit", G10.T.contiguous(), B10,
                             lm10.cpu().numpy(), groups10,
                             np.full(PHASED_S, PHASED_A),
                             np.full(PHASED_S, np.sqrt(PHASED_A)), 1.0)
    del G10, B10
    phase("phased-grouped", f"n={PHASED_N} {PHASED_S} groups of "
          f"{PHASED_A} (p={p10}) f32 {len(st10g.lmdas)} lambdas: wall "
          f"{wall10g:.3f} s (warm-up {warm10g:.3f} s), peak screen "
          f"{int(max(st10g.screen_sizes))} groups, pin solves' S in "
          f"[{min(st10g.benchmark['pin_caps'])}, "
          f"{max(st10g.benchmark['pin_caps'])}], worst group KKT "
          f"{kkt10g:.2e} lambda (float64), launches {counts10g} | {card}")
    k6_cell10g = k6_cell_bound(calls10g)
    phase("phased-grouped", f"{newton_line(newton10g)}; K6 bound over the "
          f"fit's {len(calls10g)} calls {k6_cell10g[0]:.4f} ms "
          f"({k6_cell10g[1]}) | {card}")
    prof10g = profile_fit(ad, Xm10, y10, **kw10g)
    k6_prof10g = [] if prof10g is None else [
        v for name, v in prof10g[2].items() if "pin_group_solve_kernel" in name]
    k6_line10g = "K6 device time not measured"
    if k6_prof10g:
        k6_n, k6_dev = map(sum, zip(*k6_prof10g))
        k6_line10g = (f"K6 device time {k6_dev:.1f} ms in {k6_n} launches")
    phase("phased-grouped", f"{profile_line(prof10g)}; {k6_line10g} | "
          f"{card}")
    del Xm10, io10, st10g
    torch.cuda.empty_cache()

    # 11. a .snpdat file, fitted on the card and on the CPU, float64
    d11 = ad.data.snp_unphased(2000, 1500, missing_ratio=0.1, seed=11)
    f11 = _build.BUILD_DIR / "chip_smoke_phase11.snpdat"
    f11.parent.mkdir(parents=True, exist_ok=True)
    ad.io.snp_unphased(str(f11)).write(d11["X"])
    io11 = ad.io.snp_unphased(str(f11)).read()
    f11.unlink()
    # tol 1e-12: the screen passes 1024, and at the default tol the
    # filtered full sweep's exact comparisons let last-bit differences of
    # the products pick other movers (tests/test_torch_grpnet.py)
    s11 = {dev: ad.grpnet(ad.matrix.snp_unphased(io11, device=dev),
                          d11["glm"], lmda_path_size=30, tol=1e-12)
           for dev in ("cuda", "cpu")}
    g11, c11 = s11["cuda"], s11["cpu"]
    if g11.error or c11.error or len(g11.lmdas) != len(c11.lmdas):
        fail(f"snpdat cuda vs cpu: errors {g11.error!r} {c11.error!r}, "
             f"{len(g11.lmdas)} vs {len(c11.lmdas)} lambdas")
    lm11 = float(np.max(np.abs(g11.lmdas / c11.lmdas - 1)))
    b11 = float(np.max(np.abs(g11.betas.toarray() - c11.betas.toarray())))
    phase("snpdat", f"n=2000 p=1500 10% NA f64, file written and read by "
          f"adelie_tpu_torch.io: {len(g11.lmdas)} lambdas, max lambda rel "
          f"diff {lm11:.1e}, max beta diff {b11:.3e} (cuda vs cpu)")
    if lm11 > 1e-10 or b11 > 1e-6:
        fail("the card's SNP fit differs from the CPU path")

    # 12. K5 against its twin
    from adelie_tpu_torch.configs import set_configs

    # column variants of 2, 8, 32 and 64 columns, column blocks past 64:
    # C on both sides of each boundary, and the chunk pass's 50 and 100
    many_shapes = ((10, 9, 3), (300, 257, 8), (513, 1000, 1),
                   (513, 4091, 100), (700, 1024, 33), (257, 2000, 200),
                   (1001, 3333, 20), (129, 130, 9), (300, 1001, 2),
                   (300, 1001, 32), (777, 2050, 50), (513, 999, 64),
                   (260, 1503, 65), (129, 4097, 128), (300, 600, 129))
    errs = [many_float_case(p, n, C, dtype, seed=p + n + C)
            for p, n, C in many_shapes
            for dtype in (torch.float32, torch.float64)]
    snp_err["snp_mul_many"] = max(errs)
    phase("K5", f"vs twin in f64, (p, n, C) in {many_shapes} (nb % 4 = "
          f"{[(n + 3) // 4 % 4 for _, n, _ in many_shapes]}, tensors "
          f"starting unaligned), f32 and f64: max |diff| {max(errs):.3e}, "
          "within 1e-4 / 1e-12 of (|X|^T|U_c|)_j")
    # the north-star path runs C = 2 (setup), 1 (dry fits) and the chunk's
    # lambda count (up to 50); the rest sit on both sides of each boundary
    exact_cs = (1, 2, 3, 8, 9, 20, 32, 33, 50, 64, 65, 100, 128, 129)
    many_exact_tile(NS_TILE, NS_N, exact_cs, seed=12)
    phase("K5", f"integer inputs at the north-star tile T={NS_TILE} "
          f"n={NS_N} C in {exact_cs}, all four codes, f32: bit-equal to the "
          "twin")
    cross_cs = (1, 2, 50, 100, 129)
    many_cross_c(NS_TILE, NS_N, cross_cs, seed=14)
    phase("K5", f"float inputs at the north-star tile, C in {cross_cs}: "
          "every column bit-equal across C")
    lib = _build.load()
    cols = [C for C in range(1, 300) if lib.adelie_snp_mul_many_cols(C)
            != -(-C // sk.many_block_cols(C)) * sk.many_block_cols(C)]
    if cols:
        fail(f"K5: the wrapper's and the library's column widths differ at "
             f"C in {cols[:8]}")
    pk12 = card_bytes(300, 250, torch.Generator(device=DEV).manual_seed(3))
    U12 = torch.ones((3, 1000), device=DEV)
    try:
        sk.snp_mul_many(pk12, U12, torch.zeros(300, device=DEV),
                        operand=sk.many_operand(U12, 300))
    except ValueError:
        pass
    else:
        fail("K5 took an operand made for other rows")
    stream_cs = (2, 20, 100)
    p12, tiles12 = stream_exact_case(ad, 20_000, stream_cs, seed=13)
    phase("K5", f"streamed mul_many over {tiles12} tiles (p={p12}, n=20000, "
          f"C in {stream_cs}, integer inputs): bit-equal to the twin on "
          "each tile")
    torch.cuda.empty_cache()

    # 13. the streamed path against the in-device one on the card
    set_configs("stream_speculative_union", False)
    try:
        Xs9 = ad.matrix.snp_unphased(io9, streaming=True, dtype=np.float32,
                                     device="cuda")
        wall13, st13 = fit(ad, Xs9, y9, **kw9)
        s11s = ad.grpnet(ad.matrix.snp_unphased(
            io11, streaming=True, tile_snps=256, dtype=np.float64,
            device="cuda"), d11["glm"], lmda_path_size=30, tol=1e-12)
    finally:
        set_configs("stream_speculative_union")
    del Xs9, io9
    # f32 bars: K3 sums a gradient as 256 thread partials and a tree, K5
    # as one chain a column, so the gradients differ by ~1e-7 relative;
    # lmda_max and the path move by that much, and the f32 pin solves
    # (tol 1e-7) carry it into the coefficients at ~1e-5 of max|beta|.
    # The bars, lambda 1e-5 relative and beta 1e-3 max|beta|, leave room
    # for a screening decision taken one lambda apart.
    for what, a, b, lm_bar, b_bar in (
            ("GWAS f32 streamed vs in-HBM (cuda)", st13, st9, 1e-5,
             1e-3 * float(np.abs(st9.betas.toarray()).max())),
            ("snpdat f64 streamed (cuda, 6 tiles) vs in-HBM (cpu)", s11s,
             c11, 1e-10, 1e-6)):
        if a.error or len(a.lmdas) != len(b.lmdas):
            fail(f"{what}: error {a.error!r}, {len(a.lmdas)} vs "
                 f"{len(b.lmdas)} lambdas")
        lm_d = float(np.max(np.abs(a.lmdas / b.lmdas - 1)))
        b_d = float(np.max(np.abs(a.betas.toarray() - b.betas.toarray())))
        phase("stream-vs-hbm", f"{what}: {len(a.lmdas)} lambdas, max lambda "
              f"rel diff {lm_d:.1e} (bar {lm_bar:.0e}), max beta diff "
              f"{b_d:.3e} (bar {b_bar:.2e}), streamed passes "
              f"{len(a.benchmark['kkt'])}")
        if lm_d > lm_bar or b_d > b_bar:
            fail(f"{what}: past the bars")
    phase("stream-vs-hbm", f"GWAS streamed fit wall {wall13:.3f} s against "
          f"in-HBM {wall9:.3f} s | {card}")
    del st9, st13, s11s
    torch.cuda.empty_cache()

    # 14. the north star: 1M SNPs x 100K samples streamed from host memory
    nb_ns = (NS_N + 3) // 4
    mem_total, mem_avail = meminfo()
    P_ns = NS_P
    margin = 16 * 10**9
    if mem_avail < NS_P * nb_ns + margin:
        P_ns = max((mem_avail - margin) // nb_ns // NS_TILE, 1) * NS_TILE
    phase("north-star", f"host MemTotal {mem_total / 1e9:.1f} GB, "
          f"MemAvailable {mem_avail / 1e9:.1f} GB; panel {P_ns} x {NS_N} "
          f"= {P_ns * nb_ns / 1e9:.1f} GB packed"
          + ("" if P_ns == NS_P else
             f" (cut from p={NS_P} in whole tiles to fit the host)")
          + f"; configs.snp_hbm_budget {ad.configs.snp_hbm_budget / 1e9:.0f}"
          " GB, streaming=True forced")
    t0 = time.perf_counter()
    io14, y14, causal14 = north_star_panel(P_ns, NS_N)
    synth14 = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xm14 = ad.matrix.snp_unphased(io14, streaming=True, dtype=np.float32,
                                  device="cuda")
    torch.cuda.synchronize()
    reg14 = time.perf_counter() - t0
    gb14 = P_ns * nb_ns / 1e9
    # one pass of copies alone, and one mul_many pass at C = 1
    copy_s, _ = host_ms(lambda: [None for _ in Xm14._tiles()])
    u14 = torch.as_tensor(y14 / NS_N, device="cuda")[None, :]
    pass_s, _ = host_ms(lambda: Xm14.mul_many(u14))
    copy_s, pass_s = copy_s / 1e3, pass_s / 1e3
    kw14 = dict(lmda_path_size=50, min_ratio=5e-2, device="cuda")
    warm14, _ = fit(ad, Xm14, y14, **kw14)
    torch.cuda.reset_peak_memory_stats()
    sweeps0 = Xm14.sweeps
    zero_counts(tk.launches, sk.launches)
    wall14, st14 = fit(ad, Xm14, y14, **kw14)
    counts14 = {**tk.launches, **sk.launches}
    peak14 = torch.cuda.max_memory_allocated() / 2**30
    sweeps14 = Xm14.sweeps - sweeps0
    devs14 = np.asarray(st14.devs)
    if st14.error != "" or not np.isfinite(devs14).all() \
            or devs14[-1] <= 0.1:
        fail(f"north-star fit: error {st14.error!r}, devs[-1] "
             f"{devs14[-1]:.3f}")
    if counts14["snp_mul_many"] <= 0 or counts14["snp_mul"] != 0:
        fail(f"north-star fit: launches {counts14}; K5 must carry every "
             "pass and K3 none")
    kkt_passes = len(st14.benchmark["kkt"])
    kkt_s = float(np.sum(st14.benchmark["kkt"]))
    hits = len(set(st14.betas[-1].tocoo().col.tolist())
               & set(causal14.tolist()))
    sweeps0 = Xm14.sweeps
    prof14 = profile_fit(ad, Xm14, y14, **kw14)
    passes14 = Xm14.sweeps - sweeps0
    t0 = time.perf_counter()
    kkt14 = stream_kkt_check("north-star fit", io14, y14, st14)
    kktc_s = time.perf_counter() - t0
    L14 = len(st14.lmdas)
    phase("north-star", f"n={NS_N} p={P_ns} f32 {L14} lambdas: path wall "
          f"{wall14:.3f} s (warm-up {warm14:.3f} s; synthesis {synth14:.1f} "
          f"s, page-locking {reg14:.2f} s), X.sweeps {sweeps14}, streamed "
          f"KKT passes {kkt_passes} ({kkt_s:.3f} s), K5 launches "
          f"{counts14['snp_mul_many']}, launches {counts14}, peak device "
          f"memory {peak14:.2f} GiB | {card}")
    phase("north-star", f"copy-only pass {copy_s:.3f} s = "
          f"{gb14 / copy_s:.1f} GB/s H2D; mul_many pass at C=1 "
          f"{pass_s:.3f} s = {gb14 / pass_s:.1f} GB/s; peak screen "
          f"{int(max(st14.screen_sizes))}, causal hits in the last beta "
          f"{hits}/60, devs[-1] {devs14[-1]:.4f}, worst KKT {kkt14:.2e} "
          f"lambda (one plain f64 pass, {kktc_s:.1f} s) | {card}")
    phase("north-star", f"{profile_line(prof14)} | {card}")
    # the chunk pass, K5 at the path's C on every tile, against the tile
    # copies it should hide under
    C14 = max(L14, 1)
    gen14 = torch.Generator(device="cuda").manual_seed(141)
    U14 = torch.randn((C14, NS_N), device="cuda", generator=gen14) / NS_N
    chunk_s, _ = host_ms(lambda: Xm14.mul_many(U14))
    phase("north-star", f"a chunk pass (mul_many at C={C14}) "
          f"{chunk_s / 1e3:.3f} s against the copy-only pass {copy_s:.3f} s;"
          f" {chunk_pass_line(prof14, passes14)} | {card}")
    del U14
    tile14 = Xm14._host[:NS_TILE].to("cuda")
    many_cs = (1, 2, 50, 100)
    t14 = many_timing(tile14, NS_N, many_cs, Xm14._impute[:NS_TILE],
                      seed=140)
    for C, r in t14.items():
        phase("K5", f"on north-star tile 0, T={NS_TILE} n={NS_N} C={C} f32: "
              f"kernel {r['ms']:.3f} ms (operand, once a pass, "
              f"{r['operand_ms']:.3f} ms), twin {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), torch.matmul"
              f" on the decoded f32 tile {r['library_ms']:.3f} ms{r['note']}"
              f" | {card}")
    r = t14[50] if C14 == 50 else many_timing(
        tile14, NS_N, (C14,), Xm14._impute[:NS_TILE], seed=140)[C14]
    snp_time["snp_mul_many"] = dict(r, C=C14, ms_by_C={
        C: t14[C]["ms"] for C in many_cs})
    phase("K5", f"launches x C={C14} ms {counts14['snp_mul_many'] * r['ms']:.1f}"
          f" ms (an upper bound: set-up and dry-fit passes run C <= 2) | "
          f"{card}")
    del tile14, Xm14, io14, st14
    torch.cuda.empty_cache()

    # 15. the kernels' line
    k1_main = next(r for r in k1 if r["S"] == 1024 and r["case"] == "cold"
                   and r["dtype"] == "torch.float32")
    k2_main = next(r for r in k2 if r["S"] == 2048 and r["case"] == "cold"
                   and r["dtype"] == "torch.float32")
    # K1 and K2: the rows of the coordinates that move, each read once;
    # beta and grad in and out; the slot buffers (G = S) in and the flags
    # out; an AXPY of S a moving update
    k1_bound, k2_bound = (
        bound(r["rows"] * S * 4 + 4 * S * 4 + S * 22 + 12, 2 * S * r["moved"])
        for r, S in ((k1_main, 1024), (k2_main, 2048)))
    k6_main = next(r for r in k6 if r["S"] == 1024 and r["qmax"] == 4
                   and r["case"] == "cold" and r["dtype"] == "torch.float32")
    k6_b = k6_bound(k6_main)
    kernels = {"kernels": [
        {"name": "pin_lasso_solve", "route": "cuda",
         "source": "adelie_tpu_torch/csrc/pin_kernels.cu",
         "replaces": "adelie_tpu/solver/pin_pallas.py:366",
         "launches": counts_5["pin_lasso_solve"],
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None},
        {"name": "pin_lasso_solve_rows", "route": "cuda",
         "source": "adelie_tpu_torch/csrc/pin_kernels.cu",
         "replaces": "adelie_tpu/solver/pin_pallas.py:307",
         "launches": counts_6["pin_lasso_solve_rows"],
         "max_abs_err": max(r["max_abs_err"] for r in k2),
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None},
        {"name": "pin_group_solve", "route": "cuda",
         "source": "adelie_tpu_torch/csrc/pin_group_kernels.cu",
         "replaces": "adelie_tpu/solver/pin.py:232 (no TPU kernel: the XLA "
                     "loop of _sweep with adelie_tpu/bcd.py:269)",
         "launches": counts5g["pin_group_solve"],
         "max_abs_err": max(r["max_abs_err"] for r in k6),
         "ms": k6_main["ms"], "plain_ms": k6_main["plain_ms"],
         "bound_ms": k6_b[0], "bound_by": k6_b[1], "library_ms": None},
        *({"name": name, "route": "cuda",
           "source": "adelie_tpu_torch/csrc/snp_kernels.cu",
           "replaces": replaces, "launches": launches,
           "max_abs_err": snp_err[name],
           **{k: snp_time[name][k] for k in (
               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
          for name, replaces, launches in (
              ("snp_mul", "adelie_tpu/matrix/_snp_pallas.py:85",
               counts9["snp_mul"]),
              ("snp_mul_no_na", "adelie_tpu/matrix/_snp_pallas.py:192",
               counts10["snp_mul_no_na"]),
              ("snp_mul_many", "adelie_tpu/matrix/_snp_pallas.py:156",
               counts14["snp_mul_many"]))),
    ]}
    # K5 at the chunk pass's C, and its times at every C measured
    kernels["kernels"][-1].update(
        {k: snp_time["snp_mul_many"][k] for k in ("C", "ms_by_C")})
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
