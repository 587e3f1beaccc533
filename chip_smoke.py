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
4c. K7 ``screened_cd_solve`` (BVLS's and pinball's whole screened fit:
    its chain, gather and replay kernels in segments) against its twin on
    the CPU on copies of the same inputs, bit-equal (beta, grad, flags,
    loss, sweeps, moves): float32 and float64, box and pinball, S in {64,
    1000, 2048, 8192} (float64 at 8,192 with the full sweeps' vectors in
    global memory), from a cold and a warm start, with invalid slots, a d
    = 0 slot and a Q whose triangles differ; each case's time per update
    and per moving update beside its bound, its rounds, longest active
    list and layout, and each kernel's device time (the active segments'
    per listed move); the floor (every delta 0) in float32 at S = 1000
    and 8192; a log of one sweep (a segment, a replay and a host read an
    active sweep) at S = 2048 in float64, box and pinball; a dense warm
    start at S = 8192 in float64 whose active list is too long for the
    compact vectors and a ring in shared memory; the two smaller layouts
    forced at S = 2048 in float64; a ring of two rows forced on a problem
    whose every active sweep ends on listed updates that do not move
    (float64 with a log of one sweep, float32 without); and the three
    kernels against their plain stand-ins after every step of two
    segmented fits (the second with a ring of two rows);
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

The GLM phases (GLMs by IRLS: every IRLS iteration refreshes the screen
Gram under its weights and runs a pin solve), each cell a warm-up and
three timed fits (median wall, the first two bit-equal in lambda and
beta, launches and peak device memory of the first), the IRLS iterations
per lambda and the share at ``irls_max_iters``, a KKT check per lambda in
float64 on the card (every zero group within lambda alpha p_g (1 + 1e-2)
and the intercept's score within 1e-2 lambda; the nonzero groups'
stationarity, which IRLS meets to ``irls_tol``, reported) and one fit
under ``torch.profiler`` (device time by kernel group: the pin kernels,
the GEMMs of the Gram refreshes, the GEMVs, ``eigh``; the idle share):

G0. ``screen_gram``'s peak at S = 16,384 float32 with the intercept: one
    Gram, the (n, S) product and one row block (the old centering held
    three Grams), and the old formula's bits;
G1. the logistic headline: phase 5's X, cases drawn with probability
    sigmoid(z - 1) from the standardized true signal z (about 30 %),
    ``glm.binomial(y)``, intercept, 100 lambdas to 1e-2, no early exit
    (K1); then the probit link, one timed fit;
G2. the poisson headline: the same X, y ~ Poisson(exp(z / 2)) (K1);
G3. the grouped logistic: G1 in 500 groups of 4 (K6), its Newton counts;
G4. the Cox headline: stop = -log(u) exp(-z / 2) rounded to 0.01 (ties),
    70 % events, Efron, no intercept, 50 lambdas (K1); Breslow, one fit;
    the KKT's gradient from a plain float64 sort and cumsum on the host
    (``cox_grad_plain``), and the port's float64 gradient held against it;
G5. the case-control GWAS (run after phase 9, on its panel in device
    memory): cases from its 40 causal SNPs' standardized score, 50
    lambdas to ``GWAS_GLM_MIN_RATIO`` (5e-2, the gaussian GWAS's),
    intercept, early exit (K3, K1, K2); a warm-up under the profiler and
    one timed fit, bit-equal to it (three timed fits before the
    multi-response phases took their time);
G6. the streamed case-control GWAS at the north star (run after phase
    14, on its panel in host memory): cases from its 60 causal SNPs'
    score, 50 lambdas to ``GWAS_GLM_MIN_RATIO``, one timed fit (a
    profiled warm-up and a timed fit before the multi-response phases),
    stopped by a wall budget (``GLM_STREAM_BUDGET_S``, an ``exit_cond``),
    ``X.sweeps``, the KKT check from one plain float64 pass (K5, K1);
G7. ``data.dense(2000, 300, 60, glm=...)`` in float64 on "cuda" and on
    "cpu" (the twins) for binomial, poisson and Cox, and a grouped
    binomial (K6 against its twin): lambdas to rtol 1e-10, beta within
    1e-6.

G0-G4 and G7 run after phase 7c.

The multi-response phases (``X (x) I_K``: K6 carries every solve once a
column is screened, a column's K classes being one group; the screen's
Gram is formed one class at a time from the child's columns):

M1. the multinomial headline (after G7): phase 5's X, K = 3 classes
    drawn from softmax(X B) on its 60 true nonzero rows, intercept, 100
    lambdas to 1e-2, no early exit: a profiled warm-up and a timed fit
    (bit-equal); IRLS iterations per lambda, K1 and K6 launches, the
    KKT per lambda in float64 (``multi_kkt``: every zero group held; the
    nonzero groups' stationarity and the per-class intercept scores,
    which the solvers meet only to their tolerances, reported);
M0. the Kronecker screen block at M1's last screen under the IRLS
    weights of its last iteration, against the naive (n K, S_cap) gather
    formed once: times, peaks, the Gram's, screen gradient's and residual
    update's largest gaps (float32, held at 1e-5), then in float64 at
    n = 2,000, p = 300 on random class weights, formed and extended
    (held at 1e-12);
M5. ``data.dense(2000, 300, 60, K=...)`` in float64 on "cuda" and on
    "cpu": a multinomial (K = 3, 10 lambdas) and a multigaussian (K = 4,
    30 lambdas), lambda, beta and intercepts within 1e-8;
M2. the multi-trait GWAS (after G5, on phase 9's panel in device memory):
    K = 4 traits from its 40 causal SNPs, a multigaussian path of 50
    lambdas to 5e-2, intercept, early exit: a warm-up and two timed fits,
    K3's launches (K a gradient), the KKT per lambda;
M4. (after phase 13) phase 11's snpdat panel with a multigaussian of
    K = 4 and a multinomial of K = 3 from ``data.snp_unphased`` (5
    lambdas to 0.3 lambda_max, tol 1e-16), in
    device memory and streamed (the speculative union off) on the card:
    lambda 1e-10, beta and intercepts 1e-6;
M3. the streamed multi-trait north star (after G6, on phase 14's panel
    in host memory): K = 4 traits from its 60 causal SNPs, a
    multigaussian path of 50 lambdas to 5e-2: a profiled warm-up and a
    timed fit, its passes, K5's launches at each width C K and K5's time
    there on the first tile against a tile's copy, the KKT from one plain
    float64 pass.

The covariance method and the standalone solvers (C1-C3, A1-A4 after M5
on phase 5's X and y; C4 after M2 on phase 9's panel):

C1. ``gaussian_cov(eager_cov(X / sqrt(n)), X^T y / n)``, A formed on the
    card, 100 lambdas to 1e-2, no early exit (phase 5's path): the dense
    chunked path and K1; a warm-up, three timed fits (median wall; the
    first two bit-equal), K1's launches, the KKT per lambda in float64
    on v - A beta (zero groups held at 1e-2 lambda), beta's gap to phase
    5's ``grpnet`` fit, one fit under ``torch.profiler``;
C2. C1 in 500 groups of 4 (K6), its Newton counts;
C3. ``lazy_cov(X / sqrt(n))`` through ``basil.solve_core`` a lambda at a
    time against C1: lambdas, beta, the columns formed, the peak memory;
C4. the summary-statistics GWAS: ``block_diag`` of 200 LD blocks of 1,000
    consecutive standardized SNPs of phase 9's panel, each formed on the
    card from decoded columns, v = X_std^T y / n, 50 lambdas to 5e-2: the
    wall, K1 and K2 launches, peak memory, the KKT, the causal SNPs
    found; the trait's 40 strong SNPs keep the screen small, so a
    polygenic trait on the same blocks (200 causal SNPs, heritability
    0.5, no early exit) takes it past 1024 (K2);
A1. ``bvls`` as non-negative least squares on phase 5's X and y: a
    warm-up whose every K7 call is replayed on the twin on the CPU
    (bit-equal), three timed fits (the first two bit-equal), K7's
    launches and those that did work (the gather and the replay must
    have), rounds, host reads, listed updates and peak memory, the
    bounds' KKT in float64, and K7's time at the largest replayed call
    beside its twin's and its bound, with its gather and replay against
    their stand-ins step by step, their times, bounds and library calls
    (the kernels' line);
A2. ``pinball`` with A (4,096, 1,024), S a Wishart from 4,096 samples,
    penalties U(0.5, 1.5), seed 41, float64, tol 1e-12: one timed fit
    (its sweeps must be the twin order's 64,427), K7's launches and those
    that did work (the gather and the replay must have), rounds, host
    reads, peak memory, each kernel's device time (the replay's share of
    the wall, us a listed update), the objective against a float64 FISTA
    on the card;
A3. ``css_cov`` on the correlation of phase 5's X: greedy least squares
    (k = 100), swapping from it, greedy min-det (k = 100), greedy subset
    factor (k = 20); walls, greedy's least-squares objective against
    swapping's;
A4. float64 on "cuda" and on "cpu": ``gaussian_cov`` on the dense (and
    grouped), lazy, block-diagonal and sparse covariance matrices,
    ``bvls``, ``pinball`` and ``css_cov`` (greedy and swapping, three
    losses): lambdas 1e-10, beta 1e-8, subsets equal.

The structured and user matrices (S0, S1a, S4, S6, S2, S3, S5 after A4;
S1b after C4).  Each fit cell (``struct_cell``) is a warm-up and two
timed fits, bit-equal, with its walls, lambdas, peak screen, pin launches
(and K3's in S1b), a KKT per lambda in float64 from gathered columns
(zero groups held within 1e-2 lambda, the nonzero groups' stationarity
reported) and peak memory; where the design has a dense equivalent, a
fit on it on the card (``struct_vs_dense``: the same count of lambdas,
lambda 1e-5 relative, beta and intercepts 1e-3 of max |beta|):

S0. every new class at n = 2,000 in float64 (standardize, both subsets,
    the row concatenation, the naive block-diagonal and sparse matrices
    in both layouts, one-hot, interaction, gated and full ReLU on dense
    and sparse Z, a user's matrix): ``mul``, ``tmul``, ``gather``,
    ``sq_mul``, and ``mean`` and ``var`` where defined, against the same
    matrix on the CPU and its dense equivalent (1e-12 of the largest
    entry), and twice on the card, bit-equal;
S1a. ``standardize(dense(X_raw))``, X_raw the headline's X before its
    centering, its columns scaled by U(0.5, 5) and shifted by U(-3, 3),
    100 lambdas to 1e-2 (K1), against the standardized array;
S1b. ``standardize`` of phase 9's panel, 50 lambdas to 5e-2 (K3, K1);
S2. a naive sparse matrix, n = 200,000, p = 50,000, density 1e-3 (10
    million nonzeros, the padded planes), 50 true columns, intercept, 50
    lambdas to 1e-2; its gradient ``mul`` against its bound (nonzeros x
    8 B + n x 4 B over 3.35 TB/s) and ``torch.sparse``'s CSR product;
S3. a glinternet design: n = 100,000, 50 features (the odd ones of 5
    levels), ``concatenate([one_hot, interaction of the first 10 with
    all])``, 5,480 columns in 495 groups up to 25 wide, 50 lambdas to
    5e-2 (K6);
S4. the headline in four row blocks (``concatenate(axis=0)``), a 90 %
    row subset, a 75 % column subset and the naive block-diagonal matrix
    of its halves, 50 lambdas to 1e-2, each against its dense equivalent;
S5. convex ReLU features of Z (50,000 x 32) under 128 gates, gated
    (4,096 columns in 128 groups) and full (8,192 in 256), 50 lambdas to
    5e-2 (K6);
S6. a user's ``MatrixNaiveBase`` subclass (``M diag(s)`` on the
    headline) against the scaled array.

The model-selection phases (V1-V3, V5 and V6 after S5, on the headline's
problems; V4 after S1b, on phase 9's panel).  Each CV cell
(``cv_cell``) runs ``cv_grpnet`` with 5 folds and seed 0 twice (the two
runs' fold losses bit-equal), then ``CVGrpnetResult.fit``: the walls of
the dry fit, each fold and the refit, each fit's launches, ``best_idx``,
each fold's losses against a float64 recomputation from its coefficients
on its validation rows (within 1e-4 of max(|loss|, the null loss's
scale)) and the refit's KKT per lambda in float64; every fit's state
passes ``check_state``:

V1. the headline (phase 5's problem and keywords, K1);
V2. G1's logistic data (K1, K2 where a screen passes 1024);
V3. the grouped headline, phase 5b's 500 groups of 4 (K6);
V4. the GWAS CV on phase 9's panel in device memory (K3, K1);
V5. the fixed-screen pin states: ``gaussian_pin_naive`` on the last
    screen of phase 5's fit over its lambdas (K1), of phase 6's problem
    refitted at tol 1e-10 (K2; ``V5_BIG_S_TOL``) and of 5b's (K6), and
    ``gaussian_pin_cov`` on C1's A with phase 5's screen (K1), each
    against its fit's beta (1e-4 of max |beta|);
V6. ``diagnostic(state)`` on phase 5's fit (``predict`` against numpy
    float64 ``X B^T``, the zero groups' ``gradient_scores`` within
    lambda (1 + 1e-2)); ``save_state`` of the headline stopped at its
    50th lambda by an ``exit_cond``, ``load_warm_start`` and the rest of
    the path resumed on the card with ``check_state=True``, against the
    unbroken fit (lambdas equal, beta 1e-4 of max |beta|); and
    ``check_state`` on every state of V1-V6 and on phase 5's, 5b's, G1's,
    M1's and C1's.

Each main path has its launch counts: the counters are zeroed just before
phase 5's timed fit and read just after it (K1), zeroed before phase 5b's
first timed fit and read after it (K6), zeroed before phase 6's timed fit
and read after it (K2), zeroed before phase 9 and read after it (K3),
zeroed before phase 10 and read after it (K4; and before and after 10b's
timed fit, K4 and K6), and zeroed before phase 14's timed fit and read
after it (K5, with no K3); each GLM, multi-response, covariance (C1-C4)
and standalone-solver (A1, A2) cell's, and each S cell's, before and
after its first timed fit (C3's and C4's only fit); each V cell's over
its fits (a CV cell: the first run and the refit).  Every kernel must have run on its path, and the kernels' JSON
gives each kernel's launches on every path that ran it
(``launches_by_path``).  Any failed phase exits non-zero.  The last three lines are the kernels' JSON, the
card's name and power limit, and ``{"ok": true, "device": ...}``.  Needs
one CUDA device; exits 1 without one.
"""

import json
import subprocess
import sys
import time
import types


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    raise SystemExit(1)


T_START = time.perf_counter()


def phase(name, msg):
    """One line of a phase's result, after the seconds since the start."""
    print(f"[{name} +{time.perf_counter() - T_START:.0f} s] {msg}",
          flush=True)


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


def timed(run):
    """(wall s, result) of ``run()`` between two synchronizations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def host_ms(fn):
    s, out = timed(fn)
    return s * 1e3, out


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
    """The group KKT conditions per lambda, in float64 (``group_kkt_parts``),
    both held at 1e-2 lambda.  Returns the worst / lambda."""
    v0, v1 = group_kkt_parts(G, B, lmdas, groups, sizes, penalty, alpha)
    worst = float(max(v0.max(), v1.max()))
    if not worst <= 1e-2:
        fail(f"{what}: group KKT violation {worst:.3e} lambda")
    return worst


def group_kkt_parts(G, B, lmdas, groups, sizes, penalty, alpha):
    """``G`` (L, p) the gradients X^T W r of each lambda's fit (r with its
    intercept), ``B`` (L, p) its coefficients.  Returns per lambda, / lambda
    (two (L,) tensors): over zero groups max ||G_g|| - lambda alpha p_g,
    over nonzero groups max ||G_g - lambda p_g (alpha b_g / ||b_g|| +
    (1 - alpha) b_g)||."""
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
    return v0 / lm, v1 / lm


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


def headline_problem(n, p, k, seed, with_signal=False):
    """bench.py's problem: f32 Gaussian X, k true nonzeros, noise 0.5,
    X and y centered; ``with_signal`` also returns the noise-free signal
    X beta (the GLM phases' score)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    beta = np.zeros(p)
    nz = rng.choice(p, k, replace=False)
    beta[nz] = rng.standard_normal(k)
    signal = X @ beta
    y = (signal + 0.5 * rng.standard_normal(n)).astype(np.float32)
    X -= X.mean(axis=0)
    y -= y.mean()
    return (X, y, signal, nz) if with_signal else (X, y)


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


def fit(ad, Xm, y, glm=None, **kw):
    """(wall s, state) of one ``grpnet`` call: ``glm``, or the gaussian
    of ``y``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ad.grpnet(Xm, ad.glm.gaussian(y) if glm is None else glm, **kw)
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
    io = PackedIO(packed, n)
    io.causal = sig.tolist()
    io.signal = cols.T @ beta        # the causal columns' score, no noise
    y = io.signal + 0.5 * rng.standard_normal(n).astype(np.float32)
    return io, y


def snp_kkt_check(what, Xm, y, state, block=2048):
    """Per lambda, in float64 on the card, with the intercept: the
    gradient g = X^T W (y - X beta - beta_0), W = 1/n, over column blocks
    decoded by ``gather`` (never K3), held by ``lasso_kkt``."""
    return lasso_kkt(what, *snp_grad(Xm, y, state, block)[:3])


def lasso_kkt(what, G, Bfull, lm):
    """The lasso's KKT conditions per lambda from the gradients G (p, L)
    and coefficients (L, p): over zero coefficients max |g_j| - lambda,
    over nonzeros |g_j - lambda sign(beta_j)|, both <= 1e-2 lambda.
    Returns the worst / lambda."""
    import torch

    nz = Bfull != 0
    g = G.T                                                         # (L, p)
    v0 = torch.where(nz, 0.0, g.abs()).amax(dim=1) - lm
    v1 = torch.where(nz, (g - lm[:, None] * Bfull.sign()).abs(),
                     0.0).amax(dim=1)
    worst = float((torch.maximum(v0, v1) / lm).max())
    if not worst <= 1e-2:
        fail(f"{what}: KKT violation {worst:.3e} lambda")
    return worst


def snp_grad(Xm, y, state, block=2048, resid_fn=None):
    """``snp_kkt_check``'s gradients G (p, L) = X^T R, coefficients (L, p),
    lambdas and residuals R (n, L), float64 on the card.  R is
    ``resid_fn(E)`` of the linear predictors E = X beta + beta_0 (n, L), by
    default the gaussian's W (y - E), W = 1/n."""
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
    E = Xa @ Ba.T + b0[None, :]                                     # (n, L)
    R = (y64[:, None] - E) / n if resid_fn is None else resid_fn(E)
    G = torch.empty((p, R.shape[1]), dtype=torch.float64, device=DEV)
    for s in range(0, p, block):
        idx = torch.arange(s, min(s + block, p), device=DEV)
        G[s:s + block] = Xm.gather(idx).double().T @ R
    lm = torch.as_tensor(np.asarray(state.lmdas), device=DEV)
    Bfull = torch.zeros((len(lm), p), dtype=torch.float64, device=DEV)
    Bfull[:, torch.as_tensor(act, device=DEV)] = Ba
    return G, Bfull, lm, R


def profile_fit(ad, Xm, y, glm=None, keep=None, **kw):
    """One more ``grpnet`` fit under ``torch.profiler`` (``profile_run``);
    its state goes to ``keep`` when given."""

    def run():
        wall, state = fit(ad, Xm, y, glm, **kw)
        if keep is not None:
            keep.append(state)
        return wall

    return profile_run(run)


def profile_run(run):
    """``run()`` under ``torch.profiler``: (wall s, device busy ms,
    {kernel: (launches, device ms)}), busiest first; ``run`` returns its
    wall, or anything else to be timed here.  The profiler has not been
    tried on every machine, so a failure of its own (starting, stopping,
    reading its table) is reported as ``None`` and the phase goes on: it
    measures, it checks nothing.  The run is outside those guards, so a
    fault of the port fails the phase."""
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wall = run()
        torch.cuda.synchronize()
        if not isinstance(wall, float):
            wall = time.perf_counter() - t0
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
    io.causal, io.signal = causal.tolist(), g
    return io, y, causal


def stream_kkt_check(what, io, y, state, block=2048, tile=NS_TILE):
    """As snp_kkt_check, for a host-streamed fit (``stream_grad``)."""
    return lasso_kkt(what, *stream_grad(io, y, state, block, tile)[:3])


def stream_grad(io, y, state, block=2048, tile=NS_TILE, resid_fn=None):
    """``snp_grad`` for a host-streamed fit, from the io's own arrays and
    nothing of the streamed matrix: every lambda's residual in one (n, L)
    float64 block, and one more pass over the panel, a tile at a time by a
    plain synchronous copy, that decodes with plain torch code and
    multiplies with torch.matmul in float64, never K5."""
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
    E = Xa @ Ba.T + b0[None, :]
    R = (y64[:, None] - E) / n if resid_fn is None else resid_fn(E)
    del Xa, E
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
    return G, Bfull, lm, R


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


# --------------------------------------------------------------------------- #
# phases G0 to G7: GLMs by IRLS                                               #
# --------------------------------------------------------------------------- #


def standardized(v):
    import numpy as np

    v = np.asarray(v, np.float64)
    return (v - v.mean()) / v.std()


def case_control(z, seed):
    """Cases drawn with probability sigmoid(z - 1), z a standardized
    score: about 30 % cases."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mu = 1.0 / (1.0 + np.exp(1.0 - z))
    return (rng.uniform(size=len(z)) < mu).astype(np.float32)


def cox_response(z, seed):
    """Survival times ``-log(u) exp(-z / 2)`` rounded to 0.01 (so that
    times tie), 70 % events: (stop, status)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    stop = np.round(-np.log(rng.uniform(size=len(z))) * np.exp(-0.5 * z), 2)
    status = rng.binomial(1, 0.7, size=len(z)).astype(np.float64)
    return stop, status


def cox_grad_plain(stop, status, eta, efron):
    """The negative gradient of the Cox partial likelihood in eta, weights
    1/n, no left truncation, one stratum, in float64 numpy: rows sorted by
    stop, at-risk sums as suffix sums from each tie group's first row,
    the events' sums as prefix sums through its last row, and Efron's
    correction from each event's rank among its group's events.  It shares
    no code with ``adelie_tpu_torch.glm``."""
    import numpy as np

    n = len(stop)
    order = np.argsort(stop, kind="stable")
    t, d = np.asarray(stop)[order], np.asarray(status, np.float64)[order]
    z = np.exp(eta[order] - eta.max()) / n
    first = np.flatnonzero(np.r_[True, t[1:] != t[:-1]])
    last = np.r_[first[1:], n] - 1
    gid = np.cumsum(np.r_[True, t[1:] != t[:-1]]) - 1
    count = np.bincount(gid, weights=d)[gid]
    sigma = np.zeros(n)
    if efron:
        before = np.cumsum(d) - d
        sigma = d * (before - before[first[gid]]) / np.maximum(count, 1)
    risk = (np.cumsum(z[::-1])[::-1][first[gid]]
            - sigma * np.bincount(gid, weights=z * d)[gid])
    # each event carries its group's mean event weight, 1/n
    v = np.where(d > 0, d / n / np.where(d > 0, risk, 1.0), 0.0)
    acc = (np.cumsum(v)[last[gid]]
           - d * np.bincount(gid, weights=sigma * v)[gid])
    out = np.empty(n)
    out[order] = d / n - acc * z
    return out


def glm_resid(kind, y=None):
    """``E -> R``: each column's negative loss gradient in the linear
    predictor, w (y - mu) with w = 1/n, float64 on the card, for the KKT
    conditions of the fit (|X^T R| bounded), by plain formulas: for Cox
    (``y`` = (stop, status, tie method)) ``cox_grad_plain`` on the host."""
    import numpy as np
    import torch

    if kind == "cox":
        stop, status, ties = y
        return lambda E: torch.as_tensor(np.stack(
            [cox_grad_plain(stop, status, e, ties == "efron")
             for e in E.T.cpu().numpy()], 1), device=DEV)
    y64 = torch.as_tensor(np.asarray(y, np.float64), device=DEV)[:, None]
    n = y64.shape[0]
    if kind == "logit":
        return lambda E: (y64 - torch.sigmoid(E)) / n
    if kind == "poisson":
        return lambda E: (y64 - torch.exp(E)) / n

    def probit(E):
        Phi = torch.special.ndtr(E)
        pdf = torch.exp(-0.5 * E * E) / np.sqrt(2 * np.pi)
        return pdf * (y64 / Phi - (1 - y64) / (1 - Phi)) / n
    return probit


def cox_gradient_check(what, glm, X, state, stop, status, ties):
    """The port's Cox gradient in float64 on the card against
    ``cox_grad_plain`` at the path's last eta: the largest difference
    relative to the largest entry, held at 1e-10."""
    import numpy as np
    import torch

    eta = np.asarray(X, np.float64) @ state.betas[-1].toarray()[0]
    port = glm.to(DEV, np.float64).gradient(
        torch.as_tensor(eta, device=DEV)).cpu().numpy()
    plain = cox_grad_plain(stop, status, eta, ties == "efron")
    err = float(np.abs(port - plain).max() / np.abs(plain).max())
    if not err <= 1e-10:
        fail(f"{what}: the port's Cox gradient is {err:.2e} off the plain one")
    return err


def intercept_score(what, R, lm):
    """The intercept's score |sum_i w_i (y_i - mu_i)| / lambda, worst over
    the path; at most 1e-2 (it is unpenalized: 0 at the optimum)."""
    import torch

    lm = torch.as_tensor(lm, dtype=R.dtype, device=R.device)
    worst = float((R.sum(0).abs() / lm).max())
    if not worst <= 1e-2:
        fail(f"{what}: intercept score {worst:.3e} lambda")
    return worst


def glm_kkt(what, G, B, state, R, groups, sizes, penalty):
    """A GLM fit's KKT conditions per lambda in float64 from its gradients
    G (L, p), coefficients B (L, p) and residuals R (n, L): every zero
    group within lambda alpha p_g (1 + 1e-2), and the intercept's score,
    held at 1e-2 lambda; the nonzero groups' stationarity (within IRLS's
    ``irls_tol``, not held) is reported.  Returns (zero groups' worst,
    nonzero groups' worst, score or None), each / lambda."""
    lm = state.lmdas
    v0, v1 = group_kkt_parts(G, B, lm, groups, sizes, penalty, 1.0)
    zero, nonzero = float(v0.max()), float(v1.max())
    if not zero <= 1e-2:
        fail(f"{what}: KKT violation {zero:.3e} lambda at a zero group")
    score = intercept_score(what, R, lm) if state.intercept else None
    return zero, nonzero, score


def singletons(p):
    """(groups, sizes, penalty) of p groups of one column."""
    import numpy as np

    return np.arange(p), np.ones(p, int), np.ones(p)


def glm_dense_kkt(what, X, state, resid_fn, groups, sizes, penalty):
    """``glm_kkt`` of a dense fit (groups of one column give the lasso's
    conditions)."""
    import numpy as np
    import torch

    Xd = torch.as_tensor(np.asarray(X), device=DEV).double()
    B = torch.as_tensor(state.betas.toarray(), device=DEV).double()
    b0 = torch.as_tensor(np.asarray(state.intercepts, np.float64), device=DEV)
    R = resid_fn(Xd @ B.T + b0[None, :])                       # (n, L)
    return glm_kkt(what, (Xd.T @ R).T, B, state, R, groups, sizes, penalty)


def kkt_words(kkt):
    zero, nonzero, score = kkt
    return (f"KKT (float64): zero groups {zero:.2e} lambda, nonzero groups' "
            f"stationarity {nonzero:.2e} lambda"
            + ("" if score is None else
               f", intercept score {score:.2e} lambda"))


def irls_line(state, irls_max_iters=int(1e4)):
    """IRLS iterations in total, per lambda solved, and the share of the
    lambda fits (dry fits and KKT retries included) at the cap."""
    import numpy as np

    it = np.asarray(state.benchmark["irls_iters"])
    return (f"IRLS iterations {int(it.sum())} in {len(it)} lambda fits "
            f"({it.sum() / max(len(state.lmdas), 1):.2f} per lambda solved,"
            f" at most {int(it.max())}), share at irls_max_iters "
            f"{float(np.mean(it >= irls_max_iters)):.3f}, host copies "
            f"{int(it.sum()) + len(it)} (one an IRLS iteration, one a "
            "lambda fit)")


# the profile's kernel groups: the pin kernels, the SNP kernels, the GEMMs
# (the Grams, and the gradients in blocks), the GEMVs (gradients X^T r)
# and the batched eigh (cuSOLVER)
PROFILE_GROUPS = (("K1", ("pin_lasso_solve_kernel",)),
                  ("K2", ("pin_lasso_solve_rows_kernel",)),
                  ("K6", ("pin_group_solve_kernel",)),
                  ("K3/K4", ("snp_mul_kernel",)),
                  ("K5", ("snp_mul_many_kernel",)),
                  ("gemm", ("gemm", "xmma", "cutlass")),
                  ("gemv", ("gemv", "dot_kernel", "reduce_1Block")),
                  ("eigh", ("syev", "sytrd", "ormtr", "orgtr", "steqr",
                            "stedc", "jacobi")))


def glm_profile_line(prof):
    """The profiled fit's device time by kernel group (``PROFILE_GROUPS``;
    the rest as "other"), beside its wall and idle share."""
    if prof is None or prof[1] <= 0:
        return "profiled fit: device time not measured"
    wall, _, events = prof
    sums = {}
    for name, (count, ms) in events.items():
        if name.startswith("Mem"):
            continue
        low = name.lower()
        group = next((g for g, keys in PROFILE_GROUPS
                      if any(k.lower() in low for k in keys)), "other")
        c, t = sums.get(group, (0, 0.0))
        sums[group] = (c + count, t + ms)
    busy = sum(t for _, t in sums.values())
    parts = ", ".join(f"{g} {t:.1f} ms x{c}" for g, (c, t) in
                      sorted(sums.items(), key=lambda kv: -kv[1][1]))
    return (f"profiled fit: wall {wall:.3f} s, kernels busy {busy:.1f} ms, "
            f"idle share {1 - busy / (wall * 1e3):.3f}; {parts}")


def timed_fits(ad, Xm, glm, counters, reps=3, profiled=False, **kw):
    """A warm-up and ``reps`` timed fits of one cell: the launch counts of
    the first timed fit (counters zeroed just before it), its peak device
    memory, the median wall, and the first two fits (with one timed fit,
    the warm-up and the timed fit) bit-equal in lambda and beta, or the
    run fails.  With ``profiled`` the warm-up runs under ``profile_fit``.
    Returns (state, walls, warm-up s, counts, peak GiB, the warm-up's
    profile or None)."""
    import numpy as np
    import torch

    def path(st):
        # the host copies only: a state holds its screen block on the card
        return st.lmdas, st.betas.toarray()

    prof, kept = None, []
    if profiled:
        prof = profile_fit(ad, Xm, None, glm, keep=kept, **kw)
        warm = float("nan") if prof is None else prof[0]
    if not kept:
        warm, st = fit(ad, Xm, None, glm, **kw)
        kept.append(st)
    second = path(kept.pop())
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)
    wall, state = fit(ad, Xm, None, glm, **kw)
    counts = {k: v for c in counters for k, v in c.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    walls = [wall]
    for i in range(reps - 1):
        wall, st = fit(ad, Xm, None, glm, **kw)
        walls.append(wall)
        if i == 0:
            second = path(st)
        del st
    first = path(state)
    if not (np.array_equal(first[0], second[0])
            and np.array_equal(first[1], second[1])):
        fail(f"{glm.name}: two fits differ (beta or lambdas)")
    return state, walls, warm, counts, peak, prof


def glm_cell_line(what, state, walls, warm, counts, peak, kkt,
                  warm_what="warm-up"):
    import numpy as np

    return (f"{what}: {len(state.lmdas)} lambdas, error "
            f"{state.error!r}, wall median {np.median(walls):.3f} s of "
            f"{len(walls)} ({min(walls):.3f}-{max(walls):.3f}; {warm_what} "
            f"{warm:.3f} s), "
            f"{'first two' if len(walls) > 1 else 'it and the warm-up'} "
            f"bit-equal, peak screen "
            f"{int(max(state.screen_sizes))}, pin solves' S in "
            f"[{min(state.benchmark['pin_caps'])}, "
            f"{max(state.benchmark['pin_caps'])}], launches {counts}, "
            f"{kkt if isinstance(kkt, str) else kkt_words(kkt)}, peak "
            f"memory {peak:.2f} GiB")


def gram_peak_phase(card, n=4096, S=16384):
    """Repair of the screen Gram's centering: ``screen_gram`` at S = 16384
    in float32 holds one Gram, the (n, S) product ``Xs * w`` and one row
    block of the outer product at its peak (the old ``A - outer(m, m)``
    held three Grams), and gives the old formula's bits."""
    import torch

    from adelie_tpu_torch.solver.pin import screen_gram

    gen = torch.Generator(device=DEV).manual_seed(16)
    Xs = torch.randn((n, S), device=DEV, generator=gen)
    w = torch.rand(n, device=DEV, generator=gen)
    w = w / w.sum()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    A, means = screen_gram(Xs, w, True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    gram, temp = S * S * 4, n * S * 4
    block = max(256, S // 8) * S * 4
    A0, _ = screen_gram(Xs, w, False)
    same = torch.equal(A, A0 - torch.outer(means, means))
    del A, A0, Xs
    torch.cuda.empty_cache()
    phase("gram-peak", f"screen_gram n={n} S={S} f32 with the intercept: "
          f"peak {peak / 2**30:.3f} GiB above its inputs, against one Gram "
          f"{gram / 2**30:.3f} + the (n, S) temporary {temp / 2**30:.3f} + "
          f"a row block {block / 2**30:.3f} = "
          f"{(gram + temp + block) / 2**30:.3f} GiB (three Grams: "
          f"{3 * gram / 2**30:.3f}); bits equal to A - outer(m, m): {same}"
          f" | {card}")
    if not same or peak > gram + temp + block + 2**26:
        fail("screen_gram: more than one Gram at its peak, or other bits")
    return peak


def glm_dense_phases(ad, card, tk, pg, X, signal):
    """Phases G1-G4 on the headline's X (n = 40,000, p = 2,000, f32):
    logistic (and probit), poisson, grouped logistic, Cox.  Returns the
    launch counts of each cell's first timed fit."""
    import numpy as np

    Xm = ad.matrix.dense(X, device="cuda")
    z = standardized(signal)
    n, p = X.shape
    ones = singletons(p)
    kw = dict(lmda_path_size=100, min_ratio=1e-2, early_exit=False,
              device="cuda")
    out = {}

    # G1. logistic headline (K1), then the probit link
    y1 = case_control(z, seed=21)
    glm1 = ad.glm.binomial(y1)
    st, walls, warm, counts, peak, _ = timed_fits(
        ad, Xm, glm1, (tk.launches,), **kw)
    if st.error or len(st.lmdas) != 100 or counts["pin_lasso_solve"] <= 0:
        fail(f"logistic headline: error {st.error!r}, {len(st.lmdas)} "
             f"lambdas, launches {counts}")
    kkt = glm_dense_kkt("logistic headline", X, st,
                               glm_resid("logit", y1), *ones)
    audit(ad, "logistic (G1)", st)
    out["logistic"] = counts
    phase("logistic", f"n={n} p={p} f32, {y1.mean():.3f} cases, "
          + glm_cell_line("binomial(y), intercept", st, walls, warm, counts,
                          peak, kkt) + f" | {card}")
    phase("logistic", f"{irls_line(st)}; dev[-1] {st.devs[-1]:.4f} | {card}")
    prof = profile_fit(ad, Xm, None, glm1, **kw)
    phase("logistic", f"{glm_profile_line(prof)} | {card}")
    glmp = ad.glm.binomial(y1, link="probit")
    zero_counts(tk.launches)
    wall, st = fit(ad, Xm, None, glmp, **kw)
    counts = dict(tk.launches)
    if st.error or len(st.lmdas) != 100 or counts["pin_lasso_solve"] <= 0:
        fail(f"probit: error {st.error!r}, {len(st.lmdas)} lambdas, "
             f"launches {counts}")
    kkt = glm_dense_kkt("probit", X, st, glm_resid("probit", y1), *ones)
    phase("probit", f"binomial(y, link='probit'): {len(st.lmdas)} lambdas, "
          f"wall {wall:.3f} s (one fit), launches {counts}, "
          f"{kkt_words(kkt)}; {irls_line(st)} | {card}")

    # G2. poisson headline (K1)
    y2 = np.random.default_rng(22).poisson(np.exp(0.5 * z)).astype(np.float32)
    glm2 = ad.glm.poisson(y2)
    st, walls, warm, counts, peak, _ = timed_fits(
        ad, Xm, glm2, (tk.launches,), **kw)
    if st.error or len(st.lmdas) != 100 or counts["pin_lasso_solve"] <= 0:
        fail(f"poisson headline: error {st.error!r}, {len(st.lmdas)} "
             f"lambdas, launches {counts}")
    kkt = glm_dense_kkt("poisson headline", X, st,
                               glm_resid("poisson", y2), *ones)
    out["poisson"] = counts
    phase("poisson", f"n={n} p={p} f32, mean count {y2.mean():.3f}, "
          + glm_cell_line("poisson(y), intercept", st, walls, warm, counts,
                          peak, kkt) + f" | {card}")
    phase("poisson", f"{irls_line(st)}; "
          f"{glm_profile_line(profile_fit(ad, Xm, None, glm2, **kw))} | "
          f"{card}")

    # G3. grouped logistic: 500 groups of 4 (K6)
    groups = np.arange(0, p, 4)
    kwg = dict(kw, groups=groups)
    pg.reset_newton()
    st, walls, warm, counts, peak, _ = timed_fits(
        ad, Xm, glm1, (tk.launches, pg.launches), **kwg)
    if st.error or len(st.lmdas) != 100 or counts["pin_group_solve"] <= 0:
        fail(f"grouped logistic: error {st.error!r}, {len(st.lmdas)} "
             f"lambdas, launches {counts}")
    kkt = glm_dense_kkt("grouped logistic", X, st,
                               glm_resid("logit", y1), groups,
                               np.full(len(groups), 4),
                               np.full(len(groups), 2.0))
    out["logistic-grouped"] = counts
    phase("logistic-grouped", f"n={n} p={p} f32 {len(groups)} groups of 4, "
          + glm_cell_line("binomial(y), intercept", st, walls, warm, counts,
                          peak, kkt) + f" | {card}")
    pg.reset_newton()
    prof = profile_fit(ad, Xm, None, glm1, **kwg)
    phase("logistic-grouped", f"{irls_line(st)}; Newton (the profiled fit) "
          f"{newton_line(pg.newton)} | {card}")
    phase("logistic-grouped", f"{glm_profile_line(prof)} | {card}")

    # G4. Cox headline: ties, 70 % events, Efron (K1); then Breslow
    stop, status = cox_response(z, seed=24)
    glm4 = ad.glm.cox(stop=stop, status=status)
    kw4 = dict(kw, lmda_path_size=50, intercept=False)
    st, walls, warm, counts, peak, _ = timed_fits(
        ad, Xm, glm4, (tk.launches,), **kw4)
    if st.error or len(st.lmdas) != 50 or counts["pin_lasso_solve"] <= 0:
        fail(f"cox headline: error {st.error!r}, {len(st.lmdas)} lambdas, "
             f"launches {counts}")
    kkt = glm_dense_kkt("cox headline", X, st,
                           glm_resid("cox", (stop, status, "efron")), *ones)
    cox_err = cox_gradient_check("cox headline", glm4, X, st, stop, status,
                                 "efron")
    out["cox"] = counts
    phase("cox", f"n={n} p={p} f32, {int(status.sum())} events, "
          f"{glm4._n_ties} tie groups (stop rounded to 0.01), Efron, no "
          "intercept, "
          + glm_cell_line("cox(stop, status)", st, walls, warm, counts, peak,
                          kkt) + f" (the KKT's gradient by a plain float64 "
          f"sort and cumsum on the host; the port's float64 gradient at the "
          f"last eta {cox_err:.1e} off it, relative) | {card}")
    phase("cox", f"{irls_line(st)}; "
          f"{glm_profile_line(profile_fit(ad, Xm, None, glm4, **kw4))} | "
          f"{card}")
    glmb = ad.glm.cox(stop=stop, status=status, tie_method="breslow")
    wall, st = fit(ad, Xm, None, glmb, **kw4)
    if st.error or len(st.lmdas) != 50:
        fail(f"cox breslow: error {st.error!r}, {len(st.lmdas)} lambdas")
    kkt = glm_dense_kkt("cox breslow", X, st,
                           glm_resid("cox", (stop, status, "breslow")), *ones)
    cox_gradient_check("cox breslow", glmb, X, st, stop, status, "breslow")
    phase("cox", f"Breslow ties: {len(st.lmdas)} lambdas, wall {wall:.3f} s "
          f"(one fit), {kkt_words(kkt)}; {irls_line(st)} | {card}")
    return out


def glm_cuda_vs_cpu_phase(ad, tk, pg):
    """G7: ``data.dense(2000, 300, 60, glm=...)`` in float64 on "cuda" and
    on "cpu" (the kernels' twins): binomial, poisson and Cox, and a grouped
    binomial (K6 against its twin); lambdas to rtol 1e-10, beta within
    1e-6."""
    import numpy as np

    cases = (("binomial", "binomial", False, 30),
             ("poisson", "poisson", False, 30), ("cox", "cox", False, 20),
             ("grouped binomial", "binomial", True, 30))
    for what, glm, grouped, L in cases:
        d = ad.data.dense(2000, 300, 60, glm=glm, seed=17)
        kw = dict(lmda_path_size=L, intercept=glm != "cox")
        if grouped:
            kw.update(groups=d["groups"], penalty=d["penalty"])
        zero_counts(tk.launches, pg.launches)
        s_gpu = ad.grpnet(d["X"], d["glm"], device="cuda", **kw)
        counts = {**tk.launches, **pg.launches}
        t0 = time.perf_counter()
        s_cpu = ad.grpnet(d["X"], d["glm"], device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        if s_gpu.error or s_cpu.error or len(s_gpu.lmdas) != len(s_cpu.lmdas):
            fail(f"{what} cuda vs cpu: errors {s_gpu.error!r} "
                 f"{s_cpu.error!r}, {len(s_gpu.lmdas)} vs "
                 f"{len(s_cpu.lmdas)} lambdas")
        lm_err = float(np.max(np.abs(s_gpu.lmdas / s_cpu.lmdas - 1)))
        b_err = float(np.max(np.abs(s_gpu.betas.toarray()
                                    - s_cpu.betas.toarray())))
        kernel = "pin_group_solve" if grouped else "pin_lasso_solve"
        phase("glm-cuda-vs-cpu", f"{what}: data.dense(2000, 300, 60, "
              f"glm={glm!r}) f64, {L} lambdas: launches {counts}, max "
              f"lambda rel diff {lm_err:.1e}, max beta diff {b_err:.3e}, "
              f"IRLS iterations {sum(s_gpu.benchmark['irls_iters'])} (cpu "
              f"{sum(s_cpu.benchmark['irls_iters'])}; the CPU fit "
              f"{cpu_s:.1f} s)")
        if counts[kernel] <= 0 or lm_err > 1e-10 or b_err > 1e-6:
            fail(f"the card's {what} fit differs from the CPU path")


# the case-control paths' depth: 50 lambdas to 5e-2 lambda_max, the
# gaussian GWAS's.  There the weak per-SNP signal of sigmoid(z - 1) lets
# the strong rule screen tens of thousands of the GWAS panel's SNPs, so
# that every IRLS iteration refreshes a Gram tens of thousands wide (the
# JAX package screens the same way)
GWAS_GLM_MIN_RATIO = 5e-2


def glm_gwas_phase(ad, card, tk, sk, Xm, io):
    """G5: the case-control GWAS on phase 9's panel in device memory:
    cases drawn from its 40 causal SNPs' standardized score, a logistic
    path of 50 lambdas to ``GWAS_GLM_MIN_RATIO`` with the intercept and
    the early exit (K3, K1 and K2): a profiled warm-up and one timed fit
    (three before the multi-response phases came: the script's time
    limit), bit-equal, the KKT per lambda.  Returns the launch counts of
    the timed fit."""
    import numpy as np

    y = case_control(standardized(io.signal), seed=25)
    glm = ad.glm.binomial(y)
    kw = dict(lmda_path_size=50, min_ratio=GWAS_GLM_MIN_RATIO,
              device="cuda")
    st, walls, warm, counts, peak, prof = timed_fits(
        ad, Xm, glm, (tk.launches, sk.launches), reps=1, profiled=True,
        **kw)
    if (st.error or not np.isfinite(st.devs).all()
            or counts["snp_mul"] <= 0 or counts["pin_lasso_solve"] <= 0):
        fail(f"case-control GWAS: error {st.error!r}, launches {counts}")
    G, Bfull, _, R = snp_grad(Xm, y, st, resid_fn=glm_resid("logit", y))
    n, p = Xm.shape
    kkt = glm_kkt("case-control GWAS", G.T, Bfull, st, R, *singletons(p))
    del G, Bfull, R
    phase("gwas-logistic", f"n={n} p={p} f32, {y.mean():.3f} cases, "
          + glm_cell_line("binomial(y), intercept, early exit", st, walls,
                          warm, counts, peak, kkt, "profiled warm-up")
          + f", K3 per lambda {counts['snp_mul'] / len(st.lmdas):.2f}, "
          f"min_ratio {GWAS_GLM_MIN_RATIO}, active at the last lambda "
          f"{st.betas[-1].nnz}, causal hits {causal_hits(io, st)}, devs[-1] "
          f"{st.devs[-1]:.4f} | {card}")
    phase("gwas-logistic", f"{irls_line(st)}; the warm-up's "
          f"{glm_profile_line(prof)} | {card}")
    return counts


def causal_hits(io, state):
    """The causal SNPs among the last lambda's nonzero coefficients."""
    hits = set(state.betas[-1].tocoo().col.tolist()) & set(io.causal)
    return f"{len(hits)}/{len(io.causal)}"


# G6's wall budget: each of its fits stops at the first lambda that ends
# more than this many seconds after the fit began.  The budget is an
# ``exit_cond``, which the solver checks after every lambda and which
# makes every chunk one lambda long, as in the JAX package.  With the
# default chunks the streamed path to 5e-2 does not end within this
# script's time limit: the third chunk's KKT pass unions its violators
# at every speculative lambda into a screen of 47,307 SNPs, and the next
# chunk fits 47 lambdas on that screen, each IRLS iteration refreshing a
# Gram of 2 n S_cap^2 = 8.6e14 operations (S_cap 65,536)
GLM_STREAM_BUDGET_S = 90.0


def wall_budget(seconds):
    """An ``exit_cond``: true once ``seconds`` have passed since its
    making."""
    t0 = time.perf_counter()
    return lambda state: time.perf_counter() - t0 > seconds


def glm_north_star_phase(ad, card, tk, sk, Xm, io):
    """G6: the streamed case-control GWAS at the north star: cases drawn
    from its 60 causal SNPs' standardized score, a logistic path of 50
    lambdas to ``GWAS_GLM_MIN_RATIO`` (K5 in every pass, K1 and K2): one
    timed fit within ``GLM_STREAM_BUDGET_S`` (a profiled warm-up and a
    timed fit before the multi-response phases came: the script's time
    limit), and the KKT of its lambdas from one plain float64 pass.
    Returns the launch counts of the fit."""
    import numpy as np
    import torch

    y = case_control(standardized(io.signal), seed=26)
    glm = ad.glm.binomial(y)
    kw = dict(lmda_path_size=50, min_ratio=GWAS_GLM_MIN_RATIO,
              device="cuda")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(tk.launches, sk.launches)
    sweeps0 = Xm.sweeps
    wall, st = fit(ad, Xm, None, glm,
                   exit_cond=wall_budget(GLM_STREAM_BUDGET_S), **kw)
    counts = {**tk.launches, **sk.launches}
    sweeps = Xm.sweeps - sweeps0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if (st.error or not len(st.lmdas) or not np.isfinite(st.devs).all()
            or counts["snp_mul_many"] <= 0 or counts["snp_mul"] != 0
            or counts["pin_lasso_solve"] <= 0):
        fail(f"streamed case-control: error {st.error!r}, "
             f"{len(st.lmdas)} lambdas, launches {counts}: K5 must carry "
             "every pass, K3 none")
    t0 = time.perf_counter()
    G, Bfull, _, R = stream_grad(io, y, st, resid_fn=glm_resid("logit", y))
    kkt = glm_kkt("streamed case-control", G.T, Bfull, st, R,
                  *singletons(io.snps()))
    kkt_s = time.perf_counter() - t0
    del G, Bfull, R
    lm_ratio = st.lmdas[-1] / st.lmdas[0]
    phase("north-star-logistic", f"n={io.rows()} p={io.snps()} f32 "
          f"streamed, {y.mean():.3f} cases, binomial(y), intercept, 50 "
          f"lambdas to {GWAS_GLM_MIN_RATIO} within a wall budget of "
          f"{GLM_STREAM_BUDGET_S:.0f} s a fit (chunks of one lambda): "
          f"{len(st.lmdas)} lambdas solved, the last at {lm_ratio:.4f} of "
          f"the first, error {st.error!r}, wall {wall:.3f} s (one fit, "
          f"the first of the call on this path), active at the last lambda "
          f"{st.betas[-1].nnz}, causal hits {causal_hits(io, st)}, X.sweeps "
          f"{sweeps}, streamed KKT passes {len(st.benchmark['kkt'])} "
          f"({sum(st.benchmark['kkt']):.3f} s), peak screen "
          f"{int(max(st.screen_sizes))}, pin solves' S in "
          f"[{min(st.benchmark['pin_caps'])}, "
          f"{max(st.benchmark['pin_caps'])}], launches {counts}, "
          f"{kkt_words(kkt)} (one plain f64 pass, {kkt_s:.1f} s), peak "
          f"device memory {peak:.2f} GiB | {card}")
    phase("north-star-logistic", f"{irls_line(st)} | {card}")
    return counts


# --------------------------------------------------------------------------- #
# phases M0 to M5: multi-response fits on X (x) I_K                           #
# --------------------------------------------------------------------------- #


def multi_resid(family, Y):
    """``E -> R`` for the KKT of a multi-response fit: the linear
    predictors E (n, L, K) to the negative gradient of the loss in eta,
    w (y - mu) / K with w = 1/n, float64 on the card, by plain formulas
    (mu = E for the multigaussian, softmax over the classes for the
    multinomial)."""
    import numpy as np
    import torch

    Y64 = torch.as_tensor(np.asarray(Y, np.float64), device=DEV)[:, None, :]
    n, K = Y64.shape[0], Y64.shape[2]
    if family == "multigaussian":
        return lambda E: (Y64 - E) / (n * K)
    return lambda E: (Y64 - torch.softmax(E, dim=2)) / (n * K)


def multi_kkt(what, cols, n, p, state, resid_fn, block=2048):
    """The KKT conditions of a multi-response fit per lambda, in float64
    on the card.  ``cols(idx)`` gives the user matrix's columns ``idx``
    (n, len) in float64.  Each lambda's gradient X^T R (p, K) over every
    column, from the residuals R (n, K) of its coefficients (L, p K) and
    (L, K) intercepts; a column's K classes form one group of penalty
    sqrt(K): every zero group within lambda sqrt(K) (1 + 1e-2), and every
    class's intercept score (an unpenalized coordinate of the flattened
    problem) within 1e-2 lambda, held.  The nonzero groups' stationarity
    is reported: IRLS meets it only to ``irls_tol`` (its diagonal Hessian
    bound converges slowly on the multinomial).  Returns (zero groups'
    worst, nonzero groups' worst, intercept score), each / lambda."""
    import numpy as np
    import torch

    K = state.n_classes
    L = len(state.lmdas)
    B = state.betas.tocsc()
    act = np.unique(state.betas.tocsr().indices // K)
    Ba = torch.as_tensor(
        B[:, (act[:, None] * K + np.arange(K)).ravel()].toarray(),
        dtype=torch.float64, device=DEV).reshape(L, len(act), K)
    b0 = torch.as_tensor(np.asarray(state.intercepts, np.float64),
                         device=DEV)                              # (L, K)
    E = torch.einsum("na,lak->nlk", cols(act), Ba) + b0[None]
    R = resid_fn(E)                                               # (n, L, K)
    del E
    Rf = R.reshape(n, L * K)
    G = torch.empty((p, L * K), dtype=torch.float64, device=DEV)
    for s in range(0, p, block):
        e = min(s + block, p)
        G[s:e] = cols(np.arange(s, e)).T @ Rf
    G = G.reshape(p, L, K).permute(1, 0, 2).reshape(L, p * K)
    Bf = torch.zeros((L, p, K), dtype=torch.float64, device=DEV)
    Bf[:, torch.as_tensor(act, device=DEV)] = Ba
    v0, v1 = group_kkt_parts(G, Bf.reshape(L, p * K), state.lmdas,
                             np.arange(p) * K, np.full(p, K),
                             np.full(p, np.sqrt(K)), 1.0)
    zero, nonzero = float(v0.max()), float(v1.max())
    lm = torch.as_tensor(np.asarray(state.lmdas), device=DEV)
    score = float((R.sum(0).abs() / lm[:, None]).max())
    del G, Bf, R, Rf
    if not zero <= 1e-2:
        fail(f"{what}: KKT violation {zero:.3e} lambda at a zero group")
    if not score <= 1e-2:
        fail(f"{what}: an intercept score of {score:.3e} lambda")
    return zero, nonzero, score


def dense_cols(X):
    """``cols`` of ``multi_kkt`` for a dense numpy X."""
    import torch

    Xd = torch.as_tensor(X, device=DEV)
    return lambda idx: Xd[:, torch.as_tensor(idx, device=DEV)].double()


def snp_cols(io):
    """``cols`` of ``multi_kkt`` for a packed panel in host memory: the
    rows taken on the host, decoded on the card with plain torch code in
    float64 (never K3 or K5), NA read as the column's impute value."""
    import numpy as np
    import torch

    from adelie_tpu_torch.matrix import snp_kernels as sk

    n = io.rows()
    imp = torch.as_tensor(np.asarray(io.impute, np.float64), device=DEV)

    def cols(idx):
        rows = torch.from_numpy(io.packed[np.asarray(idx)]).to(DEV)
        blk = sk.unpack_cols(rows, n, torch.float64)
        imp_i = imp[torch.as_tensor(idx, device=DEV)]
        return torch.where(blk == 3, imp_i[None, :], blk)
    return cols


def multi_kkt_words(kkt):
    zero, nonzero, score = kkt
    return (f"KKT (float64, a column's K classes one group): zero groups "
            f"{zero:.2e} lambda, nonzero groups' stationarity "
            f"{nonzero:.2e} lambda, per-class intercept scores "
            f"{score:.2e} lambda")


MULTI_K = 3             # M1's classes (glmnet's multinomial vignette)
MULTI_TRAITS = 4        # M2's and M3's traits
MULTI_TOL = 1e-10       # M2's and M3's coordinate descent tolerance
M4_DEEP_TOL = 1e-14     # M4's 20-lambda path on a 600 x 200 panel


def multinomial_labels(X, nz, seed, K=MULTI_K):
    """One-hot labels drawn from softmax(X B), B (p, K) zero but on the
    rows ``nz`` (the headline's 60 true nonzeros), N(0, 1.5^2 / 60)
    there, so each class's score has a standard deviation near 1.5."""
    import numpy as np

    rng = np.random.default_rng(seed)
    B = rng.standard_normal((len(nz), K)) * (1.5 / np.sqrt(len(nz)))
    E = X[:, nz].astype(np.float64) @ B
    P = np.exp(E - E.max(1, keepdims=True))
    P /= P.sum(1, keepdims=True)
    u = rng.uniform(size=(len(X), 1))
    labels = (P.cumsum(1) < u).sum(1).clip(max=K - 1)
    return np.eye(K, dtype=np.float32)[labels]


def multi_traits(io, seed, K=MULTI_TRAITS):
    """K traits from the panel's causal SNPs: Y = X_c B + noise, B
    (causal, K) N(0, 1) from ``seed``, the noise at half each trait's
    signal's standard deviation, float32."""
    import numpy as np

    from adelie_tpu_torch.matrix._snp import unpack_2bit_np

    rng = np.random.default_rng(seed)
    n = io.rows()
    cols = unpack_2bit_np(np.asarray(io.packed)[np.asarray(io.causal)],
                          n).astype(np.float32)
    B = rng.standard_normal((len(io.causal), K)).astype(np.float32)
    S = cols.T @ B
    noise = rng.standard_normal((n, K)).astype(np.float32)
    return (S + 0.5 * S.std(0) * noise).astype(np.float32)


def kron_hits(io, state):
    """The causal SNPs among the last lambda's nonzero groups."""
    K = state.n_classes
    hits = set((state.betas[-1].tocoo().col // K).tolist()) & set(io.causal)
    return f"{len(hits)}/{len(io.causal)}"


def multi_dense_phase(ad, card, tk, pg, X, nz):
    """M1: the multinomial headline.  The headline's X (n = 40,000, p =
    2,000, f32), K = 3 classes drawn from softmax(X B) on its 60 true
    nonzero rows, intercept, 100 lambdas to 1e-2, no early exit: a
    profiled warm-up and a timed fit (bit-equal; two timed fits before
    the covariance phases took their time); IRLS iterations per lambda,
    K1 and K6 launches, the KKT per lambda in float64.  Returns (launch counts of the first timed fit, its state:
    M0 reads its last screen)."""
    import numpy as np

    Xm = ad.matrix.dense(X, device="cuda")
    Y = multinomial_labels(X, nz, seed=31)
    glm = ad.glm.multinomial(Y)
    kw = dict(lmda_path_size=100, min_ratio=1e-2, early_exit=False,
              device="cuda")
    pg.reset_newton()
    st, walls, warm, counts, peak, prof = timed_fits(
        ad, Xm, glm, (tk.launches, pg.launches), reps=1, profiled=True,
        **kw)
    n, p = X.shape
    if (st.error or len(st.lmdas) != 100 or counts["pin_group_solve"] <= 0
            or st.intercepts.shape != (100, MULTI_K)):
        fail(f"multinomial headline: error {st.error!r}, {len(st.lmdas)} "
             f"lambdas, launches {counts}")
    kkt = multi_kkt("multinomial headline", dense_cols(X), n, p, st,
                    multi_resid("multinomial", Y))
    audit(ad, "multinomial (M1)", st)
    phase("multinomial", f"n={n} p={p} K={MULTI_K} f32, class shares "
          f"{np.round(Y.mean(0), 3).tolist()}, "
          + glm_cell_line("multinomial(Y), intercept", st, walls, warm,
                          counts, peak, multi_kkt_words(kkt),
                          "profiled warm-up")
          + f" | {card}")
    phase("multinomial", f"{irls_line(st)}; dev[-1] {st.devs[-1]:.4f}; "
          f"Newton (the three fits) {newton_line(pg.newton)} | {card}")
    phase("multinomial", f"the warm-up's {glm_profile_line(prof)} | {card}")
    return counts, st


def kron_block_phase(card, state):
    """M0: the Kronecker screen block at M1's last screen, under the IRLS
    weights of its last iteration, against the naive gather of the
    (n K, S_cap) block formed once as a yardstick: the Gram, the screen
    gradient and the residual update, their times and peaks, the largest
    gap relative to the Gram's largest entry (held at 1e-5 in float32);
    then the same in float64 at n = 2,000, p = 300, K = 3 on random
    class weights, held at 1e-12."""
    import numpy as np
    import torch
    from types import SimpleNamespace

    from adelie_tpu_torch.configs import matmul_precision
    from adelie_tpu_torch.solver.pin import screen_gram
    from adelie_tpu_torch.solver.state_core import (KroneckerScreenCache,
                                                    ScreenCache)

    def compare(kron, X_aug, w, gen):
        """(kron ms, naive ms, kron peak GiB, naive peak GiB, gaps)."""
        S_cap, S = kron.S_cap, kron.S_val
        cols = torch.as_tensor(kron.cols, device=DEV)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kms, (A, _) = host_ms(lambda: kron._gram(w, False))
        kpeak = (torch.cuda.max_memory_allocated() - base) / 2**30
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def naive():
            Xs = torch.zeros((X_aug.rows(), S_cap), dtype=w.dtype,
                             device=DEV)
            Xs[:, :S] = X_aug.gather(cols)
            return Xs, screen_gram(Xs, w, False)[0]
        nms, (Xs, A0) = host_ms(naive)
        npeak = (torch.cuda.max_memory_allocated() - base) / 2**30
        scale = float(A0.abs().max())
        gap_A = float((A - A0).abs().max()) / scale
        del A
        u = torch.randn(X_aug.rows(), dtype=w.dtype, device=DEV,
                        generator=gen) * w
        d = torch.zeros(S_cap, dtype=w.dtype, device=DEV)
        d[:S] = torch.randn(S, dtype=w.dtype, device=DEV, generator=gen)
        with matmul_precision():
            g0, g = u @ Xs, kron.screen_grad(u)
            r0, r = Xs @ d, kron.screen_apply(d)
        gap_g = float((g - g0).abs().max() / g0.abs().max())
        gap_r = float((r - r0).abs().max() / r0.abs().max())
        del Xs, A0
        torch.cuda.empty_cache()
        return kms, nms, kpeak, npeak, (gap_A, gap_g, gap_r)

    gen = torch.Generator(device=DEV).manual_seed(40)
    kron = state._cache
    w = kron._weights_ref
    if not isinstance(kron, KroneckerScreenCache) or kron.Xs is not None:
        fail("M1's screen cache is not the Kronecker block")
    kms, nms, kpeak, npeak, gaps = compare(kron, state.X, w, gen)
    phase("kron-block", f"M1's last screen: {kron.S_val} slots (S_cap "
          f"{kron.S_cap}), {len(kron.ccols)} child columns (capacity "
          f"{kron.Xc.shape[1]}), per-class Grams {tuple(kron.G.shape)}; "
          f"the Gram by class {kms:.1f} ms, peak {kpeak:.3f} GiB above its "
          f"inputs, against the naive (n K, S_cap) gather and Gram "
          f"{nms:.1f} ms, peak {npeak:.3f} GiB; largest gaps relative to "
          f"the largest entry: Gram {gaps[0]:.2e}, screen gradient "
          f"{gaps[1]:.2e}, residual update {gaps[2]:.2e} (f32, bar 1e-5) "
          f"| {card}")
    if max(gaps) > 1e-5:
        fail("the Kronecker screen block differs from the naive gather")
    # float64, random class weights: the screen of every column
    import adelie_tpu_torch as ad

    rng = np.random.default_rng(41)
    n, p, K = 2000, 300, 3
    X = rng.standard_normal((n, p))
    X_aug = ad.matrix.kronecker_eye(
        ad.matrix.concatenate([np.ones((n, 1)), X], device=DEV), K)
    groups = np.concatenate([np.arange(K), K + K * np.arange(0, p, 2)])
    sizes = np.diff(np.concatenate([groups, [(p + 1) * K]]))
    st = SimpleNamespace(
        X=X_aug, groups=groups, group_sizes=sizes,
        screen_set=np.arange(len(groups)), penalty=np.ones(len(groups)),
        n=n * K, dtype=np.dtype("f8"), torch_dtype=torch.float64,
        device=torch.device(DEV))
    w = torch.as_tensor(rng.uniform(0.5, 1.5, n * K), device=DEV)
    w /= w.sum()
    k64, naive = KroneckerScreenCache(K), ScreenCache()
    # half the groups, then the rest appended: the extension's cross
    # blocks by class
    for step, ss in enumerate((np.arange(len(groups) // 2),
                               np.arange(len(groups)))):
        st.screen_set = ss
        for c in (k64, naive):
            c.rebuild_structure(st)
            if step and c._pending_ext is None:
                fail("the float64 screen block did not extend")
            c.rebuild_weighted(w, False)
    gap64 = float((k64.A - naive.A).abs().max() / naive.A.abs().max())
    _, _, _, _, gaps64 = compare(k64, X_aug, w, gen)
    phase("kron-block", f"float64, n={n} p={p} K={K}, groups of 2, class "
          f"weights at random: Gram gap {gap64:.2e} extended, "
          f"{gaps64[0]:.2e} formed, screen gradient {gaps64[1]:.2e}, "
          f"residual update {gaps64[2]:.2e} (bar 1e-12)")
    if max(gap64, *gaps64) > 1e-12:
        fail("the Kronecker screen block differs from the naive gather in "
             "float64")


def multi_gwas_phase(ad, card, tk, pg, sk, Xm, io):
    """M2: the multi-trait GWAS in device memory: phase 9's panel, K = 4
    traits from its 40 causal SNPs, a multigaussian path of 50 lambdas to
    5e-2, intercept, early exit, ``tol`` 1e-10 (at the default 1e-7 the
    slow coordinate descent of the intercepts beside the panel's
    uncentered columns leaves intercept scores near 1e-2 lambda): a
    profiled warm-up and two timed fits (bit-equal), K3's launches (K a
    gradient) and device ms a launch beside its bound, the KKT per lambda
    in float64.  Returns the launch counts of the first timed fit."""
    Y = multi_traits(io, seed=32)
    glm = ad.glm.multigaussian(Y)
    kw = dict(lmda_path_size=50, min_ratio=5e-2, tol=MULTI_TOL,
              device="cuda")
    st, walls, warm, counts, peak, prof = timed_fits(
        ad, Xm, glm, (tk.launches, pg.launches, sk.launches), reps=2,
        profiled=True, **kw)
    if (st.error or counts["snp_mul"] <= 0 or counts["pin_group_solve"] <= 0
            or counts["snp_mul"] % MULTI_TRAITS):
        fail(f"multi-trait GWAS: error {st.error!r}, launches {counts}: "
             f"K3 {MULTI_TRAITS} times a gradient")
    n, p = Xm.shape
    kkt = multi_kkt("multi-trait GWAS", snp_cols(io), n, p, st,
                    multi_resid("multigaussian", Y))
    k3 = [(c, ms) for name, (c, ms) in (prof[2] if prof else {}).items()
          if "snp_mul_kernel" in name]
    k3_n, k3_ms = sum(c for c, _ in k3), sum(ms for _, ms in k3)
    b_ms, b_by = snp_bound(p, n, True)
    k3_words = (f"K3 in the profiled warm-up {k3_ms:.1f} ms in {k3_n} "
                f"launches, {k3_ms / k3_n:.3f} ms a launch against a bound "
                f"of {b_ms:.3f} ms ({b_by})" if k3_n else
                "K3's device time not measured")
    phase("gwas-multi", f"n={n} p={p} K={MULTI_TRAITS} f32, "
          + glm_cell_line(f"multigaussian(Y), intercept, early exit, tol "
                          f"{MULTI_TOL:g}", st, walls, warm, counts, peak,
                          multi_kkt_words(kkt), "profiled warm-up")
          + f", K3 launches {counts['snp_mul']} ("
          f"{counts['snp_mul'] / MULTI_TRAITS:.0f} gradients, "
          f"{counts['snp_mul'] / MULTI_TRAITS / len(st.lmdas):.2f} a "
          f"lambda), causal hits {kron_hits(io, st)}, devs[-1] "
          f"{st.devs[-1]:.4f} | {card}")
    phase("gwas-multi", f"{k3_words}; the warm-up's "
          f"{glm_profile_line(prof)} | {card}")
    return counts


def multi_north_star_phase(ad, card, tk, pg, sk, Xm, io, copy_s):
    """M3: the streamed multi-trait north star: phase 14's panel in host
    memory, K = 4 traits from its 60 causal SNPs, a multigaussian path of
    50 lambdas to 5e-2, ``tol`` 1e-10 (as M2), f32: a profiled warm-up
    and one timed fit, the
    passes, K5's launches at each width C K, its time at those widths on
    the first tile against a tile's copy (``copy_s``: phase 14's
    copy-only pass), the KKT per lambda from one plain float64 pass.
    Returns the launch counts of the timed fit."""
    import numpy as np
    import torch

    Y = multi_traits(io, seed=33)
    glm = ad.glm.multigaussian(Y)
    kw = dict(lmda_path_size=50, min_ratio=5e-2, tol=MULTI_TOL,
              device="cuda")
    prof = profile_fit(ad, Xm, None, glm, **kw)
    widths = {}
    many = sk.snp_mul_many

    def counted(tile, U, *a, **k):
        widths[U.shape[0]] = widths.get(U.shape[0], 0) + 1
        return many(tile, U, *a, **k)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(tk.launches, pg.launches, sk.launches)
    sweeps0 = Xm.sweeps
    sk.snp_mul_many = counted
    try:
        wall, st = fit(ad, Xm, None, glm, **kw)
    finally:
        sk.snp_mul_many = many
    counts = {**tk.launches, **pg.launches, **sk.launches}
    sweeps = Xm.sweeps - sweeps0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if (st.error or len(st.lmdas) < 2 or counts["snp_mul_many"] <= 0
            or counts["snp_mul"] != 0 or counts["pin_group_solve"] <= 0
            or sum(widths.values())
            != counts["snp_mul_many"]):
        fail(f"streamed multi-trait: error {st.error!r}, launches {counts}, "
             f"K5 by width {widths}: K5 must carry every pass, K3 none")
    t0 = time.perf_counter()
    n, p = io.rows(), io.snps()
    kkt = multi_kkt("streamed multi-trait", snp_cols(io), n, p, st,
                    multi_resid("multigaussian", Y), block=4096)
    kkt_s = time.perf_counter() - t0
    phase("north-star-multi", f"n={n} p={p} K={MULTI_TRAITS} f32 streamed,"
          f" multigaussian(Y), intercept, 50 lambdas to 5e-2, tol "
          f"{MULTI_TOL:g}: "
          f"{len(st.lmdas)} lambdas, wall {wall:.3f} s (profiled warm-up "
          f"{float('nan') if prof is None else prof[0]:.3f} s), X.sweeps "
          f"{sweeps}, streamed KKT passes {len(st.benchmark['kkt'])} "
          f"({sum(st.benchmark['kkt']):.3f} s), K5 launches by width C K "
          f"{dict(sorted(widths.items()))}, launches {counts}, peak screen "
          f"{int(max(st.screen_sizes))} groups, causal hits "
          f"{kron_hits(io, st)}, devs[-1] {st.devs[-1]:.4f}, "
          f"{multi_kkt_words(kkt)} (one plain f64 pass, {kkt_s:.1f} s), "
          f"peak device memory {peak:.2f} GiB | {card}")
    phase("north-star-multi", f"the warm-up's {profile_line(prof)}; "
          f"{chunk_pass_line(prof, sweeps)} | {card}")
    tile = Xm._host[:NS_TILE].to(DEV)
    per_tile = copy_s * 1e3 / Xm._ntiles
    t = many_timing(tile, n, tuple(sorted(widths)), Xm._impute[:NS_TILE],
                    seed=340)
    for C, r in t.items():
        sets = "K5" if r["ms"] > per_tile else "the tile's copy"
        phase("K5", f"north-star tile 0 at C K = {C} (streamed "
              f"multi-trait, {widths[C]} launches): kernel {r['ms']:.3f} ms "
              f"against a tile's copy {per_tile:.3f} ms (phase 14's "
              f"copy-only pass over {Xm._ntiles} tiles): {sets} sets the "
              f"pass; bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
              f"torch.matmul on the decoded tile {r['library_ms']:.3f} ms "
              f"| {card}")
    del tile
    return counts


def multi_stream_vs_hbm_phase(ad, card, io11,
                              deep=("multigaussian",)):
    """M4: a multigaussian of K = 4 traits and a multinomial of K = 3
    classes from ``data.snp_unphased``, fitted on the card in device
    memory and streamed (the speculative union off, which keeps the
    in-device screens): lambda within 1e-10 relative, beta and the
    intercepts within 1e-6.  On two panels with 10 % NA: phase 11's
    snpdat panel (n = 2,000, p = 1,500; tiles of 256 SNPs, a ragged last
    one), the first 5 lambdas to 0.3 lambda_max at ``tol`` 1e-16; and, for
    the families in ``deep``, a 600 x 200 panel, 20 lambdas to 1e-2 at
    ``tol`` M4_DEEP_TOL (tiles of 64).  ``irls_tol`` is 1e-12 on both.
    The multinomial's deep path is left out by default: at ``irls_tol``
    1e-12 its IRLS takes 954 iterations over the 20 lambdas, 110 s in
    device memory and 204 s streamed on an H100.  The flattened problem's
    intercepts are coordinates beside the panel's uncentered columns, so
    coordinate descent converges slowly and its stopping rule
    (A_kk dbeta^2 < tol) leaves two drivers' paths apart by what the rule
    lets through: at the default tol the JAX package's own in-device and
    streamed multigaussian part by 1.8e-3 in beta on the 600 x 200 panel,
    as the port's do (``tools/multi_driver_gap.py``).  Each fit's wall is
    printed."""
    import numpy as np

    from adelie_tpu_torch import _build
    from adelie_tpu_torch.configs import set_configs

    f = _build.BUILD_DIR / "chip_smoke_m4.snpdat"
    f.parent.mkdir(parents=True, exist_ok=True)
    panels = (("snpdat", 2000, 1500, 256, dict(lmda_path_size=5,
                                                min_ratio=0.3, tol=1e-16)),
              ("600x200", 600, 200, 64, dict(lmda_path_size=20,
                                              tol=M4_DEEP_TOL)))
    for name, n, p, tile, path in panels:
        for family, K in (("multigaussian", 4), ("multinomial", 3)):
            if name != "snpdat" and family not in deep:
                continue
            d = ad.data.snp_unphased(n, p, K=K, glm=family,
                                     missing_ratio=0.1, seed=11)
            if name == "snpdat":
                io = io11
            else:
                ad.io.snp_unphased(str(f)).write(d["X"])
                io = ad.io.snp_unphased(str(f)).read()
                f.unlink()
            kw = dict(path, irls_tol=1e-12)
            hbm_s, hbm = fit(ad, ad.matrix.snp_unphased(io, device="cuda"),
                             None, d["glm"], **kw)
            set_configs("stream_speculative_union", False)
            try:
                Xs = ad.matrix.snp_unphased(io, streaming=True,
                                            tile_snps=tile, dtype=np.float64,
                                            device="cuda")
                strm_s, strm = fit(ad, Xs, None, d["glm"], **kw)
            finally:
                set_configs("stream_speculative_union")
            what = f"{family} {name}"
            if (hbm.error or strm.error
                    or len(hbm.lmdas) != len(strm.lmdas)):
                fail(f"{what} streamed vs in-HBM: errors {hbm.error!r} "
                     f"{strm.error!r}, {len(hbm.lmdas)} vs "
                     f"{len(strm.lmdas)} lambdas")
            lm_d = float(np.max(np.abs(strm.lmdas / hbm.lmdas - 1)))
            b_d = float(np.max(np.abs(strm.betas.toarray()
                                      - hbm.betas.toarray())))
            i_d = float(np.max(np.abs(strm.intercepts - hbm.intercepts)))
            phase("stream-vs-hbm-multi", f"{family} K={K} {name} f64 (n={n}"
                  f" p={p}, {path['lmda_path_size']} lambdas to "
                  f"{path.get('min_ratio', 1e-2):g}, tol {path['tol']:g}): "
                  f"peak screen {max(hbm.screen_sizes)} groups, "
                  f"{len(hbm.lmdas)} lambdas, CD sweeps "
                  f"{sum(hbm.benchmark['cd_iters'])}, IRLS iterations "
                  f"{sum(hbm.benchmark['irls_iters'])}, max lambda rel diff "
                  f"{lm_d:.1e}, max beta diff {b_d:.3e}, max intercept diff "
                  f"{i_d:.3e} (bars 1e-10, 1e-6), X.sweeps {Xs.sweeps}; "
                  f"walls {hbm_s:.2f} s in device memory, {strm_s:.2f} s "
                  f"streamed | {card}")
            if lm_d > 1e-10 or b_d > 1e-6 or i_d > 1e-6:
                fail(f"{what} streamed vs in-HBM: past the bars")


def multi_cuda_vs_cpu_phase(ad, tk, pg):
    """M5: ``data.dense(2000, 300, 60, K=...)`` in float64 on "cuda" and
    on "cpu" (the kernels' twins): a multinomial of K = 3 classes (10
    lambdas: the CPU twin of K6 is slow) and a multigaussian of K = 4
    traits (30 lambdas); lambda, beta and the intercepts within 1e-8."""
    import numpy as np

    for family, K, L in (("multinomial", 3, 10), ("multigaussian", 4, 30)):
        d = ad.data.dense(2000, 300, 60, K=K, glm=family, seed=17)
        kw = dict(lmda_path_size=L)
        zero_counts(tk.launches, pg.launches)
        s_gpu = ad.grpnet(d["X"], d["glm"], device="cuda", **kw)
        counts = {**tk.launches, **pg.launches}
        t0 = time.perf_counter()
        s_cpu = ad.grpnet(d["X"], d["glm"], device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        if s_gpu.error or s_cpu.error or len(s_gpu.lmdas) != len(s_cpu.lmdas):
            fail(f"{family} cuda vs cpu: errors {s_gpu.error!r} "
                 f"{s_cpu.error!r}, {len(s_gpu.lmdas)} vs "
                 f"{len(s_cpu.lmdas)} lambdas")
        lm_err = float(np.max(np.abs(s_gpu.lmdas / s_cpu.lmdas - 1)))
        b_err = float(np.max(np.abs(s_gpu.betas.toarray()
                                    - s_cpu.betas.toarray())))
        i_err = float(np.max(np.abs(s_gpu.intercepts - s_cpu.intercepts)))
        phase("multi-cuda-vs-cpu", f"{family} K={K}: data.dense(2000, 300, "
              f"60) f64, {L} lambdas: launches {counts}, max lambda rel diff "
              f"{lm_err:.1e}, max beta diff {b_err:.3e}, max intercept diff "
              f"{i_err:.3e} (bars 1e-8; the CPU fit {cpu_s:.1f} s)")
        if counts["pin_group_solve"] <= 0 or max(lm_err, b_err, i_err) > 1e-8:
            fail(f"the card's {family} fit differs from the CPU path")


# --------------------------------------------------------------------------- #
# the covariance method and the standalone solvers: K7, C1-C4, A1-A4          #
# --------------------------------------------------------------------------- #


def k7_problem(S, dtype, mode, seed, case="cold"):
    """A screened problem for K7 on the card: Q = Z^T Z / n with n = 4 S
    (eigenvalues in about [0.25, 2.25]), its upper triangle moved by a
    relative 1e-7 so that Q is not symmetric (a kernel that read rows for
    columns would part from the twin), the last three slots invalid and
    slot 6's diagonal 0.  ``mode`` "box": bounds -U(0, 0.5) and U(0, 0.5),
    every 13th lower bound 0 and every 11th upper bound 1e100; "pinball":
    penalties U(0.5, 1.5) 0.05 max |grad|.  ``case``: "cold" (beta 0,
    nothing active); "warm" (every seventh slot invalid as well, 30 % of the
    valid slots given small coefficients inside the bounds and active, the
    gradient moved to match); "dense" (warm with 85 % of the valid slots
    active: an active list too long for the compact vectors and a ring in
    shared memory at S = 8192 in float64); "floor" (box bounds 0 and 0 at
    beta 0: every update clips to 0, so no delta is nonzero: the chain
    with no AXPY); "tail" (cold, box, the last quarter of the slots with
    equal bounds 0.02: each moves once in the full sweep, is listed, and
    never moves again, so every active sweep ends on a stretch of listed
    updates that do not move).
    Returns ``screened_cd_solve``'s arguments with ``Q`` the transpose of a
    contiguous tensor (the layout K7 reads, so no copy is timed)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    n = 4 * S
    Z = torch.randn((n, S), generator=gen, dtype=torch.float64, device=DEV)
    b_true = torch.where(torch.rand(S, generator=gen, dtype=torch.float64,
                                    device=DEV) < 0.2,
                         torch.randn(S, generator=gen, dtype=torch.float64,
                                     device=DEV), 0.0)
    y = Z @ b_true + 0.5 * torch.randn(n, generator=gen, dtype=torch.float64,
                                       device=DEV)
    Q = Z.T @ Z / n
    g = Z.T @ y / n
    del Z, y
    Q += torch.triu(Q * 1e-7 * torch.randn((S, S), generator=gen,
                                           dtype=torch.float64, device=DEV),
                    1)
    valid = np.ones(S, bool)
    valid[-3:] = False
    diag = torch.diagonal(Q).clone()
    diag[6] = 0.0
    if mode == "box":
        lo = -rng.uniform(0.0, 0.5, S)
        hi = rng.uniform(0.0, 0.5, S)
        lo[::13] = 0.0
        hi[::11] = 1e100
    else:
        scale = 0.05 * float(g.abs().max())
        lo = scale * rng.uniform(0.5, 1.5, S)
        hi = scale * rng.uniform(0.5, 1.5, S)
    beta0 = np.zeros(S)
    if case in ("warm", "dense"):
        valid[5::7] = False
        b = 0.05 * rng.standard_normal(S)
        if mode == "box":
            b = np.clip(b, lo, hi)
        share = 0.85 if case == "dense" else 0.3
        beta0 = np.where(valid & (rng.random(S) < share), b, 0.0)
        g = g - Q @ torch.as_tensor(beta0, device=DEV)
    elif case == "floor":
        lo = np.zeros(S)
        hi = np.zeros(S)
    elif case == "tail":
        lo[S - S // 4:] = 0.02
        hi[S - S // 4:] = 0.02
    dev = dict(device=DEV)
    Qt = Q.to(dtype).T.contiguous()
    return (Qt.T, diag.to(dtype), torch.as_tensor(beta0, dtype=dtype, **dev),
            g.to(dtype), torch.as_tensor(lo, dtype=dtype, **dev),
            torch.as_tensor(hi, dtype=dtype, **dev),
            torch.as_tensor(valid, **dev),
            torch.as_tensor(beta0 != 0, **dev), 0.5, 1e-9, 100000, 0, mode)


def k7_bound(S, S_val, itemsize, moves, rows, updates):
    """K7's bound: the valid part (S_val values) of each distinct column of
    Q that moved read once (``rows``, counted by the twin), the vectors
    in (diag, beta, grad, lo, hi; two flag arrays) and out (beta, grad;
    the flags); an AXPY over the S_val valid slots a moving update."""
    return bound(rows * S_val * itemsize + 7 * S * itemsize + 3 * S + 48,
                 2 * S_val * moves + 10 * updates)


def k7_same(what, out_k, out_t):
    """K7's results against the twin's: beta, grad and flags bit-equal,
    info (loss, iters, converged, moves, updates) equal."""
    for name, x, y in zip(("beta", "grad", "active"), out_k[:3], out_t[:3]):
        if not same_bits(x.cpu(), y):
            err = float((x.cpu().double() - y.double()).abs().max()) \
                if x.dtype.is_floating_point else -1.0
            fail(f"{what}: {name} differs from the twin (max |diff| "
                 f"{err:.3e})")
    if out_k[3].tolist() != out_t[3].tolist():
        fail(f"{what}: info {out_k[3].tolist()} against the twin's "
             f"{out_t[3].tolist()}")


def k7_timed(run):
    """``run()`` with every K7 launch timed by CUDA events.  Returns (its
    result, device ms by step: full, gather, active, replay, launches by
    step, K7's segment counts)."""
    import torch

    from adelie_tpu_torch.solver import screened_cd_kernels as kc

    zero_counts(kc.segments)
    kc.timing = []
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        events, kc.timing = kc.timing, None
    ms, n = {}, {}
    for step, start, end in events:
        ms[step] = ms.get(step, 0.0) + start.elapsed_time(end)
        n[step] = n.get(step, 0) + 1
    return out, ms, n, dict(kc.segments)


def k7_case(S, dtype, mode, seed, case="cold", reps=5, **kw):
    """K7 against its twin on the CPU on copies of the same inputs, and
    K7's time (CUDA events) beside the twin's, the Gram's transposition
    and the bound; one more fit with its launches timed gives each step's
    device time, the rounds (a segment each) and the longest active list.
    The fits are ``KernelSteps`` driven by ``run_kernel_fit``, as
    ``screened_cd_solve`` drives them; ``kw`` (``log_sweeps``, ``layout``,
    ``ring``) goes to ``KernelSteps``."""
    import numpy as np
    import torch

    from adelie_tpu_torch.solver import screened_cd_kernels as kc

    what = f"K7 {mode} S={S} {dtype} {case}"
    args = k7_problem(S, dtype, mode, seed, case)

    def run():
        return kc.run_kernel_fit(kc.KernelSteps(*args, **kw))

    ms = cuda_ms(run, reps=reps)
    t_ms = cuda_ms(lambda: args[0].contiguous(), reps=reps)
    out_k, step_ms, step_n, seg = k7_timed(run)
    cpu = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
    t0 = time.perf_counter()
    moved = np.zeros(S, bool)
    out_t = kc.screened_cd_solve_ref(*cpu, moved=moved)
    plain_ms = (time.perf_counter() - t0) * 1e3
    k7_same(what, out_k, out_t)
    loss, iters, done, moves, updates = out_k[3].tolist()
    rows = int(moved.sum())
    if case != "floor" and (done != 1.0 or moves <= 0):
        fail(f"{what}: not converged ({iters} sweeps, {moves} moves)")
    if case == "floor" and moves != 0:
        fail(f"{what}: {moves} moves on the floor problem")
    itemsize = torch.empty((), dtype=dtype).element_size()
    S_val = int(args[6].sum())
    b_ms, b_by = k7_bound(S, S_val, itemsize, moves, rows, updates)
    lay, depth = kc.active_layout(seg["na_max"], S, dtype)
    if kw.get("layout", -1) >= 0:
        lay = min(lay, kw["layout"])
    if kw.get("ring", 0) > 0:
        depth = min(depth, kw["ring"])
    return dict(S=S, dtype=str(dtype), mode=mode, case=case, ms=ms,
                plain_ms=plain_ms, transpose_ms=t_ms, iters=int(iters),
                moves=int(moves), updates=int(updates), rows=int(rows),
                S_val=S_val,
                us_per_update=ms * 1e3 / max(updates, 1),
                us_per_move=ms * 1e3 / max(moves, 1), bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0,
                log_sweeps=kw.get("log_sweeps"), rounds=seg["rounds"],
                reads=seg["reads"], na_max=seg["na_max"],
                layout=lay, depth=depth if lay else 0, step_ms=step_ms,
                step_n=step_n, listed_updates=seg["listed_updates"],
                listed_moves=seg["listed_moves"],
                us_per_listed_move=(step_ms.get("active", 0.0) * 1e3
                                    / max(seg["listed_moves"], 1)))


K7_LAYOUTS = {2: "vectors and ring in shared memory", 1: "ring only",
              0: "rows and vectors in global memory"}


def k7_words(r):
    """A K7 case's segments, layout and step times."""
    ms = r["step_ms"]
    return (f"{r['rounds']} rounds (log of "
            f"{r['log_sweeps'] or 'as many'} sweeps), {r['reads']} host "
            f"reads, longest list "
            f"{r['na_max']} ({K7_LAYOUTS[r['layout']]}"
            f"{', ring of %d rows' % r['depth'] if r['layout'] else ''}); "
            f"device ms: full sweeps {ms.get('full', 0.0):.3f}, gather "
            f"{ms.get('gather', 0.0):.3f}, active {ms.get('active', 0.0):.3f}"
            f" ({r['us_per_listed_move']:.3f} us a listed move, "
            f"{r['listed_moves']} of {r['listed_updates']} listed updates),"
            f" replay {ms.get('replay', 0.0):.3f}")


class K7Lockstep:
    """``run_segments``'s steps for one ``KernelSteps`` on the card and one
    ``PlainSteps`` on CPU copies of the same inputs together: each step
    runs on both (the kernel timed by CUDA events, with the card kept busy
    while the host launches, so that the events time the kernel alone),
    then the state and what the step wrote are compared bit for bit (the
    full sweep: the vectors, flags and lists; the gather: the compact
    block; an active segment: the vectors, flags and log; the replay:
    grad).  ``times`` by step: [kernel ms, stand-in ms, launches];
    ``work``: the gather's and the replay's bytes and operations, and the
    last replay's list, other slots and log."""

    compared = {"full": ("beta", "grad", "active", "list", "rest"),
                "gather": ("Qc",),
                "active": ("beta", "grad", "active", "log"),
                "replay": ("grad",)}

    def __init__(self, what, ks, ps, elem):
        self.what, self.ks, self.ps, self.elem = what, ks, ps, elem
        self.state0 = ks.state0
        self.times = {step: [0.0, 0.0, 0] for step in self.compared}
        self.work = {"gather_bytes": 0, "replay_bytes": 0, "replay_ops": 0}

    def _step(self, step, *arg):
        import numpy as np
        import torch

        from adelie_tpu_torch.solver import screened_cd_kernels as kc

        ks, ps, what = self.ks, self.ps, self.what
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        getattr(torch.cuda, "_sleep", lambda cycles: None)(1 << 20)
        start.record()
        getattr(ks, step)(*arg)
        end.record()
        t0 = time.perf_counter()
        getattr(ps, step)(*arg)
        plain = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t = self.times[step]
        t[0] += start.elapsed_time(end)
        t[1] += plain
        t[2] += 1
        a, b = ks.snapshot(), ps.snapshot()
        if a["state"].tobytes() != b["state"].tobytes():
            fail(f"{what}: the state after the {step} step "
                 f"{a['state'].tolist()} against the stand-in's "
                 f"{b['state'].tolist()}")
        for key in self.compared[step]:
            if key in b and (a[key].dtype != b[key].dtype
                             or a[key].shape != b[key].shape
                             or a[key].tobytes() != b[key].tobytes()):
                fail(f"{what}: {key} after the {step} step differs from "
                     f"the stand-in's")
        na, nr = int(b["state"][kc.NA]), int(b["state"][kc.NR])
        elem, work = self.elem, self.work
        if step == "gather":
            work["gather_bytes"] += 2 * na * na * elem + 4 * na
        if step == "replay":
            logged = b["log"]
            work["replay_bytes"] += (na * nr + len(logged)
                                     + 2 * nr) * elem + 4 * (na + nr)
            work["replay_ops"] += 2 * int(np.count_nonzero(logged)) * nr
            work.update(list=b["list"], rest=b["rest"], log=logged)

    def full(self):
        self._step("full")

    def gather(self, na):
        self._step("gather", na)

    def active(self):
        self._step("active")

    def replay(self):
        self._step("replay")

    def read(self):
        state = self.ks.read()
        if state != self.ps.read():
            fail(f"{self.what}: the states read differ")
        return state


def k7_lockstep(what, args, **kw):
    """K7's kernels against their plain stand-ins step by step
    (``K7Lockstep``), driven by ``run_segments`` as a fit on the card is,
    and the result against the twin.  ``kw`` goes to both steps'
    constructors (``layout`` and ``ring`` to ``KernelSteps`` only).
    Returns the lockstep (its ``times`` and ``work``) and
    ``run_segments``'s counts."""
    import torch

    from adelie_tpu_torch.solver import screened_cd_kernels as kc

    plain_kw = {k: v for k, v in kw.items() if k == "log_sweeps"}
    lock = K7Lockstep(what, kc.KernelSteps(*args, **kw),
                      kc.PlainSteps(*[a.cpu() if torch.is_tensor(a) else a
                                      for a in args], **plain_kw),
                      args[0].element_size())
    state, n = kc.run_segments(lock, args[10])
    twin = kc.screened_cd_solve_ref(*[a.cpu() if torch.is_tensor(a) else a
                                      for a in args])
    k7_same(what, lock.ks.result(state), twin)
    return lock, n


def k7_phase(card):
    """K7 bit-equal to its twin in 32 cases (float32 and float64, box and
    pinball, S in {64, 1000, 2048, 8192}, cold and warm), the floor (every
    delta 0) in float32 at S = 1000 and 8192, then cases that force
    segments (a log of one sweep at S = 2048 in float64, box and pinball),
    a list too long for the compact vectors and a ring in shared memory (S
    = 8192 float64, dense warm start), the two smaller layouts forced
    at S = 2048 float64 warm, and a ring of two rows forced on the "tail"
    problem, whose every active sweep ends on a stretch of listed updates
    that do not move (float64 with a log of one sweep, so that every
    segment ends there; float32 with the whole phase a segment); and K7's
    kernels against their stand-ins step by step on one segmented problem
    and on the tail problem with a ring of two rows.  Returns the
    cases."""
    import torch

    from adelie_tpu_torch import _build

    lib = _build.load()
    out = []
    t0 = time.perf_counter()

    def line(r, extra=""):
        phase("K7", f"{r['mode']} S={r['S']} {r['dtype']} {r['case']}{extra}"
              f"{'' if r['in_smem'] else ' (full sweeps in global memory)'}"
              f": bit-equal to the twin, {r['iters']} sweeps, "
              f"{r['moves']} moves ({r['rows']} distinct "
              f"slots of {r['S_val']} valid) of {r['updates']} "
              f"updates; "
              f"{r['ms']:.3f} ms ({r['us_per_update']:.3f} us an "
              f"update, {r['us_per_move']:.3f} a move; the twin "
              f"{r['plain_ms']:.0f} ms), bound {r['bound_ms']:.4f}"
              f" ms ({r['bound_by']}), Q's transposition "
              f"{r['transpose_ms']:.3f} ms; {k7_words(r)} | {card}")

    def case(S, dtype, mode, seed, kind, reps, **kw):
        r = k7_case(S, dtype, mode, seed=seed, case=kind, reps=reps, **kw)
        r["in_smem"] = lib.adelie_screened_cd_in_smem(
            S, torch.empty((), dtype=dtype).element_size())
        out.append(r)
        return r

    for dtype in (torch.float32, torch.float64):
        for mode in ("box", "pinball"):
            for S in (64, 1000, 2048, 8192):
                for kind in ("cold", "warm"):
                    line(case(S, dtype, mode, S + len(out), kind,
                              3 if S >= 2048 else 10))
    floor = {}
    for S in (1000, 8192):
        r = case(S, torch.float32, "box", 5, "floor", 10)
        floor[S] = r["us_per_update"]
        phase("K7", f"floor S={S} float32: {r['updates']} updates, none "
              f"moving, {r['ms']:.4f} ms ({r['us_per_update']:.4f} us an "
              f"update) | {card}")
    # segments: every active sweep a segment, its replay and a host read
    for mode in ("box", "pinball"):
        r = case(2048, torch.float64, mode, 17, "cold", 3, log_sweeps=1)
        line(r, f" (log of one sweep; floor {floor[1000]:.4f} us an "
                f"update)")
        if r["rounds"] < r["iters"] // 2:
            fail(f"K7 {mode} S=2048 log of one sweep: {r['rounds']} rounds "
                 f"for {r['iters']} sweeps")
    r = case(8192, torch.float64, "box", 19, "dense", 3)
    line(r, f" (floor {floor[8192]:.4f} us an update)")
    if r["layout"] == 2:
        fail(f"K7 S=8192 float64 dense: a list of {r['na_max']} kept its "
             f"vectors in shared memory")
    for layout in (1, 0):
        r = case(2048, torch.float64, "box", 23 + layout, "warm", 3,
                 log_sweeps=2, layout=layout)
        line(r, f" (layout forced to {layout}, log of two sweeps)")
        if r["layout"] != layout:
            fail(f"K7 layout {layout} forced, {r['layout']} run")
    # a ring of two rows, every sweep ending on listed updates that do not
    # move: the producer may trail the chain there, and must still issue
    # every row the segment's consumers wait for
    for dtype, kw in ((torch.float64, dict(log_sweeps=1)),
                      (torch.float32, {})):
        r = case(2048, dtype, "box", 31, "tail", 3, ring=2, **kw)
        line(r, " (a ring of two rows forced)")
        if r["layout"] == 0 or r["depth"] != 2:
            fail(f"K7 tail {dtype}: layout {r['layout']}, a ring of "
                 f"{r['depth']} rows, not two")
    phase("K7", f"{len(out)} cases bit-equal in {time.perf_counter() - t0:.1f}"
          f" s | {card}")
    for kind, mode, seed, kw in (("warm", "pinball", 29, {}),
                                 ("tail", "box", 37, dict(ring=2))):
        args = k7_problem(2048, torch.float64, mode, seed, kind)
        what = f"steps, {mode} S=2048 float64 {kind}, a log of one sweep"
        lock, n = k7_lockstep(f"K7 {what}", args, log_sweeps=1, **kw)
        phase("K7", f"{what}{', a ring of two rows' if kw else ''}: the "
              "full sweep, gather, active segment and replay kernels "
              "bit-equal to their stand-ins after every step; "
              + ", ".join(f"{k} {v[2]} launches ({n[k]} with work) "
                          f"{v[0]:.3f} ms (stand-in {v[1]:.1f} ms)"
                          for k, v in lock.times.items())
              + f", {n['reads']} host reads | {card}")
    return out


def k7_kept(run):
    """``run()`` with every K7 call of ``screened_cd_fit`` kept: a copy of
    its inputs on the CPU and its results.  Returns (run's result,
    calls)."""
    import torch

    from adelie_tpu_torch.solver import screened_cd_kernels as kc

    inner = kc.screened_cd_solve
    calls = []

    def kept(*args):
        held = [a.cpu() if torch.is_tensor(a) else a for a in args]
        out = inner(*args)
        calls.append((held, [o.cpu() for o in out]))
        return out

    kc.screened_cd_solve = kept
    try:
        return run(), calls
    finally:
        kc.screened_cd_solve = inner


def k7_replay(what, calls):
    """Each kept K7 call through the twin on the CPU, bit-equal to the
    kernel.  Returns one (S, twin ms, info, distinct slots moved) a
    call."""
    import numpy as np

    from adelie_tpu_torch.solver import screened_cd_kernels as kc

    out = []
    for i, (args, res) in enumerate(calls):
        moved = np.zeros(args[0].shape[0], bool)
        t0 = time.perf_counter()
        twin = kc.screened_cd_solve_ref(*args, moved=moved)
        ms = (time.perf_counter() - t0) * 1e3
        k7_same(f"{what}: K7 call {i} (S={args[0].shape[0]})", res, twin)
        out.append((args[0].shape[0], ms, res[3].tolist(), int(moved.sum())))
    return out


def same_path(a, b):
    """Two path states with bit-equal lambdas and coefficients."""
    import numpy as np

    return (np.array_equal(a.lmdas, b.lmdas)
            and np.array_equal(a.betas.toarray(), b.betas.toarray()))


def cov_kkt(what, A64, v64, state, groups, sizes, penalty):
    """The covariance method's group KKT per lambda in float64 on the card:
    the gradient v - A beta (``group_kkt_parts``); zero groups held at
    1e-2 lambda, nonzero groups reported.  Returns (zero, nonzero)."""
    import torch

    B = torch.as_tensor(state.betas.toarray(), device=DEV).double()
    G = v64[None, :] - B @ A64
    v0, v1 = group_kkt_parts(G, B, state.lmdas, groups, sizes, penalty, 1.0)
    zero, nonzero = float(v0.max()), float(v1.max())
    if not zero <= 1e-2:
        fail(f"{what}: zero-group KKT violation {zero:.3e} lambda")
    return zero, nonzero


def cov_cell(ad, what, A, v, counters, runs=3, **kw):
    """A warm-up and ``runs`` timed ``gaussian_cov`` fits: (walls, the
    first timed state, its launches, the warm-up's wall); the first two
    timed fits must be bit-equal."""
    warm, _ = timed(lambda: ad.gaussian_cov(A, v, **kw))
    zero_counts(*counters)
    walls, states, counts = [], [], None
    for i in range(runs):
        wall, st = timed(lambda: ad.gaussian_cov(A, v, **kw))
        if i == 0:
            counts = {k: c[k] for c in counters for k in c}
        if st.error != "":
            fail(f"{what}: error {st.error!r}")
        walls.append(wall)
        states.append(st)
    if runs > 1 and not same_path(states[0], states[1]):
        fail(f"{what}: two timed fits differ (beta or lambdas)")
    return walls, states[0], counts, warm


def walls_words(walls, warm):
    import numpy as np

    return (f"wall median {np.median(walls):.3f} s of {len(walls)} "
            f"({min(walls):.3f}-{max(walls):.3f}; warm-up {warm:.3f} s)")


def cov_dense_phase(ad, card, tk, pg, X, y, ref):
    """C1-C3 on phase 5's X and y: A = X^T X / n and v = X^T y / n formed
    on the card (``eager_cov``), 100 lambdas to 1e-2 with no early exit
    (phase 5's path).  C1: A dense, chunked, K1 (a warm-up, three timed
    fits, a profiled one; the KKT per lambda; beta's gap to phase 5's
    ``grpnet`` fit ``ref``).  C2: the same in 500 groups of 4 (K6, its
    Newton counts).  C3: ``lazy_cov(X / sqrt(n))`` through ``solve_core``
    a lambda at a time against C1: the columns formed and the peak memory.
    Returns {path: launches}."""
    import numpy as np
    import torch

    n, p = X.shape
    Xd = torch.as_tensor(X, device=DEV)
    t_form, (A, v) = timed(lambda: (
        ad.matrix.eager_cov(Xd * (1.0 / np.sqrt(n))),
        Xd.T @ torch.as_tensor(y, device=DEV) / n))
    A64, v64 = A.mat.double(), v.double()
    kw = dict(lmda_path_size=100, min_ratio=1e-2, early_exit=False)
    counters = (tk.launches, pg.launches)

    walls, st1, c1, warm = cov_cell(ad, "C1", A, v, counters, **kw)
    if len(st1.lmdas) != 100 or c1["pin_lasso_solve"] <= 0:
        fail(f"C1: {len(st1.lmdas)} lambdas, launches {c1}")
    ones = np.ones(p, int)
    kkt1 = cov_kkt("C1", A64, v64, st1, np.arange(p), ones, ones)
    audit(ad, "C1", st1)
    gap = float(np.abs(st1.betas.toarray() - ref.betas.toarray()).max())
    lm_gap = float(np.abs(np.asarray(st1.lmdas) / ref.lmdas - 1).max())
    phase("cov-dense", f"C1 gaussian_cov(eager_cov(X / sqrt(n)), X^T y / n)"
          f" n={n} p={p} f32, 100 lambdas (A, v formed in {t_form:.3f} s): "
          f"{walls_words(walls, warm)}, two timed fits bit-equal, peak "
          f"screen {int(max(st1.screen_sizes))}, launches {c1}, KKT "
          f"(float64) zero groups {kkt1[0]:.2e} lambda, nonzero "
          f"{kkt1[1]:.2e}; against phase 5's grpnet fit: lambdas rtol "
          f"{lm_gap:.1e}, beta {gap:.3e} | {card}")
    prof = profile_run(lambda: ad.gaussian_cov(A, v, **kw))
    phase("cov-dense", f"C1 {profile_line(prof)} | {card}")

    groups = np.arange(0, p, 4)
    pg.reset_newton()
    walls2, st2, c2, warm2 = cov_cell(ad, "C2", A, v, counters,
                                      groups=groups, **kw)
    if c2["pin_group_solve"] <= 0:
        fail(f"C2: K6 launched no time ({c2})")
    kkt2 = cov_kkt("C2", A64, v64, st2, groups, np.full(len(groups), 4),
                   np.full(len(groups), 2.0))
    phase("cov-dense", f"C2 the same in {len(groups)} groups of 4: "
          f"{walls_words(walls2, warm2)}, two timed fits bit-equal, "
          f"{len(st2.lmdas)} lambdas, peak screen "
          f"{int(max(st2.screen_sizes))} groups, launches {c2}, KKT zero "
          f"groups {kkt2[0]:.2e} lambda, nonzero {kkt2[1]:.2e} | {card}")
    phase("cov-dense", f"C2 (the four fits) {newton_line(pg.newton)} | "
          f"{card}")

    Al = ad.matrix.lazy_cov(Xd * (1.0 / np.sqrt(n)))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)
    wall3, st3 = timed(lambda: ad.gaussian_cov(Al, v, **kw))
    c3 = {k: c[k] for c in counters for k in c}
    peak3 = (torch.cuda.max_memory_allocated() - base) / 2**30
    if st3.error != "" or len(st3.lmdas) != len(st1.lmdas):
        fail(f"C3: error {st3.error!r}, {len(st3.lmdas)} lambdas")
    lm3 = float(np.abs(np.asarray(st3.lmdas) / st1.lmdas - 1).max())
    gap3 = float(np.abs(st3.betas.toarray() - st1.betas.toarray()).max())
    phase("cov-dense", f"C3 gaussian_cov(lazy_cov(X / sqrt(n))), a lambda "
          f"at a time: wall {wall3:.3f} s, {len(st3.lmdas)} lambdas "
          f"(rtol {lm3:.1e} to C1's), beta {gap3:.3e} from C1, peak "
          f"screen {int(max(st3.screen_sizes))}, {Al.n_formed} of {p} "
          f"columns formed, peak {peak3:.3f} GiB above its inputs (X / "
          f"sqrt(n) among them), launches {c3} | {card}")
    if lm3 > 1e-5 or gap3 > 1e-3:
        fail("C3: the lazy covariance's path parts from C1's")
    del A, Al, A64
    return {"cov-dense": c1, "cov-dense-grouped": c2, "cov-lazy": c3}


def ld_blocks(Xm, block, ys):
    """C4's inputs on the card: the LD blocks of ``block`` consecutive
    standardized SNPs (each its Gram / n from the decoded columns) and,
    for each response of ``ys``, v = X_std^T y / n."""
    import torch

    n, p = Xm.rows(), Xm.cols()
    mats, vs = [], [[] for _ in ys]
    for s in range(0, p, block):
        Xb = Xm.gather(torch.arange(s, min(s + block, p), device=DEV))
        Xb = Xb - Xb.mean(dim=0)
        Xb = Xb / Xb.std(dim=0, unbiased=False).clamp(min=1e-12)
        mats.append(Xb.T @ Xb / n)
        for v, y in zip(vs, ys):
            v.append(Xb.T @ y / n)
        del Xb
    return mats, [torch.cat(v) for v in vs]


def polygenic_trait(Xm, k, seed):
    """A polygenic response on the card: the standardized score of ``k``
    random SNPs with N(0, 1) effects plus noise of the same variance
    (heritability 0.5)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    causal = np.sort(rng.choice(Xm.cols(), k, replace=False))
    Xc = Xm.gather(torch.as_tensor(causal, device=DEV))
    Xc = (Xc - Xc.mean(dim=0)) / Xc.std(dim=0, unbiased=False)
    score = Xc @ torch.as_tensor(rng.standard_normal(k), dtype=Xc.dtype,
                                 device=DEV)
    noise = torch.as_tensor(rng.standard_normal(Xm.rows()), dtype=Xc.dtype,
                            device=DEV)
    return score + score.std() * noise


def cov_gwas_phase(ad, card, tk, Xm, io, y, block=1000, k_poly=200):
    """C4, the summary-statistics GWAS on phase 9's panel: ``block_diag``
    of 200 LD blocks of 1,000 standardized SNPs (lassosum's design),
    v = X_std^T y / n, 50 lambdas to 5e-2, through ``solve_core``: the
    wall, launches, peak memory, the KKT per lambda, the causal SNPs in
    the last active set.  The trait's 40 strong SNPs keep the screen far
    below 1024 (phase 9's grpnet fit peaks at 64), so a polygenic trait on
    the same blocks (200 causal SNPs, heritability 0.5, seed 43; no early
    exit) takes the screen past it (K2).  Returns {path: launches}."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    y_poly = polygenic_trait(Xm, k_poly, seed=43)
    t_form, (mats, (v, v_poly)) = timed(lambda: ld_blocks(
        Xm, block, [torch.as_tensor(y, device=DEV), y_poly]))
    A = ad.matrix.block_diag(mats, method="cov")
    offs = np.arange(0, A.cols(), block)
    ones = np.ones(A.cols(), int)
    out = {}
    for name, vv, what, early in (
            ("cov-gwas", v, "the GWAS trait", True),
            ("cov-gwas-polygenic", v_poly, "a polygenic trait (no early "
             "exit)", False)):
        torch.cuda.reset_peak_memory_stats()
        zero_counts(tk.launches)
        wall, st = timed(lambda: ad.gaussian_cov(
            A, vv, lmda_path_size=50, min_ratio=5e-2, early_exit=early))
        counts = dict(tk.launches)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        if st.error != "":
            fail(f"C4 ({what}): error {st.error!r}")
        B = torch.as_tensor(st.betas.toarray(), device=DEV).double()
        G = vv.double()[None, :] - torch.cat(
            [B[:, s:s + M.shape[0]] @ M.T.double()
             for s, M in zip(offs, mats)], dim=1)
        v0, v1 = group_kkt_parts(G, B, st.lmdas, np.arange(A.cols()), ones,
                                 ones, 1.0)
        zero, nonzero = float(v0.max()), float(v1.max())
        del B, G
        if not zero <= 1e-2:
            fail(f"C4 ({what}): zero-group KKT violation {zero:.3e} lambda")
        act = set(np.flatnonzero(st.betas.toarray()[-1]).tolist())
        found = (f", causal SNPs in the last active set "
                 f"{len(act & set(io.causal))} of {len(io.causal)}"
                 if name == "cov-gwas" else "")
        phase("cov-gwas", f"C4 gaussian_cov(block_diag of {len(mats)} LD "
              f"blocks of {block} standardized SNPs) on {what}, "
              f"n={Xm.rows()} p={Xm.cols()} f32 (blocks formed in "
              f"{t_form:.2f} s), 50 lambdas to 5e-2: wall {wall:.3f} s, "
              f"{len(st.lmdas)} lambdas, peak screen "
              f"{int(max(st.screen_sizes))}, pin solves' S in "
              f"[{min(st.benchmark['pin_caps'])}, "
              f"{max(st.benchmark['pin_caps'])}], launches {counts}, peak "
              f"memory {peak:.2f} GiB above the panel, KKT (float64) zero "
              f"groups {zero:.2e} lambda, nonzero {nonzero:.2e}{found} | "
              f"{card}")
        out[name] = counts
    if out["cov-gwas"]["pin_lasso_solve"] <= 0 or \
            out["cov-gwas-polygenic"]["pin_lasso_solve_rows"] <= 0:
        fail(f"C4: launches {out}: K1 on the GWAS trait and K2 on the "
             "polygenic one expected")
    del A, mats
    return out


def bvls_phase(ad, card, X, y):
    """A1, BVLS as non-negative least squares on phase 5's X and y
    (lower 0, upper +inf): a warm-up whose every K7 launch is replayed on
    the twin on the CPU on copies (bit-equal), three timed fits (the first
    two bit-equal), K7's launches; the bounds' KKT in float64 (the gradient
    X^T (y - X b) / n is <= 0 at a coefficient at 0 and 0 inside, both
    held at 1e-3 max |X^T y / n|).  The first timed fit's K7 launches, those
    whose work the state showed, and its peak device memory above what was
    allocated before it; the run fails unless the gather and the replay
    did work.  Returns (launches, K7's numbers at the largest replayed
    call, with the launches that worked)."""
    import numpy as np
    import torch

    from adelie_tpu_torch.solver import screened_cd_kernels as kc

    n, p = X.shape
    Xm = ad.matrix.dense(X, device=DEV)
    lo, hi = np.zeros(p, np.float32), np.full(p, np.inf, np.float32)

    def run():
        return ad.bvls(Xm, y, lo, hi)

    (warm, _), calls = k7_kept(lambda: timed(run))
    t0 = time.perf_counter()
    replay = k7_replay("A1 warm-up", calls)
    replay_s = time.perf_counter() - t0
    zero_counts(kc.launches, kc.segments, kc.worked)
    walls, states = [], []
    for i in range(3):
        if i == 0:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        wall, st = timed(run)
        if i == 0:
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            counts = dict(kc.launches)
            worked = dict(kc.worked)
            seg = dict(kc.segments)
        walls.append(wall)
        states.append(st)
    st = states[0]
    if not (np.array_equal(st.beta, states[1].beta)
            and st.loss == states[1].loss):
        fail("A1: two timed fits differ")
    for name, did in worked.items():
        if did <= 0:
            fail(f"A1: K7's {name} did no work ({counts[name]} launches)")
    Xd = torch.as_tensor(X, device=DEV).double()
    y64 = torch.as_tensor(y, device=DEV).double()
    b = torch.as_tensor(st.beta, device=DEV).double()
    g = Xd.T @ (y64 - Xd @ b) / n
    scale = float((Xd.T @ y64 / n).abs().max())
    at0 = b == 0
    kkt_lo = float(torch.where(at0, g.clamp(min=0), 0.0).max()) / scale
    kkt_in = float(torch.where(at0, 0.0, g.abs()).max()) / scale
    if not (kkt_lo <= 1e-3 and kkt_in <= 1e-3 and bool((b >= 0).all())):
        fail(f"A1: bound KKT {kkt_lo:.2e} (at 0), {kkt_in:.2e} (inside)")
    # K7 on the card at the largest replayed call's inputs
    i_big = max(range(len(calls)), key=lambda i: replay[i][0])
    args = [a.to(DEV) if torch.is_tensor(a) else a for a in calls[i_big][0]]
    args[0] = args[0].mT.contiguous().mT
    ms = cuda_ms(lambda: kc.screened_cd_solve(*args), reps=3)
    S, plain_ms, info, rows = replay[i_big]
    S_val = int(calls[i_big][0][6].sum())
    b_ms, b_by = k7_bound(S, S_val, 4, info[3], rows, info[4])
    # the gather and the replay at that call: each against its stand-in
    # step by step, its time a launch, its bound, and one PyTorch call
    # each: the gather's indexing, and for the replay the gather of the
    # listed rows' other columns and a GEMV by the log's deltas summed a
    # listed slot (the replay's function up to rounding)
    lock, n_work = k7_lockstep(f"A1 K7 call {i_big} steps", args)
    times, work = lock.times, lock.work
    Qt = args[0].mT
    idx = torch.as_tensor(work["list"], dtype=torch.long, device=DEV)
    ridx = torch.as_tensor(work["rest"], dtype=torch.long, device=DEV)
    dsum = torch.as_tensor(work["log"].reshape(-1, len(idx)).sum(0),
                           device=DEV)
    g_rest = torch.zeros(len(ridx), dtype=Qt.dtype, device=DEV)
    lib_ms = {"gather": cuda_ms(lambda: Qt[idx[:, None], idx], reps=10),
              "replay": cuda_ms(lambda: torch.addmv(
                  g_rest, Qt[idx[:, None], ridx].T, dsum, alpha=-1),
                  reps=10)}
    parts = {}
    for step, key in (("gather", "screened_cd_gather"),
                      ("replay", "screened_cd_replay")):
        k_ms, p_ms, launched = times[step]
        nb = work[f"{step}_bytes"]
        ops = work.get(f"{step}_ops", 0)
        bd = bound(nb / max(launched, 1), ops / max(launched, 1))
        parts[key] = dict(ms=k_ms / max(launched, 1),
                          plain_ms=p_ms / max(launched, 1), bound_ms=bd[0],
                          bound_by=bd[1], launched=launched,
                          worked=n_work[step], library_ms=lib_ms[step])
    k7_main = dict(S=S, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, moves=int(info[3]), updates=int(info[4]),
                   rows=rows, S_val=S_val, iters=int(info[1]), parts=parts,
                   worked=worked)
    phase("bvls", f"A1 bvls(X, y, 0, inf) n={n} p={p} f32: "
          f"{walls_words(walls, warm)}, two timed fits bit-equal, KKT "
          f"rounds {st.n_kkt}, screen {st.screen_set_size}, active "
          f"{st.active_set_size}, sweeps {st.iters}, K7 launches {counts} "
          f"(with work {worked}), peak {peak:.4f} GiB above the inputs; "
          f"bound KKT (float64) {kkt_lo:.2e} at 0, {kkt_in:.2e} inside; "
          f"the warm-up's {len(calls)} K7 calls (S {[r[0] for r in replay]})"
          f" bit-equal to the twin ({replay_s:.1f} s); K7 at S={S}: "
          f"{ms:.3f} ms ({info[3]:.0f} moves on {rows} distinct "
          f"slots of {S_val} valid, {info[4]:.0f} updates, "
          f"{ms * 1e3 / max(info[4], 1):.3f} us an update), the twin "
          f"{plain_ms:.0f} ms, bound {b_ms:.4f} ms ({b_by}); the first timed"
          f" fit's K7: {seg['fits']} fits, {seg['rounds']} rounds, "
          f"{seg['reads']} host reads, longest "
          f"list {seg['na_max']}, {seg['listed_moves']} of "
          f"{seg['listed_updates']} listed updates moved; at S={S} its "
          f"kernels bit-equal to their stand-ins step by step, "
          + ", ".join(f"{k} {v['ms']:.4f} ms a launch ({v['launched']} "
                      f"launches, {v['worked']} with work; stand-in "
                      f"{v['plain_ms']:.2f} ms, bound {v['bound_ms']:.5f} ms "
                      f"({v['bound_by']}), library {v['library_ms']:.4f} ms)"
                      for k, v in parts.items())
          + " (library: the gather's torch indexing; the replay's indexing "
          f"and addmv) | {card}")
    del Xm, Xd
    return counts, k7_main


def pinball_objective(A, S, v, pn, pp, b):
    """tests/test_aux_solvers.py's pinball objective."""
    Q = A @ S @ A.T
    return float(0.5 * b @ Q @ b - (A @ v) @ b
                 + pn @ (-b).clamp(min=0) + pp @ b.clamp(min=0))


def pinball_fista(A, S, v, pn, pp, max_iters=20000, tol=1e-14):
    """tests/test_aux_solvers.py's FISTA oracle in float64 on the card."""
    import torch

    Q = A @ S @ A.T
    lin = A @ v
    t = 1.0 / max(float(torch.linalg.eigvalsh(Q)[-1]), 1e-10)
    x = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    z = x.clone()
    s = 1.0
    for _ in range(max_iters):
        u = z - t * (Q @ z - lin)
        x_new = torch.where(u > t * pp, u - t * pp,
                            torch.where(u < -t * pn, u + t * pn, 0.0))
        s_new = 0.5 * (1 + (1 + 4 * s * s) ** 0.5)
        z = x_new + ((s - 1) / s_new) * (x_new - x)
        done = float((x_new - x).norm()) < tol
        x, s = x_new, s_new
        if done:
            break
    return x


# A2's sweeps in the twin's order (the JAX package's fit of this problem
# counts as many)
A2_SWEEPS = 64427


def pinball_phase(ad, card, m=4096, d=1024):
    """A2, pinball: A (4,096, 1,024) Gaussian, S a Wishart (1,024, 1,024)
    from 4,096 samples, penalties U(0.5, 1.5), seed 41, float64, ``tol``
    1e-12 (tests/test_aux_solvers.py's, for the objective): one timed fit
    (K7 runs tens of thousands of sweeps at S_cap 4,096), K7's launches,
    those whose work the state showed (the run fails unless the gather and
    the replay did work), the fit's peak device memory, the objective
    against a float64 FISTA on the card.  Returns the launches."""
    import numpy as np
    import torch

    from adelie_tpu_torch.solver import screened_cd_kernels as kc

    rng = np.random.default_rng(41)
    A = rng.standard_normal((m, d))
    Z = rng.standard_normal((4 * d, d))
    S = Z.T @ Z / (4 * d)
    v = rng.standard_normal(d)
    pn, pp = rng.uniform(0.5, 1.5, m), rng.uniform(0.5, 1.5, m)

    def run():
        return ad.pinball(A, S, v, pn, pp, tol=1e-12)

    zero_counts(kc.launches, kc.worked)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (wall, st), step_ms, step_n, seg = k7_timed(lambda: timed(run))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    counts, worked = dict(kc.launches), dict(kc.worked)
    for name, did in worked.items():
        if did <= 0:
            fail(f"A2: K7's {name} did no work ({counts[name]} launches)")
    if (m, d) == (4096, 1024) and st.iters != A2_SWEEPS:
        fail(f"A2: {st.iters} sweeps, not the {A2_SWEEPS} of the twin's "
             f"order")
    dev = dict(dtype=torch.float64, device=DEV)
    Ad, Sd, vd = (torch.as_tensor(a, **dev) for a in (A, S, v))
    pnd, ppd = torch.as_tensor(pn, **dev), torch.as_tensor(pp, **dev)
    t_f, x_f = timed(lambda: pinball_fista(Ad, Sd, vd, pnd, ppd))
    b = torch.as_tensor(st.beta, **dev)
    ours = pinball_objective(Ad, Sd, vd, pnd, ppd, b)
    oracle = pinball_objective(Ad, Sd, vd, pnd, ppd, x_f)
    b_gap = float((b - x_f).abs().max())
    # the test's bars (beta within 1e-5 of FISTA's, or the objective
    # within 1e-7); past them, the objective within 3e-7 y_var: three
    # times the gap this problem reads (1.0e-7 y_var), which the JAX
    # package's own fit of it reads too: its loss-plateau stop ends the
    # KKT rounds with a violator left (tools/pinball_plateau_gap.py)
    near = b_gap <= 1e-5 or ours <= oracle + 1e-7 * max(1.0, abs(oracle))
    if not (near or ours <= oracle + 3e-7 * st.y_var):
        fail(f"A2: objective {ours:.12g} above FISTA's {oracle:.12g} by "
             f"more than 3e-7 y_var ({st.y_var:.10g})")
    active_ms = step_ms.get("active", 0.0)
    phase("pinball", f"A2 pinball m={m} d={d} f64 tol 1e-12: wall {wall:.3f} s"
          f" (no warm-up), KKT rounds {st.n_kkt}, screen {st.screen_set_size}, active "
          f"{st.active_set_size}, sweeps {st.iters}, K7 launches {counts} "
          f"(with work {worked}), peak {peak:.4f} GiB; "
          f"K7: {seg['fits']} fits, {seg['rounds']} rounds (segments), "
          f"{seg['reads']} host reads, "
          f"longest list {seg['na_max']}, device ms: full sweeps "
          f"{step_ms.get('full', 0.0):.1f}, gather "
          f"{step_ms.get('gather', 0.0):.3f}, active {active_ms:.1f} "
          f"({active_ms * 1e3 / max(seg['listed_updates'], 1):.4f} us a "
          f"listed update, {active_ms * 1e3 / max(seg['listed_moves'], 1):.4f}"
          f" a listed move; {seg['listed_moves']} of "
          f"{seg['listed_updates']}), replay "
          f"{step_ms.get('replay', 0.0):.1f} "
          f"({step_ms.get('replay', 0.0) / 1e3 / wall:.4f} of the wall); "
          f"objective {ours:.12g} against FISTA's {oracle:.12g} (float64 on "
          f"the card, {t_f:.1f} s; y_var {st.y_var:.10g}, the gap "
          f"{(ours - oracle) / st.y_var:.2e} y_var), beta within "
          f"{b_gap:.2e} of FISTA's | {card}")
    return counts


def css_phase(ad, card, X, k=100, k_sf=20):
    """A3, column subset selection on the correlation of phase 5's X
    (p = 2,000): greedy least squares (k = 100), swapping from it, greedy
    min-det (k = 100), greedy subset factor (k = 20); walls, and the
    least-squares objective of greedy against swapping."""
    import numpy as np
    import torch

    Xd = torch.as_tensor(X, device=DEV).double()
    Xd = Xd - Xd.mean(dim=0)
    Xd = Xd / Xd.norm(dim=0)
    S = Xd.T @ Xd
    del Xd

    def ls_objective(T):
        Tt = torch.as_tensor(np.asarray(T), device=DEV)
        ST = S[:, Tt]
        return float(torch.trace(S) - torch.trace(
            ST @ torch.linalg.solve(S[Tt][:, Tt], ST.T)))

    words = []
    t, g = timed(lambda: ad.css_cov(S, k, method="greedy"))
    words.append(f"greedy least squares k={k} {t:.3f} s")
    t, sw = timed(lambda: ad.css_cov(S, subset=g.subset, method="swapping"))
    words.append(f"swapping from it {t:.3f} s "
                 f"({len(set(sw.subset) - set(g.subset))} columns swapped)")
    f_g, f_s = ls_objective(g.subset), ls_objective(sw.subset)
    if not f_s <= f_g * (1 + 1e-9):
        fail(f"A3: swapping's objective {f_s:.10g} above greedy's {f_g:.10g}")
    t, _ = timed(lambda: ad.css_cov(S, k, method="greedy", loss="min_det"))
    words.append(f"greedy min-det k={k} {t:.3f} s")
    t, _ = timed(lambda: ad.css_cov(S, k_sf, method="greedy",
                                    loss="subset_factor"))
    words.append(f"greedy subset factor k={k_sf} {t:.3f} s")
    phase("css", f"A3 css_cov on the correlation of X (p={S.shape[0]}, "
          f"f64): {'; '.join(words)}; least-squares objective greedy "
          f"{f_g:.6f}, swapping {f_s:.6f} | {card}")
    del S


def aux_cuda_vs_cpu_phase(ad):
    """A4, float64, the card against the CPU on small problems:
    ``gaussian_cov`` on the dense (chunked, grouped), lazy, block-diagonal
    and sparse covariance matrices; ``bvls``, ``pinball`` and ``css_cov``
    (greedy and swapping, all three losses).  Bars: lambdas rtol 1e-10,
    beta 1e-8, CSS subsets equal."""
    import numpy as np

    rng = np.random.default_rng(44)
    n, p = 400, 120
    X = rng.standard_normal((n, p))
    y = X[:, :10] @ rng.standard_normal(10) + rng.standard_normal(n)
    A, v = X.T @ X / n, X.T @ y / n
    As = np.where(np.abs(A) > 0.05, A, 0.0)
    blocks = [A[:60, :60], A[60:, 60:]]

    def mats(dev):
        return {"dense": ad.matrix.dense(A, method="cov", device=dev),
                "dense grouped": ad.matrix.dense(A, method="cov", device=dev),
                "lazy": ad.matrix.lazy_cov(X / np.sqrt(n), device=dev),
                "block-diagonal": ad.matrix.block_diag(
                    blocks, method="cov", device=dev),
                "sparse": ad.matrix.sparse(As, method="cov", device=dev)}

    worst = {}
    ad.set_configs("screen_all_max", 0)
    try:
        gpu, cpu = mats(DEV), mats("cpu")
        for name in gpu:
            kw = dict(groups=np.arange(0, p, 3)) if "grouped" in name else {}
            a, b = (ad.gaussian_cov(m[name], v, **kw) for m in (gpu, cpu))
            if a.error or b.error or len(a.lmdas) != len(b.lmdas):
                fail(f"A4 {name}: errors {a.error!r} {b.error!r}, "
                     f"{len(a.lmdas)} and {len(b.lmdas)} lambdas")
            lm = float(np.abs(a.lmdas / b.lmdas - 1).max())
            bt = float(np.abs(a.betas.toarray() - b.betas.toarray()).max())
            worst[name] = (lm, bt)
            if lm > 1e-10 or bt > 1e-8:
                fail(f"A4 {name}: lambdas {lm:.1e}, beta {bt:.1e}")
    finally:
        ad.set_configs("screen_all_max", None)
    lo, hi = -rng.uniform(0, 0.3, p), rng.uniform(0, 0.3, p)
    a, b = (ad.bvls(X, y, lo, hi, device=d) for d in (DEV, "cpu"))
    worst["bvls"] = (0.0, float(np.abs(a.beta - b.beta).max()))
    Ap = rng.standard_normal((80, 30))
    Z = rng.standard_normal((120, 30))
    Sp = Z.T @ Z / 120
    vp = rng.standard_normal(30)
    pn, pp = rng.uniform(0.5, 1.5, 80), rng.uniform(0.5, 1.5, 80)
    a, b = (ad.pinball(Ap, Sp, vp, pn, pp, device=d) for d in (DEV, "cpu"))
    worst["pinball"] = (0.0, float(np.abs(a.beta - b.beta).max()))
    for key in ("bvls", "pinball"):
        if worst[key][1] > 1e-8:
            fail(f"A4 {key}: beta {worst[key][1]:.1e}")
    C = np.corrcoef(rng.standard_normal((300, 60)).T)
    for loss in ("least_squares", "subset_factor", "min_det"):
        for method in ("greedy", "swapping"):
            a, b = (ad.css_cov(C, 8, method=method, loss=loss, device=d)
                    for d in (DEV, "cpu"))
            if list(a.subset) != list(b.subset):
                fail(f"A4 css {method} {loss}: {list(a.subset)} against "
                     f"{list(b.subset)}")
    phase("aux-cuda-vs-cpu", "A4 f64, the card against the CPU: "
          + "; ".join(f"{k} lambdas {lm:.1e} beta {bt:.1e}"
                      for k, (lm, bt) in worst.items())
          + "; css_cov subsets equal (greedy and swapping, three losses)")


# --------------------------------------------------------------------------- #
# S0-S6: structured and user matrices                                          #
# --------------------------------------------------------------------------- #

# a fit on a structured matrix against its dense equivalent, both float32
# on the card: the products round differently (a wrapper corrects its
# child's product; a row-split sum adds its parts), so the two paths part
# by rounding, carried through screening one lambda apart at most
STRUCT_LMDA_BAR = 1e-5      # relative
STRUCT_BETA_BAR = 1e-3      # of max |beta|


def user_matrix_class(ad):
    """tests/test_user_extension.py's ``ScaledDense``, ``M diag(s)``, as a
    user writes it in torch: ``mul``, ``gather`` and ``tmul`` only."""
    import numpy as np
    import torch

    class ScaledDense(ad.matrix.MatrixNaiveBase):
        def __init__(self, M, scales, device):
            self.device = torch.device(device)
            self._M = torch.as_tensor(M, device=self.device)
            self._s = torch.as_tensor(scales, dtype=self._M.dtype,
                                      device=self.device)
            self._rows, self._cols = M.shape
            self.torch_dtype = self._M.dtype
            self.dtype = np.dtype(str(self._M.dtype).replace("torch.", ""))

        def mul(self, v, w):
            return self._s * ((v * w) @ self._M)

        def gather(self, indices):
            idx = torch.as_tensor(indices, device=self.device).long()
            return self._M[:, idx] * self._s[idx]

        def tmul(self, beta):
            beta = torch.as_tensor(beta, dtype=self.torch_dtype,
                                   device=self.device)
            s = self._s if beta.dim() == 1 else self._s[:, None]
            return self._M @ (s * beta)

    return ScaledDense


def one_hot_dense(Z, levels):
    """The one-hot expansion written out: a continuous column as it is, a
    discrete one as its indicator columns."""
    import numpy as np

    cols = []
    for g, L in enumerate(levels):
        if L <= 0:
            cols.append(Z[:, g:g + 1])
        else:
            cols.append((Z[:, g:g + 1] == np.arange(L)).astype(Z.dtype))
    return np.concatenate(cols, axis=1)


def interaction_dense(Z, pairs, levels):
    """The interaction expansion written out, pair by pair (reference
    matrix.py:721-876's column order)."""
    import numpy as np

    def ind(g):
        return (Z[:, g:g + 1] == np.arange(levels[g])).astype(Z.dtype)

    def star(A, B):
        return np.stack([A[:, a] * B[:, b] for b in range(B.shape[1])
                         for a in range(A.shape[1])], axis=1)

    blocks = []
    for i, j in pairs:
        zi, zj = Z[:, i:i + 1], Z[:, j:j + 1]
        one = np.ones_like(zi)
        if levels[i] <= 0 and levels[j] <= 0:
            blocks.append(np.concatenate([zi, zj, zi * zj], 1))
        elif levels[i] <= 0:
            blocks.append(star(np.concatenate([one, zi], 1), ind(j)))
        elif levels[j] <= 0:
            blocks.append(star(ind(i), np.concatenate([one, zj], 1)))
        else:
            blocks.append(star(ind(i), ind(j)))
    return np.concatenate(blocks, axis=1)


def relu_dense(Z, mask, gated):
    import numpy as np

    Y = np.concatenate([mask[:, [k]] * Z for k in range(mask.shape[1])], 1)
    return Y if gated else np.concatenate([Y, -Y], 1)


def levels_data(rng, n, levels, dtype):
    """Columns with ``levels[g] > 0`` levels draw them uniformly; the
    others are standard normal."""
    import numpy as np

    Z = rng.standard_normal((n, len(levels)))
    for g, L in enumerate(levels):
        if L > 0:
            Z[:, g] = rng.integers(0, L, n)
    return Z.astype(dtype)


S0_LEVELS = (0, 5, 0, 5, 0, 3, 2, 0)


def structured_cases(ad, n, device, seed=50):
    """S0's matrices: {name: (matrix on ``device``, dense equivalent)},
    every new class from the same numpy draws, float64."""
    import numpy as np
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    m = ad.matrix
    kw = dict(device=device)
    levels = np.asarray(S0_LEVELS)
    X = rng.standard_normal((n, 40)) * rng.uniform(0.5, 5, 40) \
        + rng.uniform(-3, 3, 40)
    c, s = X.mean(0), X.std(0)
    rows = np.concatenate([rng.permutation(n)[: 9 * n // 10], [3, 3, 7]])
    cols = np.array([5, 0, 17, 5, 39, 22, 8])
    h = n // 2
    bd = np.zeros((n, 40))
    bd[:h, :20], bd[h:, 20:] = X[:h, :20], X[h:, 20:]
    Zs = np.where(rng.uniform(size=(n, 300)) < 0.01,
                  rng.uniform(size=(n, 300)), 0.0)
    Zl = levels_data(rng, n, levels, np.float64)
    inter = m.interaction(Zl, {0: None, 1: None, 3: [5, 6]}, levels, **kw)
    Zr = rng.standard_normal((n, 6))
    Zrs = np.where(rng.uniform(size=(n, 6)) < 0.3, Zr, 0.0)
    mask = Zr @ rng.standard_normal((6, 8)) >= 0
    scales = rng.uniform(0.5, 2.0, 40)
    return {
        "standardize": (m.standardize(X, **kw), (X - c) / s),
        "subset-cols": (m.subset(X, cols, axis=1, **kw), X[:, cols]),
        "subset-rows": (m.subset(X, rows, axis=0, **kw), X[rows]),
        "concatenate-rows": (m.concatenate(
            [X[:h], X[h:h + 300], X[h + 300:]], axis=0, **kw), X),
        "block-diag": (m.block_diag([X[:h, :20], X[h:, 20:]], **kw), bd),
        "sparse-padded": (m.sparse(Zs, layout="padded", **kw), Zs),
        "sparse-dense": (m.sparse(Zs, layout="dense", **kw), Zs),
        "one-hot": (m.one_hot(Zl, levels, **kw), one_hot_dense(Zl, levels)),
        "interaction": (inter, interaction_dense(Zl, inter.pairs, levels)),
        "relu-gated": (m.convex_gated_relu(Zr, mask, **kw),
                       relu_dense(Zr, mask, True)),
        "relu-full": (m.convex_relu(Zr, mask, **kw),
                      relu_dense(Zr, mask, False)),
        "relu-gated-sparse": (m.convex_gated_relu(
            sps.csc_matrix(Zrs), mask, **kw), relu_dense(Zrs, mask, True)),
        "relu-full-sparse": (m.convex_relu(sps.csc_matrix(Zrs), mask, **kw),
                             relu_dense(Zrs, mask, False)),
        "user": (user_matrix_class(ad)(X, scales, device), X * scales),
    }


def struct_products(M, n, p, moments, seed=51):
    """Each product of ``M`` on inputs drawn from ``seed``, as numpy:
    {name: array}; ``mean`` and ``var`` where the class defines them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    like = dict(dtype=M.torch_dtype, device=M.device)
    v = torch.as_tensor(rng.standard_normal(n), **like)
    w = torch.as_tensor(rng.uniform(0.1, 1.0, n) / n, **like)
    beta = torch.as_tensor(rng.standard_normal(p), **like)
    idx = torch.as_tensor(rng.choice(p, min(p, 50), replace=False),
                          device=M.device)
    out = {"mul": M.mul(v, w), "tmul": M.tmul(beta),
           "gather": M.gather(idx), "sq_mul": M.sq_mul(w)}
    if moments:
        out["mean"] = M.mean(w)
        out["var"] = M.var(out["mean"], w)
    return out, (v, w, beta, idx)


def structured_products_phase(ad, card, n=2000):
    """S0: every new class's products on the card against the same matrix
    on the CPU and against its dense equivalent in numpy, within 1e-12 of
    the largest entry; the same products twice on the card, bit-equal."""
    import numpy as np

    t0 = time.perf_counter()
    gpu = structured_cases(ad, n, "cuda")
    cpu = structured_cases(ad, n, "cpu")
    worst = {}
    for name, (Mg, D) in gpu.items():
        Mc = cpu[name][0]
        rows, p = D.shape
        # the interaction matrix defines no mean or var
        moments = name != "interaction"
        og, (v, w, beta, idx) = struct_products(Mg, rows, p, moments)
        og2, _ = struct_products(Mg, rows, p, moments)
        oc, _ = struct_products(Mc, rows, p, moments)
        v, w, beta, idx = (x.cpu().numpy() for x in (v, w, beta, idx))
        dense = {"mul": D.T @ (v * w), "tmul": D @ beta, "gather": D[:, idx],
                 "sq_mul": (D * D).T @ w}
        if moments:
            c, var = D.T @ w, ((D - og["mean"].cpu().numpy()) ** 2).T @ w
            if name == "one-hot":
                # mean 0 and var 1 on the indicator columns
                lv = np.asarray(S0_LEVELS)
                disc = np.repeat(lv > 0, np.maximum(lv, 1))
                c[disc], var[disc] = 0.0, 1.0
            dense["mean"], dense["var"] = c, var
        err = 0.0
        for key, a in og.items():
            if not same_bits(a, og2[key]):
                fail(f"S0 {name}: {key} twice on the card differs")
            ag = a.cpu().numpy()
            scale = max(float(np.abs(dense[key]).max()), 1e-300)
            e = max(float(np.abs(ag - oc[key].numpy()).max()),
                    float(np.abs(ag - dense[key]).max())) / scale
            if not e <= 1e-12:
                fail(f"S0 {name}: {key} off by {e:.2e} of its largest entry")
            err = max(err, e)
        worst[name] = (p, err, sorted(og))
    phase("S0", f"products at n={n} f64, card against the CPU and the dense "
          f"equivalent (bar 1e-12 of the largest entry), twice bit-equal on "
          f"the card; {len(worst)} matrices in "
          f"{time.perf_counter() - t0:.1f} s: "
          + "; ".join(f"{k} (p={p}) {e:.1e}" for k, (p, e, _) in
                      worst.items()) + f" | {card}")
    return max(e for _, e, _ in worst.values())


def struct_cell(ad, card, what, Xm, y, counters, groups=None, **kw):
    """One S cell: a warm-up and two timed ``grpnet`` fits on ``Xm``, which
    must be error-free and bit-equal and launch K1, K2 or K6 (K6 where
    there are groups); each lambda's KKT in float64 on the card from
    gathered columns (``snp_grad``, ``group_kkt_parts`` with the default
    penalties): every zero group within 1e-2 lambda of lambda p_g, the
    nonzero groups' stationarity reported; the first timed fit's launches
    and peak device memory.  Returns (state, launches)."""
    import numpy as np
    import torch

    warm, _ = fit(ad, Xm, y, groups=groups, **kw)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)
    wall, st = fit(ad, Xm, y, groups=groups, **kw)
    counts = {k: c[k] for c in counters for k in c}
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall2, st2 = fit(ad, Xm, y, groups=groups, **kw)
    if st.error != "" or st2.error != "":
        fail(f"{what}: errors {st.error!r} {st2.error!r}")
    if not same_path(st, st2):
        fail(f"{what}: two timed fits differ (beta or lambdas)")
    pins = [counts.get(k, 0) for k in ("pin_lasso_solve",
                                       "pin_lasso_solve_rows",
                                       "pin_group_solve")]
    if sum(pins) <= 0 or (groups is not None and pins[2] <= 0):
        fail(f"{what}: pin launches {pins} (K1, K2, K6)")
    G, B, _, _ = snp_grad(Xm, y, st)
    starts = np.arange(Xm.cols()) if groups is None else np.asarray(groups)
    sizes = np.diff(np.append(starts, Xm.cols()))
    v0, v1 = group_kkt_parts(G.T.contiguous(), B, st.lmdas, starts, sizes,
                             np.sqrt(sizes), 1.0)
    zero, nonzero = float(v0.max()), float(v1.max())
    del G, B
    if not zero <= 1e-2:
        fail(f"{what}: zero-group KKT violation {zero:.3e} lambda")
    launches = {k: v for k, v in counts.items() if v}
    phase(what, f"n={Xm.rows()} p={Xm.cols()} {Xm.dtype}: walls {wall:.3f},"
          f" {wall2:.3f} s (warm-up {warm:.3f} s), bit-equal; "
          f"{len(st.lmdas)} lambdas, peak screen {int(max(st.screen_sizes))}"
          f"{' groups' if groups is not None else ''}, launches {launches}, "
          f"KKT (float64): zero groups within {zero:.2e} lambda of lambda "
          f"p_g, nonzero groups' stationarity {nonzero:.2e} lambda; peak "
          f"memory {peak:.2f} GiB | {card}")
    return st, counts


def struct_vs_dense(ad, what, st, D, y, **kw):
    """A structured fit ``st`` against one fit of its dense equivalent
    ``D`` on the card (after the cell's, so warm): the same count of
    lambdas, lambdas within ``STRUCT_LMDA_BAR`` relative, coefficients and
    intercepts within ``STRUCT_BETA_BAR`` of max |beta|; its wall."""
    import numpy as np

    wall, ref = fit(ad, ad.matrix.dense(D, device="cuda"), y, **kw)

    if ref.error != "" or len(st.lmdas) != len(ref.lmdas):
        fail(f"{what}: dense equivalent error {ref.error!r}, "
             f"{len(st.lmdas)} and {len(ref.lmdas)} lambdas solved")
    lm = float(np.max(np.abs(st.lmdas / ref.lmdas - 1)))
    B, R = st.betas.toarray(), ref.betas.toarray()
    scale = float(np.abs(R).max())
    b = float(np.abs(B - R).max()) / scale
    b0 = float(np.abs(np.asarray(st.intercepts)
                      - np.asarray(ref.intercepts)).max()) / scale
    phase(what, f"against its dense equivalent (f32 on the card, wall "
          f"{wall:.3f} s): "
          f"{len(st.lmdas)} and {len(ref.lmdas)} lambdas solved, max lambda "
          f"rel diff {lm:.1e} (bar {STRUCT_LMDA_BAR:.0e}), max beta diff "
          f"{b:.2e} and intercept diff {b0:.2e} of max|beta| (bar "
          f"{STRUCT_BETA_BAR:.0e})")
    if lm > STRUCT_LMDA_BAR or b > STRUCT_BETA_BAR or b0 > STRUCT_BETA_BAR:
        fail(f"{what}: past the bars")


def standardize_dense_phase(ad, card, counters, y, n=40000, p=2000):
    """S1a: the headline's X before its centering (``headline_problem``'s
    first draw), each column scaled by U(0.5, 5) and shifted by
    U(-3, 3), as ``standardize(dense(X_raw))``, against ``grpnet`` on the
    standardized array (float64 on the host, then float32)."""
    import numpy as np

    X = np.random.default_rng(0).standard_normal((n, p)).astype(np.float32)
    rng = np.random.default_rng(15)
    X *= rng.uniform(0.5, 5, p).astype(np.float32)
    X += rng.uniform(-3, 3, p).astype(np.float32)
    kw = dict(lmda_path_size=100, min_ratio=1e-2, early_exit=False,
              device="cuda")
    Xm = ad.matrix.standardize(ad.matrix.dense(X, device="cuda"))
    st, counts = struct_cell(ad, card, "S1a", Xm, y, counters, **kw)
    X64 = X.astype(np.float64)
    Xs = ((X64 - X64.mean(0)) / X64.std(0)).astype(np.float32)
    del X64
    struct_vs_dense(ad, "S1a", st, Xs, y, **kw)
    return counts


def standardize_snp_phase(ad, card, counters, Xm9, y9):
    """S1b: ``standardize`` of phase 9's SNP panel in device memory (its
    centers and scales from K3 and the decoded columns), 50 lambdas to
    5e-2: K3 under the wrapper's ``mul``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Xs = ad.matrix.standardize(Xm9)
    torch.cuda.synchronize()
    phase("S1b", f"standardize(snp_unphased) built in "
          f"{time.perf_counter() - t0:.3f} s")
    _, counts = struct_cell(ad, card, "S1b", Xs, y9, counters,
                            lmda_path_size=50, min_ratio=5e-2, device="cuda")
    if counts["snp_mul"] <= 0:
        fail("S1b: the standardized SNP fit launched K3 no time")
    return counts


def sparse_design(n, p, density, seed):
    """A CSC matrix of ``density n p`` entries at uniform positions with
    U(0, 1) values, float32 (bench.py:254-295's ``sp.random``, drawn as
    rows and columns: the few positions drawn twice add)."""
    import numpy as np
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    nnz = int(density * n * p)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, p, nnz)
    vals = rng.uniform(size=nnz).astype(np.float32)
    return sps.csc_matrix((vals, (rows, cols)), shape=(n, p))


def sparse_phase(ad, card, counters, n=200_000, p=50_000, density=1e-3,
                 k=50, seed=52):
    """S2: the naive sparse matrix in padded planes, 50 true columns,
    intercept, 50 lambdas to 1e-2; then its gradient ``mul`` against its
    bound and against ``torch.sparse``'s CSR product."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    Xsp = sparse_design(n, p, density, seed)
    rng = np.random.default_rng(seed + 1)
    true = rng.choice(p, k, replace=False)
    y = (Xsp[:, true] @ (5 * rng.standard_normal(k)) + 1.0
         + 0.5 * rng.standard_normal(n)).astype(np.float32)
    synth = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xm = ad.matrix.sparse(Xsp, device="cuda")
    torch.cuda.synchronize()
    if Xm.layout != "padded":
        fail(f"S2: 'auto' chose the {Xm.layout} layout")
    phase("S2", f"n={n} p={p} nnz={Xsp.nnz} (density {Xsp.nnz / n / p:.2e})"
          f", planes of {Xm._cidx.shape[1]} (columns) and "
          f"{Xm._ridx.shape[1]} (rows) lanes; synthesis {synth:.1f} s, "
          f"upload {time.perf_counter() - t0:.1f} s")
    st, counts = struct_cell(ad, card, "S2", Xm, y, counters,
                             lmda_path_size=50, min_ratio=1e-2, device="cuda")
    hits = len(set(st.betas[-1].tocoo().col.tolist()) & set(true.tolist()))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(n, device="cuda", generator=gen)
    ones = torch.ones(n, device="cuda")
    csr = torch.sparse_csr_tensor(
        torch.as_tensor(Xsp.indptr.astype(np.int64), device="cuda"),
        torch.as_tensor(Xsp.indices.astype(np.int64), device="cuda"),
        torch.as_tensor(Xsp.data, device="cuda"), size=(p, n))
    got, lib = Xm.mul(u, ones), (csr @ u[:, None])[:, 0]
    err = float((got - lib).abs().max() / lib.abs().max())
    if not err <= 1e-5:
        fail(f"S2: mul against torch.sparse off by {err:.2e}")
    ms = cuda_ms(lambda: Xm.mul(u, ones), 50)
    lib_ms = cuda_ms(lambda: csr @ u[:, None], 50)
    bound_ms = (Xsp.nnz * 8 + n * 4) / HBM_BYTES_S * 1e3
    phase("S2", f"{hits}/{k} true columns in the last beta; gradient mul "
          f"{ms:.4f} ms, bound {bound_ms:.4f} ms (nnz x 8 B + n x 4 B over "
          f"3.35 TB/s: {bound_ms / ms:.3f} of it), torch.sparse CSR product "
          f"{lib_ms:.4f} ms, relative gap {err:.1e} | {card}")
    return counts


def glinternet_phase(ad, card, counters, n=100_000, d=50, L=5, seed=53):
    """S3: a glinternet design (Lim and Hastie 2015): 50 features, the odd
    ones categorical with 5 levels; ``concatenate([one_hot(Z),
    interaction(Z, {k: None for k < 10})])``, one group a feature and a
    pair; y from 4 main effects and 4 interactions plus noise; 50 lambdas
    to 5e-2 (K6)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    levels = np.array([0 if g % 2 == 0 else L for g in range(d)])
    Z = levels_data(rng, n, levels, np.float32)
    m = ad.matrix
    oh = m.one_hot(Z, levels, device="cuda")
    it = m.interaction(Z, {k: None for k in range(10)}, levels,
                       device="cuda")
    Xm = m.concatenate([oh, it])
    widths = np.where(levels <= 0, 1, levels)
    groups = np.concatenate([np.cumsum(widths) - widths,
                             oh.cols() + it.groups])
    sizes = np.diff(np.append(groups, Xm.cols()))
    if (Xm.cols(), len(groups), len(it.pairs), int(sizes.max())) \
            != (5480, 495, 445, 25):
        fail(f"S3: {Xm.cols()} columns in {len(groups)} groups, "
             f"{len(it.pairs)} pairs, largest group {sizes.max()}")
    z = Z.astype(np.float64)
    zi = z.astype(np.int64)
    e = [rng.standard_normal(s) for s in ((L,), (L,), (L,), (L, L), (L,))]
    y = (z[:, 0] + e[0][zi[:, 1]] + 0.8 * z[:, 2] + e[1][zi[:, 3]]
         + 0.6 * z[:, 0] * z[:, 2] + e[2][zi[:, 1]] * z[:, 4]
         + e[3][zi[:, 3], zi[:, 5]] + e[4][zi[:, 7]] * z[:, 0]
         + rng.standard_normal(n)).astype(np.float32)
    return struct_cell(ad, card, "S3", Xm, y, counters, groups=groups,
                       lmda_path_size=50, min_ratio=5e-2, device="cuda")[1]


def wrappers_phase(ad, card, counters, X, y):
    """S4: the headline through the wrappers, each against ``grpnet`` on
    its dense equivalent on the card (intercept, 50 lambdas to 1e-2, no
    early exit): four row blocks of 10,000 concatenated, a 36,000-row
    subset (a 90 % fold), a 1,500-column subset, the naive block-diagonal
    matrix of its two 20,000 x 1,000 halves."""
    import numpy as np

    n, p = X.shape
    m = ad.matrix
    rng = np.random.default_rng(54)
    fold = np.sort(rng.permutation(n)[:9 * n // 10])
    cols = np.sort(rng.choice(p, 3 * p // 4, replace=False))
    h, q = n // 2, p // 2
    D = np.zeros_like(X)
    D[:h, :q], D[h:, q:] = X[:h, :q], X[h:, q:]
    Xd = m.dense(X, device="cuda")
    kw = dict(lmda_path_size=50, min_ratio=1e-2, early_exit=False,
              device="cuda")
    counts = {}
    for what, Xm, yy, dense in (
            ("S4 row blocks", m.concatenate(
                [X[s:s + n // 4] for s in range(0, n, n // 4)], axis=0,
                device="cuda"), y, X),
            ("S4 row subset", m.subset(Xd, fold, axis=0), y[fold], X[fold]),
            ("S4 column subset", m.subset(Xd, cols, axis=1), y, X[:, cols]),
            ("S4 block-diagonal", m.block_diag(
                [X[:h, :q], X[h:, q:]], device="cuda"), y, D)):
        st, counts[what] = struct_cell(ad, card, what, Xm, yy, counters,
                                       **kw)
        struct_vs_dense(ad, what, st, dense, yy, **kw)
    return counts


def relu_phase(ad, card, counters, n=50_000, d=32, m=128, seed=55):
    """S5: convex ReLU features of Z (n, 32) under 128 gates ``Z g_k >=
    0`` (g_k Gaussian), y from a planted 4-neuron ReLU net plus noise: the
    gated matrix (4,096 columns in 128 groups of 32) and the full one
    (8,192 in 256), 50 lambdas to 5e-2 (K6)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((n, d)).astype(np.float32)
    mask = Z @ rng.standard_normal((d, m)).astype(np.float32) >= 0
    U = rng.standard_normal((d, 4))
    signal = np.maximum(Z @ U, 0) @ rng.standard_normal(4)
    y = (signal + 0.5 * signal.std() * rng.standard_normal(n)) \
        .astype(np.float32)
    counts = {}
    for gated in (True, False):
        what = "S5 gated ReLU" if gated else "S5 ReLU"
        Xm = ad.matrix.convex_relu(Z, mask, gated=gated, device="cuda")
        counts[what] = struct_cell(
            ad, card, what, Xm, y, counters,
            groups=np.arange(0, Xm.cols(), d), lmda_path_size=50,
            min_ratio=5e-2, device="cuda")[1]
    return counts


def user_matrix_phase(ad, card, counters, X, y):
    """S6: ``user_matrix_class``'s ``M diag(s)`` on the headline (s from
    U(0.5, 2)), 100 lambdas to 1e-2 with the intercept, against ``grpnet``
    on the scaled dense array on the card."""
    import numpy as np

    s = np.random.default_rng(56).uniform(0.5, 2, X.shape[1]) \
        .astype(np.float32)
    kw = dict(lmda_path_size=100, min_ratio=1e-2, early_exit=False,
              device="cuda")
    Xu = user_matrix_class(ad)(X, s, "cuda")
    st, counts = struct_cell(ad, card, "S6", Xu, y, counters, **kw)
    struct_vs_dense(ad, "S6", st, X * s, y, **kw)
    return counts


# --------------------------------------------------------------------------- #
# V1-V6: the model-selection layer                                             #
# --------------------------------------------------------------------------- #

CV_FOLDS = 5
CV_LOSS_BAR = 1e-4      # a fold's losses against float64 numpy, relative
V_BETA_BAR = 1e-4       # pin states and resumed fits, of max |beta|
# V5 on phase 6's problem: at its tol (1e-7) a path and the pin state on
# its last screen, each converged to tol, part by 1.5e-4 of max |beta|
# (float32 and float64 alike on the CPU; 6.8e-6 at 1e-10: run
# tools/pin_state_gap.py), so both fits of that cell run at this tol
V5_BIG_S_TOL = 1e-10
AUDITED = []            # (what, failures) of each state check_state read


def audit(ad, what, state):
    """``state.check_state`` of one state: any failure fails the run; the
    state's name is kept for V6's line."""
    failures = ad.state.check_state(state, "warn")
    AUDITED.append((what, len(failures)))
    if failures:
        fail(f"check_state on {what}: {failures}")


class GrpnetCalls:
    """Wraps ``adelie_tpu_torch.cv.grpnet`` (every fit of ``cv_grpnet`` and
    of ``CVGrpnetResult.fit``): each call's wall, launches on ``counters``
    and path (lambdas, betas, intercepts) on the host; each state passes
    ``check_state`` and is then let go (it holds its screen block)."""

    def __init__(self, ad, what, counters):
        self._ad, self._what, self._counters = ad, what, counters
        self._real = ad.cv.grpnet
        self.calls = []

    def __enter__(self):
        import numpy as np
        import torch

        def wrapper(*args, **kw):
            before = {k: c[k] for c in self._counters for k in c}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = self._real(*args, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if st.error:
                fail(f"{self._what}: a fit's error {st.error!r}")
            audit(self._ad, f"{self._what} fit {len(self.calls)}", st)
            self.calls.append(dict(
                wall=wall, lmdas=np.asarray(st.lmdas),
                counts={k: c[k] - before[k] for c in self._counters
                        for k in c},
                betas=st.betas.copy(), intercepts=np.asarray(st.intercepts)))
            return st

        self._ad.cv.grpnet = wrapper
        return self

    def __exit__(self, *exc):
        self._ad.cv.grpnet = self._real
        return False


def fold_loss_rows(family, y, eta):
    """The loss of each validation row (weights equal), float64: the
    gaussian's -y eta + eta^2 / 2, the logistic's log(1 + e^eta) - y eta."""
    import torch

    if family == "gaussian":
        return -y * eta + 0.5 * eta * eta
    return torch.nn.functional.softplus(eta) - y * eta


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def cv_cell(ad, card, what, Xm, glm, counters, cols, y, family, kkt, **kw):
    """V1-V4: ``cv_grpnet`` with ``CV_FOLDS`` folds and seed 0, run twice
    (the two runs' losses bit-equal), then ``CVGrpnetResult.fit``.  Each
    fold's losses are held against a float64 recomputation from that
    fold's coefficients on its validation rows (``cols`` gives columns in
    float64 on the card): within ``CV_LOSS_BAR`` of max(|loss|, scale),
    the scale that of the null model's loss (0.5 mean y^2, or log 2);
    ``kkt(state)`` checks the refit.  Returns the launches of the first
    run and the refit."""
    import numpy as np
    import torch

    n = Xm.rows()
    with GrpnetCalls(ad, what, counters) as rec:
        wall_cv, res = timed(lambda: ad.cv_grpnet(
            Xm, glm, n_folds=CV_FOLDS, seed=0, **kw))
        n_cv = len(rec.calls)
        res2 = ad.cv_grpnet(Xm, glm, n_folds=CV_FOLDS, seed=0, **kw)
        n_two = len(rec.calls)
        wall_fit, refit = timed(lambda: res.fit(
            Xm, glm, n_folds=CV_FOLDS, seed=0, **kw))
    calls, fit_calls = rec.calls[:n_cv], rec.calls[n_two:]
    if n_cv != CV_FOLDS + 1 or len(fit_calls) != 2:
        fail(f"{what}: {n_cv} fits in cv_grpnet, {len(fit_calls)} in its "
             "refit")
    if not np.array_equal(res.losses, res2.losses):
        fail(f"{what}: two runs' fold losses differ")
    L = len(res.lmdas)
    y64 = torch.as_tensor(np.asarray(y, np.float64), device=DEV)
    scale = (0.5 * float(torch.mean(y64 * y64)) if family == "gaussian"
             else float(np.log(2.0)))
    worst = 0.0
    for k, val in enumerate(ad.cv._fold_assignments(n, CV_FOLDS, 0)):
        c = calls[1 + k]
        B = c["betas"].tocsr()
        used = np.unique(B.indices)
        vi = torch.as_tensor(val, device=DEV)
        eta = torch.as_tensor(c["intercepts"], device=DEV)[None, :] \
            .double().expand(len(val), -1)
        if used.size:
            Bu = torch.as_tensor(B[:, used].toarray().T, device=DEV).double()
            eta = eta + cols(used)[vi] @ Bu
        ref = fold_loss_rows(family, y64[vi][:, None], eta).mean(0)
        ref = ref.cpu().numpy()
        got = res.losses[k, :len(ref)]
        err = np.abs(got - ref) / np.maximum(np.abs(ref), scale)
        worst = max(worst, float(err.max()))
    if not worst <= CV_LOSS_BAR:
        fail(f"{what}: fold losses {worst:.2e} off float64 numpy")
    if refit.error or len(refit.lmdas) != kw.get("lmda_path_size", 100):
        fail(f"{what}: refit error {refit.error!r}, {len(refit.lmdas)} "
             "lambdas")
    lm_star = float(res.lmdas[res.best_idx])
    if abs(refit.lmdas[-1] / lm_star - 1) > 1e-10:
        fail(f"{what}: the refit ends at {refit.lmdas[-1]}, not {lm_star}")
    kkt_r = kkt(refit)
    counts = {k: sum(c["counts"][k] for c in calls + fit_calls)
              for k in calls[0]["counts"]}
    for key in ("pin_lasso_solve", "pin_lasso_solve_rows",
                "pin_group_solve", "snp_mul"):
        if key in counts and counts[key] and not any(
                c["counts"].get(key) for c in calls[1:]):
            fail(f"{what}: no fold launched {key}")
    phase(what, f"cv_grpnet, {CV_FOLDS} folds, seed 0, {L} lambdas: wall "
          f"{wall_cv:.3f} s (dry fit {calls[0]['wall']:.3f} s, folds "
          f"{[round(c['wall'], 3) for c in calls[1:]]} s); refit "
          f"{wall_fit:.3f} s (dry fit {fit_calls[0]['wall']:.3f}, path "
          f"{fit_calls[1]['wall']:.3f} s, {len(refit.lmdas)} lambdas to "
          f"best_idx {res.best_idx}, lambda {lm_star:.4e}); launches a fold "
          f"{[nonzero(c['counts']) for c in calls[1:]]}, the refit's path "
          f"{nonzero(fit_calls[1]['counts'])}; fold losses against float64 "
          f"numpy on the validation rows {worst:.2e} of max(|loss|, "
          f"{scale:.3f}) (bar {CV_LOSS_BAR:.0e}); the second run's losses "
          f"bit-equal; the refit's worst KKT {kkt_r:.2e} lambda | {card}")
    return counts


def pin_naive_cell(ad, card, what, counters, key, Xm, y, ref, **kw):
    """V5: ``gaussian_pin_naive`` on the last screen of the fit ``ref``
    (screen_set, lmdas, betas) over its lambdas: ``key`` must launch, and
    beta at each lambda within ``V_BETA_BAR`` of max |beta| of the fit's."""
    import numpy as np

    zero_counts(*counters)
    wall, st = timed(lambda: ad.state.gaussian_pin_naive(
        X=Xm, y=y, screen_set=ref.screen_set, lmda_path=ref.lmdas,
        **kw).solve())
    counts = {k: c[k] for c in counters for k in c}
    if st.error or counts[key] <= 0 or len(st.lmdas) != len(ref.lmdas):
        fail(f"{what}: error {st.error!r}, {len(st.lmdas)} lambdas, "
             f"launches {counts}")
    audit(ad, what, st)
    gap = pin_gap(what, st, ref)
    phase("pin-states", f"{what}: gaussian_pin_naive on the fit's last "
          f"screen ({len(ref.screen_set)} groups) over its "
          f"{len(ref.lmdas)} lambdas: wall {wall:.3f} s, launches "
          f"{nonzero(counts)}, beta {gap:.2e} of max |beta| from the fit's "
          f"(bar {V_BETA_BAR:.0e}) | {card}")
    return counts


def pin_gap(what, st, ref):
    import numpy as np

    if not np.array_equal(np.asarray(st.lmdas), np.asarray(ref.lmdas)):
        fail(f"{what}: lambdas differ from the fit's")
    B = ref.betas.toarray()
    gap = float(np.abs(st.betas.toarray() - B).max() / np.abs(B).max())
    if not gap <= V_BETA_BAR:
        fail(f"{what}: beta {gap:.2e} of max |beta| from the fit's")
    return gap


def pin_cov_cell(ad, card, counters, X, y, ref):
    """V5: ``gaussian_pin_cov`` on C1's A = X^T X / n (formed on the card)
    and v = X^T y / n, on phase 5's last screen over its lambdas (K1),
    against phase 5's fit."""
    import numpy as np
    import torch

    n = X.shape[0]
    Xd = torch.as_tensor(X, device=DEV)
    A = ad.matrix.eager_cov(Xd * (1.0 / np.sqrt(n)))
    v = Xd.T @ torch.as_tensor(y, device=DEV) / n
    zero_counts(*counters)
    wall, st = timed(lambda: ad.state.gaussian_pin_cov(
        A=A, v=v, screen_set=ref.screen_set, lmda_path=ref.lmdas).solve())
    counts = {k: c[k] for c in counters for k in c}
    if counts["pin_lasso_solve"] <= 0:
        fail(f"V5 pin cov: launches {counts}")
    audit(ad, "V5 gaussian_pin_cov", st)
    gap = pin_gap("V5 pin cov", st, ref)
    phase("pin-states", f"gaussian_pin_cov on C1's A, phase 5's last screen "
          f"({len(ref.screen_set)} columns) over its {len(ref.lmdas)} "
          f"lambdas: wall {wall:.3f} s, launches {nonzero(counts)}, beta "
          f"{gap:.2e} of max |beta| from phase 5's fit (bar "
          f"{V_BETA_BAR:.0e}) | {card}")
    del A, Xd
    return counts


def diagnostics_phase(ad, card, _build, Xm, X, y, state, kkt5, kw):
    """V6: ``diagnostic(state)`` on phase 5's fit: ``predict`` against
    numpy float64 ``X B^T``, the zero groups' ``gradient_scores`` within
    lambda (1 + 1e-2) beside phase 5's KKT; ``save_state`` of the headline
    fit stopped at its 50th lambda (an ``exit_cond``), ``load_warm_start``
    and the rest of the path resumed on the card with
    ``check_state=True``, against the unbroken fit."""
    import numpy as np
    import torch

    d = ad.diagnostic.diagnostic(state)
    wall_p, etas = timed(d.predict)
    B = state.betas.toarray().astype(np.float64)
    used = np.flatnonzero(np.any(B != 0, axis=0))
    ref = np.asarray(X[:, used], np.float64) @ B[:, used].T     # (n, L)
    p_err = float(np.abs(etas.T - ref).max() / np.abs(ref).max())
    if not p_err <= 1e-5:
        fail(f"V6 predict: {p_err:.2e} of max |eta| from numpy float64")
    glm = ad.glm.gaussian(y).to(torch.device(DEV))
    wall_s, scores = timed(lambda: d.gradient_scores(d.gradient_norms(
        ad.diagnostic.gradients(Xm, ad.diagnostic.residuals(glm, etas)))))
    lm = np.asarray(state.lmdas)
    zero = np.where(B == 0, scores, -np.inf).max(1) / lm - 1
    worst0 = float(zero.max())
    if not worst0 <= 1e-2:
        fail(f"V6 gradient_scores: a zero group at lambda (1 + {worst0:.2e})")
    phase("diagnostic", f"phase 5's fit: predict ({len(lm)} x {X.shape[0]})"
          f" {wall_p:.3f} s, {p_err:.2e} of max |eta| from numpy float64 "
          f"X B^T (bar 1e-5); residuals, gradients, norms and scores "
          f"{wall_s:.3f} s: zero groups' scores at most lambda (1 + "
          f"{worst0:.2e}) (bar 1e-2; phase 5's worst KKT {kkt5:.2e} "
          f"lambda) | {card}")

    f = _build.BUILD_DIR / "chip_smoke_v6.npz"
    f.parent.mkdir(parents=True, exist_ok=True)
    wall_h, head = timed(lambda: ad.grpnet(
        Xm, ad.glm.gaussian(y), exit_cond=lambda s: len(s.lmdas) >= 50,
        **kw))
    if head.error or not np.array_equal(head.lmdas, lm[:50]):
        fail(f"V6 head: error {head.error!r}, {len(head.lmdas)} lambdas, "
             "not phase 5's first 50")
    audit(ad, "V6 head (exit_cond at 50)", head)
    ad.state.save_state(head, str(f))
    size = f.stat().st_size
    ws = ad.state.load_warm_start(str(f), device=DEV)
    f.unlink()
    rest = dict(kw, lmda_path=lm[50:], warm_start=ws, check_state=True)
    rest.pop("lmda_path_size", None)
    wall_r, tail = timed(lambda: ad.grpnet(Xm, ad.glm.gaussian(y), **rest))
    if tail.error:
        fail(f"V6 resumed fit: error {tail.error!r}")
    audit(ad, "V6 resumed fit", tail)
    tail_ref = types.SimpleNamespace(lmdas=lm[50:], betas=state.betas[50:])
    gap = pin_gap("V6 resumed fit", tail, tail_ref)
    phase("state", f"headline stopped at lambda 50 by exit_cond ({wall_h:.3f}"
          f" s), save_state {size} bytes, load_warm_start, the other "
          f"{len(lm) - 50} lambdas resumed on the card with "
          f"check_state=True ({wall_r:.3f} s): lambdas equal, beta "
          f"{gap:.2e} of max |beta| from phase 5's unbroken fit (bar "
          f"{V_BETA_BAR:.0e}) | {card}")


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

    # 4c. K7 against its twin: the whole screened fit
    k7 = k7_phase(card)
    torch.cuda.empty_cache()

    # 5. the headline fit (warm-up, then the timed main-path fit)
    X, y, signal5, nz5 = headline_problem(40000, 2000, 60, seed=0,
                                          with_signal=True)
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
    audit(ad, "headline (5)", state)
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
    audit(ad, "grouped headline (5b)", st5g)
    # V5 fits a pin state on its last screen
    ref5g = types.SimpleNamespace(screen_set=st5g.screen_set.copy(),
                                  lmdas=np.asarray(st5g.lmdas).copy(),
                                  betas=st5g.betas.copy())
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
    # queue 3, "Knife edges, not faults"), so two fits that each meet tol
    # part where a last-bit difference flips a mover.  The witness that the gap is the
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

    # G0-G4 and G7: GLMs by IRLS on dense inputs
    gram_peak_phase(card)
    glm_counts = glm_dense_phases(ad, card, tk, pg, X, signal5)
    glm_cuda_vs_cpu_phase(ad, tk, pg)
    # M1, M0 and M5: multi-response fits on X (x) I_K, dense
    glm_counts["multinomial"], st_m1 = multi_dense_phase(ad, card, tk, pg,
                                                         X, nz5)
    kron_block_phase(card, st_m1)
    del st_m1
    torch.cuda.empty_cache()
    multi_cuda_vs_cpu_phase(ad, tk, pg)
    # C1-C3, A1-A4: the covariance method and the standalone solvers
    glm_counts.update(cov_dense_phase(ad, card, tk, pg, X, y, state))
    torch.cuda.empty_cache()
    glm_counts["bvls"], k7_main = bvls_phase(ad, card, X, y)
    glm_counts["pinball"] = pinball_phase(ad, card)
    css_phase(ad, card, X)
    aux_cuda_vs_cpu_phase(ad)
    # S0-S6 but S1b: structured and user matrices, on the headline (S1a,
    # S4, S6) and on designs of their own (S2, S3, S5)
    t_struct = time.perf_counter()
    pins = (tk.launches, pg.launches)
    structured_products_phase(ad, card)
    glm_counts["S1a"] = standardize_dense_phase(ad, card, pins, y)
    glm_counts.update(wrappers_phase(ad, card, pins, X, y))
    glm_counts["S6"] = user_matrix_phase(ad, card, pins, X, y)
    torch.cuda.empty_cache()
    glm_counts["S2"] = sparse_phase(ad, card, pins)
    torch.cuda.empty_cache()
    glm_counts["S3"] = glinternet_phase(ad, card, pins)
    torch.cuda.empty_cache()
    glm_counts.update(relu_phase(ad, card, pins))
    struct_s = time.perf_counter() - t_struct
    torch.cuda.empty_cache()

    # V1-V3, V5, V6: the model-selection layer on the headline's problems
    # (V4 after S1b, on phase 9's panel)
    t_v = time.perf_counter()
    Xv = ad.matrix.dense(X, device="cuda")
    p5 = X.shape[1]
    v_counts = {"V1": cv_cell(
        ad, card, "cv-headline", Xv, ad.glm.gaussian(y), pins,
        dense_cols(X), y, "gaussian",
        lambda s: kkt_check("V1 refit", X, y, s), **kw)}
    y1 = case_control(standardized(signal5), seed=21)
    v_counts["V2"] = cv_cell(
        ad, card, "cv-logistic", Xv, ad.glm.binomial(y1), pins,
        dense_cols(X), y1, "logistic",
        lambda s: glm_dense_kkt("V2 refit", X, s, glm_resid("logit", y1),
                                *singletons(p5))[0],
        lmda_path_size=100, min_ratio=1e-2, early_exit=False, device="cuda")
    v_counts["V3"] = cv_cell(
        ad, card, "cv-grouped", Xv, ad.glm.gaussian(y), pins,
        dense_cols(X), y, "gaussian",
        lambda s: group_kkt_check("V3 refit", *dense_grad(X, y, s), s.lmdas,
                                  groups5, np.full(500, 4),
                                  np.full(500, 2.0), 1.0), **kw5g)
    torch.cuda.empty_cache()
    v_counts["V5-headline"] = pin_naive_cell(
        ad, card, "V5 headline (K1)", pins, "pin_lasso_solve", Xv, y, state,
        intercept=False)
    Xv6 = ad.matrix.dense(X6, device="cuda")
    wall6t, ref6 = timed(lambda: ad.grpnet(
        Xv6, ad.glm.gaussian(y6), **dict(kw6, tol=V5_BIG_S_TOL)))
    if ref6.error or len(ref6.lmdas) != len(state6.lmdas):
        fail(f"V5 big-S fit at tol {V5_BIG_S_TOL}: error {ref6.error!r}")
    audit(ad, "V5 big-S fit", ref6)
    phase("pin-states", f"phase 6's problem refitted at tol "
          f"{V5_BIG_S_TOL:.0e}: wall {wall6t:.3f} s, peak screen "
          f"{max(ref6.screen_sizes)} | {card}")
    v_counts["V5-big-S"] = pin_naive_cell(
        ad, card, f"V5 big-S (K2, tol {V5_BIG_S_TOL:.0e})", pins,
        "pin_lasso_solve_rows", Xv6, y6, ref6, intercept=False,
        tol=V5_BIG_S_TOL)
    del Xv6, ref6
    v_counts["V5-grouped"] = pin_naive_cell(
        ad, card, "V5 grouped headline (K6)", pins, "pin_group_solve", Xv, y,
        ref5g, groups=groups5, intercept=False)
    v_counts["V5-cov"] = pin_cov_cell(ad, card, pins, X, y, state)
    diagnostics_phase(ad, card, _build, Xv, X, y, state, kkt5, kw)
    v_s = time.perf_counter() - t_v
    del Xv, X, y, signal5, state
    torch.cuda.empty_cache()

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
    # G5: the case-control GWAS on the same panel
    glm_counts["gwas-logistic"] = glm_gwas_phase(ad, card, tk, sk, Xm9, io9)
    # M2: the multi-trait GWAS on the same panel
    glm_counts["gwas-multi"] = multi_gwas_phase(ad, card, tk, pg, sk, Xm9,
                                                io9)
    # C4: the summary-statistics GWAS on the same panel
    glm_counts.update(cov_gwas_phase(ad, card, tk, Xm9, io9, y9))
    # S1b: the same panel standardized
    t_struct = time.perf_counter()
    glm_counts["S1b"] = standardize_snp_phase(
        ad, card, (tk.launches, sk.launches, pg.launches), Xm9, y9)
    struct_s += time.perf_counter() - t_struct
    phase("structured", f"S0-S6 took {struct_s:.1f} s in all")
    # V4: the GWAS CV on the same panel in device memory (K3, K1)
    t_v = time.perf_counter()
    v_counts["V4"] = cv_cell(
        ad, card, "cv-gwas", Xm9, ad.glm.gaussian(y9),
        (tk.launches, sk.launches), snp_cols(io9), y9, "gaussian",
        lambda s: snp_kkt_check("V4 refit", Xm9, y9, s), **kw9)
    v_s += time.perf_counter() - t_v
    phase("state", f"check_state passed on {len(AUDITED)} states: "
          f"{sorted({w.split(' fit ')[0] for w, _ in AUDITED})} | {card}")
    phase("model-selection", f"V1-V6 took {v_s:.1f} s in all")
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
    G10, B10, lm10, _ = snp_grad(Xm10, y10, st10g)
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
    # M4: multi-response snpdat fits, streamed against in device memory
    multi_stream_vs_hbm_phase(ad, card, io11)
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
    del tile14
    # G6: the streamed case-control GWAS on the same panel
    glm_counts["north-star-logistic"] = glm_north_star_phase(
        ad, card, tk, sk, Xm14, io14)
    # M3: the streamed multi-trait north star on the same panel
    glm_counts["north-star-multi"] = multi_north_star_phase(
        ad, card, tk, pg, sk, Xm14, io14, copy_s)
    del Xm14, io14, st14
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
        {"name": "screened_cd_solve", "route": "cuda",
         "source": "adelie_tpu_torch/csrc/screened_cd_kernels.cu",
         "replaces": "adelie_tpu/solver/screened_cd.py:45 (no TPU kernel: "
                     "an XLA loop)",
         "launches": glm_counts["bvls"]["screened_cd_solve"],
         "worked": k7_main["worked"]["screened_cd_solve"],
         "max_abs_err": max(r["max_abs_err"] for r in k7),
         "ms": k7_main["ms"], "plain_ms": k7_main["plain_ms"],
         "bound_ms": k7_main["bound_ms"], "bound_by": k7_main["bound_by"],
         "library_ms": None},
        *({"name": name, "route": "cuda",
           "source": "adelie_tpu_torch/csrc/screened_cd_kernels.cu",
           "replaces": "adelie_tpu/solver/screened_cd.py:45 (no TPU kernel: "
                       "part of K7, for the XLA loop)",
           "launches": glm_counts["bvls"][name],
           "worked": k7_main["worked"][name], "max_abs_err": 0.0,
           **{k: part[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}
          for name, part in k7_main["parts"].items()),
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
    # each kernel's launches on every path that ran it
    paths = {"headline": counts_5, "headline-grouped": counts5g,
             "big-S": counts_6, "gwas": counts9, "phased": counts10,
             "phased-grouped": counts10g, "north-star": counts14,
             **glm_counts, **v_counts}
    for k in kernels["kernels"]:
        k["launches_by_path"] = {path: c[k["name"]]
                                 for path, c in paths.items()
                                 if c.get(k["name"], 0) > 0}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
