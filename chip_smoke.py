#!/usr/bin/env python3
"""Drive adelie_tpu_torch's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (phases 8, 12, 13 and 14 a few):

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from adelie_tpu_torch/csrc;
3. K1 ``pin_lasso_solve`` against its plain twin on the card, float32 and
   float64, S in {64, 1000, 1024};
4. K2 ``cd_sweep_rows`` against its twin, S in {2048, 8192};
5. the headline fit: ``grpnet(X, glm.gaussian(y))`` on "cuda" at
   n = 40,000, p = 2,000, 100 lambdas, float32 (bench.py's problem), with a
   per-lambda KKT check in numpy float64;
6. a second fit whose screen set passes 1024, so K2 carries it;
7. the same float64 fit on "cuda" and on "cpu";
8. K3 ``snp_mul`` and K4 ``snp_mul_no_na`` against their twins: float
   checks at (p, n) = (300, 257), (513, 1,000), (513, 4,091) and
   (20,000, 50,000), whose rows of nb = ceil(n / 4) bytes start at every
   offset mod 4 (nb % 4 = 1, 2, 3, 0), in float32 and float64 against the
   twin in float64; then exact checks with integer inputs (bit-equal) at
   the GWAS shape, p = 200,000 with n = 50,000 (rows 4-byte aligned) and
   n = 50,001 (not), each timed;
9. the GWAS fit: ``grpnet(matrix.snp_unphased(io), glm.gaussian(y))`` at
   n = 50,000 samples, p = 200,000 SNPs (2.5 GB packed; bench.py's GWAS
   problem), 50 lambdas, float32, intercept, with a per-lambda KKT check
   in float64 on the card, and one more fit under ``torch.profiler``
   (device busy time by kernel); then K3's time on that matrix beside its
   twin's, its bound and a cuBLAS gemv on the decoded float32 matrix;
10. the phased-ancestry fit: n = 50,000, 10,000 SNPs x 3 ancestries,
    ``groups=None``, 50 lambdas, float32, the same KKT check and profile;
    then K4's times as K3's;
11. a ``.snpdat`` file written and read by ``adelie_tpu_torch.io``, fitted
    in float64 on "cuda" and on "cpu";
12. K5 ``snp_mul_many`` against its twin: float checks at eight (p, n, C)
    (every nb % 4, C from 1 to 200 across the kernel's 8-, 32- and
    128-column variants, tensors starting unaligned) in float32 and
    float64; exact checks with integer inputs at a north-star tile
    (65,536 x 100,000) for C in {1, 2, 20, 50, 100}, the C the path uses
    among them; the same through the streamed ``mul_many`` over four
    tiles for C in {2, 20, 100};
13. the host-streamed path against the in-device one: phase 9's GWAS
    panel and phase 11's ``.snpdat`` problem (``tile_snps=256``, a ragged
    last tile) fitted streamed on "cuda", with the speculative union off,
    against phase 9's and phase 11's in-device fits;
14. the north star: ``grpnet(matrix.snp_unphased(io, streaming=True),
    glm.gaussian(y))`` over 1,000,000 SNPs x 100,000 samples (25 GB packed
    in host memory; benchmark/north_star_data.py's panel, made here), 50
    lambdas, float32, one warm-up fit, one timed, one profiled, a KKT
    check in float64 from one plain pass over the panel, and K5's times on
    its first tile.  The panel is cut in whole tiles, and the cut printed,
    if the host's available memory cannot hold it and 16 GB more.

Each main path has its launch counts: the counters are zeroed just before
phase 5 and read just after phase 6 (the dense fits, K1 and K2), zeroed
before phase 9 and read after it (K3), zeroed before phase 10 and read
after it (K4), and zeroed before phase 14's timed fit and read after it
(K5, with no K3).  Every kernel must have run on its path.  Any failed
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


def check_close(what, got, want, dtype_is_f32):
    """f32: |got - want| <= 1e-4 (|want| + max|want|); f64: atol 1e-10."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if dtype_is_f32:
        bound = 1e-4 * (want.abs() + want.abs().max())
        ok = bool(((got - want).abs() <= bound).all())
    else:
        ok = err <= 1e-10
    if not ok or not bool(torch.isfinite(got).all()):
        fail(f"{what}: max abs diff {err:.3e} is past the bar")
    return err


# --------------------------------------------------------------------------- #
# phases 3 and 4: each kernel against its twin                                 #
# --------------------------------------------------------------------------- #


def k1_case(S, dtype, seed):
    """A well-conditioned screen problem: A = X^T X / n with n = 4 S
    (eigenvalues in about [0.25, 2.25]), a few invalid slots."""
    import numpy as np
    import torch

    from adelie_tpu_torch.solver import pin_kernels as tk

    rng = np.random.default_rng(seed)
    n = 4 * S
    X = torch.as_tensor(rng.standard_normal((n, S)), device="cuda")
    beta_true = np.where(rng.random(S) < 0.2, rng.standard_normal(S), 0.0)
    y = X @ torch.as_tensor(beta_true, device="cuda") \
        + 0.5 * torch.as_tensor(rng.standard_normal(n), device="cuda")
    A = (X.T @ X / n).to(dtype).contiguous()
    grad = (X.T @ y / n).to(dtype)
    valid = torch.ones(S, dtype=torch.bool, device="cuda")
    valid[-3:] = False
    diag = torch.where(valid, torch.diagonal(A), 0).contiguous()
    pen = torch.as_tensor(rng.uniform(0.5, 1.5, S), dtype=dtype,
                          device="cuda")
    beta0 = torch.zeros(S, dtype=dtype, device="cuda")
    act0 = torch.zeros(S, dtype=torch.bool, device="cuda")
    lmda = 0.05 * float(grad.abs().max())
    args = (A, grad, beta0, diag, valid, act0, pen, lmda, 1.0, 1e-7,
            100000, 0.0)

    kernel = lambda: tk.pin_lasso_solve(*args)  # noqa: E731
    twin = lambda: tk.pin_lasso_solve_ref(*args)  # noqa: E731
    ms = cuda_ms(kernel, reps=10)
    b_k, g_k, a_k, info_k = kernel()
    plain_ms, (b_t, g_t, a_t, info_t) = host_ms(twin)
    f32 = dtype == torch.float32
    err = max(check_close(f"K1 S={S} {dtype} beta", b_k, b_t, f32),
              check_close(f"K1 S={S} {dtype} grad", g_k, g_t, f32))
    rsq_k, it_k, done_k = info_k.tolist()
    rsq_t, it_t, done_t = info_t.tolist()
    if done_k != done_t or done_k != 1.0:
        fail(f"K1 S={S} {dtype}: done kernel {done_k} twin {done_t}")
    if not torch.equal(a_k, a_t):
        fail(f"K1 S={S} {dtype}: active flags differ")
    return dict(S=S, dtype=str(dtype), max_abs_err=err, iters=int(it_k),
                iters_twin=int(it_t), n_active=int(a_k.sum()), ms=ms,
                plain_ms=plain_ms)


def k2_case(S, C, n, dtype, seed):
    """A = I + B^T B / 256 (B 256 x S): well conditioned; a list of C
    distinct positions of which the first n are swept."""
    import numpy as np
    import torch

    from adelie_tpu_torch.solver import pin_kernels as tk

    rng = np.random.default_rng(seed)
    B = torch.as_tensor(rng.standard_normal((256, S)), device="cuda")
    A = (torch.eye(S, dtype=torch.float64, device="cuda")
         + B.T @ B / 256).to(dtype).contiguous()
    del B
    beta = torch.as_tensor(0.1 * rng.standard_normal(S), dtype=dtype,
                           device="cuda")
    grad = torch.as_tensor(rng.standard_normal(S), dtype=dtype, device="cuda")
    pos = torch.as_tensor(rng.permutation(S)[:C].astype(np.int32),
                          device="cuda")
    akk = torch.diagonal(A)[pos.long()].contiguous()
    pk = torch.as_tensor(rng.uniform(0.5, 1.5, C), dtype=dtype,
                         device="cuda")
    n_t = torch.tensor([n], dtype=torch.int32, device="cuda")
    args = (A, beta, grad, pos, akk, pk, n_t, 0.3, 0.1, 0.25)

    kernel = lambda: tk.cd_sweep_rows(*args)  # noqa: E731
    twin = lambda: tk.cd_sweep_rows_ref(*args)  # noqa: E731
    ms = cuda_ms(kernel, reps=10)
    b_k, g_k, m_k, info_k = kernel()
    plain_ms, (b_t, g_t, m_t, info_t) = host_ms(twin)
    f32 = dtype == torch.float32
    err = max(check_close(f"K2 S={S} {dtype} beta", b_k, b_t, f32),
              check_close(f"K2 S={S} {dtype} grad", g_k, g_t, f32),
              check_close(f"K2 S={S} {dtype} convg,rsq", info_k, info_t,
                          f32))
    if not torch.equal(m_k, m_t):
        fail(f"K2 S={S} {dtype}: moved flags differ")
    return dict(S=S, C=C, n=n, dtype=str(dtype), max_abs_err=err,
                moved=int(m_k.sum()), ms=ms, plain_ms=plain_ms)


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


def pin_bound(S, vec_bytes, ops, itemsize=4):
    """K1/K2: A read once plus the vectors."""
    return bound(S * S * itemsize + vec_bytes, ops)


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


def timing_line(r):
    return (f"kernel {r['ms']:.3f} ms, twin {r['plain_ms']:.3f} ms, bound "
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
    nz = Bfull != 0
    g = G.T                                                         # (L, p)
    v0 = torch.where(nz, 0.0, g.abs()).amax(dim=1) - lm
    v1 = torch.where(nz, (g - lm[:, None] * Bfull.sign()).abs(),
                     0.0).amax(dim=1)
    worst = float((torch.maximum(v0, v1) / lm).max())
    if not worst <= 1e-2:
        fail(f"{what}: KKT violation {worst:.3e} lambda")
    return worst


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


def many_timing(tile, n, C, imp, seed):
    """K5's, its twin's and torch.matmul's time on one device tile at C
    residuals; the matmul multiplies the decoded float32 tile, cut to half
    its rows (and said so) if it does not fit."""
    import torch

    from adelie_tpu_torch.matrix import snp_kernels as sk

    gen = torch.Generator(device=DEV).manual_seed(seed)
    U = torch.randn((C, n), device=DEV, generator=gen)
    ms = cuda_ms(lambda: sk.snp_mul_many(tile, U, imp), reps=5)
    plain_ms = cuda_ms(lambda: sk.snp_mul_many_ref(tile, U, imp), reps=1)
    T = tile.shape[0]
    note = ""
    try:
        Xd = decoded_f32(tile, n, imp)
    except torch.cuda.OutOfMemoryError:
        T //= 2
        note = (f" (torch.matmul timed at {T} x {n} x {C}: the decoded "
                "tile did not fit)")
        torch.cuda.empty_cache()
        Xd = decoded_f32(tile[:T], n, imp[:T])
    Ut = U.T.contiguous()
    library_ms = cuda_ms(lambda: torch.matmul(Xd, Ut), reps=5)
    del Xd
    torch.cuda.empty_cache()
    b_ms, b_by = many_bound(tile.shape[0], n, C)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, note=note,
                bound_ms=b_ms, bound_by=b_by)


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

    # 3. K1 against its twin
    k1 = []
    for dtype in (torch.float32, torch.float64):
        for S in (64, 1000, 1024):
            r = k1_case(S, dtype, seed=S)
            k1.append(r)
            phase("K1", f"S={S} {r['dtype']}: max|diff| {r['max_abs_err']:.3e}"
                  f" iters {r['iters']}/{r['iters_twin']} active "
                  f"{r['n_active']} kernel {r['ms']:.3f} ms twin "
                  f"{r['plain_ms']:.1f} ms")

    # 4. K2 against its twin
    k2 = []
    for dtype in (torch.float32, torch.float64):
        for S in (2048, 8192):
            r = k2_case(S, C=512, n=400, dtype=dtype, seed=S)
            k2.append(r)
            phase("K2", f"S={S} {r['dtype']}: max|diff| {r['max_abs_err']:.3e}"
                  f" moved {r['moved']}/400 kernel {r['ms']:.3f} ms twin "
                  f"{r['plain_ms']:.1f} ms")

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
    del Xm

    # 6. a screen set past 1024: K2 carries the pin solves
    X6, y6 = headline_problem(4000, 2500, 1500, seed=1)
    wall6, state6 = fit(ad, ad.matrix.dense(X6, device="cuda"), y6,
                        lmda_path_size=40, intercept=False, early_exit=False,
                        device="cuda")
    counts = dict(tk.launches)
    counts_6 = {k: counts[k] - counts_5[k] for k in counts}
    if state6.error != "" or len(state6.lmdas) != 40:
        fail(f"S > 1024 fit: error {state6.error!r}")
    kkt6 = kkt_check("S > 1024 fit", X6, y6, state6)
    peak6 = int(max(state6.screen_sizes))
    phase("big-S", f"n=4000 p=2500 f32 40 lambdas: wall {wall6:.3f} s, peak "
          f"screen {peak6}, launches {counts_6}, worst KKT {kkt6:.2e} lambda")
    if peak6 <= 1024 or counts_6["cd_sweep_rows"] <= 0:
        fail("the S > 1024 fit did not go through K2")
    for name, c in counts.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the main path")

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
          f"{timing_line(snp_time['snp_mul'])}; launches x kernel ms "
          f"{k3_path_ms:.1f} ms, {k3_path_ms / (wall9 * 1e3):.2f} of the "
          f"path's wall | {card}")
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
          f"{timing_line(snp_time['snp_mul_no_na'])}; launches x kernel ms "
          f"{k4_path_ms:.1f} ms, {k4_path_ms / (wall10 * 1e3):.2f} of the "
          f"path's wall | {card}")
    del Xm10, io10
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

    many_shapes = ((10, 9, 3), (300, 257, 8), (513, 1000, 1),
                   (513, 4091, 100), (700, 1024, 33), (257, 2000, 200),
                   (1001, 3333, 20), (129, 130, 9))
    errs = [many_float_case(p, n, C, dtype, seed=p + n + C)
            for p, n, C in many_shapes
            for dtype in (torch.float32, torch.float64)]
    snp_err["snp_mul_many"] = max(errs)
    phase("K5", f"vs twin in f64, (p, n, C) in {many_shapes} (nb % 4 = "
          f"{[(n + 3) // 4 % 4 for _, n, _ in many_shapes]}, tensors "
          f"starting unaligned), f32 and f64: max |diff| {max(errs):.3e}, "
          "within 1e-4 / 1e-12 of (|X|^T|U_c|)_j")
    # the north-star path runs C = 2 (setup), 1 (dry fits) and the chunk's
    # lambda count (up to 50); 20 takes the 32-column variant
    exact_cs = (1, 2, 20, 50, 100)
    many_exact_tile(NS_TILE, NS_N, exact_cs, seed=12)
    phase("K5", f"integer inputs at the north-star tile T={NS_TILE} "
          f"n={NS_N} C in {exact_cs}, all four codes, f32: bit-equal to the "
          "twin")
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
    prof14 = profile_fit(ad, Xm14, y14, **kw14)
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
    tile14 = Xm14._host[:NS_TILE].to("cuda")
    C14 = max(L14, 1)
    snp_time["snp_mul_many"] = many_timing(tile14, NS_N, C14,
                                           Xm14._impute[:NS_TILE], seed=140)
    r = snp_time["snp_mul_many"]
    c1_ms = cuda_ms(lambda: sk.snp_mul_many(tile14, u14, Xm14._impute[
        :NS_TILE]), reps=5)
    phase("K5", f"on north-star tile 0, T={NS_TILE} n={NS_N} C={C14} f32: "
          f"kernel {r['ms']:.3f} ms, twin {r['plain_ms']:.3f} ms, bound "
          f"{r['bound_ms']:.3f} ms ({r['bound_by']}), torch.matmul on the "
          f"decoded f32 tile {r['library_ms']:.3f} ms{r['note']}; at C=1 "
          f"{c1_ms:.3f} ms; launches x C={C14} ms "
          f"{counts14['snp_mul_many'] * r['ms']:.1f} ms (an upper bound: "
          f"setup and dry-fit passes run C <= 2) | {card}")
    del tile14, Xm14, io14, st14
    torch.cuda.empty_cache()

    # 15. the kernels' line
    k1_main = next(r for r in k1 if r["S"] == 1024
                   and r["dtype"] == "torch.float32")
    k2_main = next(r for r in k2 if r["S"] == 2048
                   and r["dtype"] == "torch.float32")
    S1, S2, C2 = 1024, 2048, 512
    k1_bound = pin_bound(S1, 4 * S1 * 4 + 2 * S1 + 2 * S1 * 4 + S1 + 12,
                         2 * S1 * k1_main["n_active"])
    k2_bound = pin_bound(S2, 4 * S2 * 4 + C2 * 13 + 4 + 8,
                         2 * S2 * k2_main["moved"])
    kernels = {"kernels": [
        {"name": "pin_lasso_solve", "route": "cuda",
         "source": "adelie_tpu_torch/csrc/pin_kernels.cu",
         "replaces": "adelie_tpu/solver/pin_pallas.py:366",
         "launches": counts["pin_lasso_solve"],
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None},
        {"name": "cd_sweep_rows", "route": "cuda",
         "source": "adelie_tpu_torch/csrc/pin_kernels.cu",
         "replaces": "adelie_tpu/solver/pin_pallas.py:307",
         "launches": counts["cd_sweep_rows"],
         "max_abs_err": max(r["max_abs_err"] for r in k2),
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None},
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
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
