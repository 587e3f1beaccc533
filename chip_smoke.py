#!/usr/bin/env python3
"""Drive adelie_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from adelie_tpu_torch/csrc;
3. K1 ``pin_lasso_solve`` against its plain twin on the card, float32 and
   float64, S in {64, 1000, 1024};
4. K2 ``cd_sweep_rows`` against its twin, S in {2048, 8192};
5. the headline fit: ``grpnet(X, glm.gaussian(y))`` on "cuda" at
   n = 40,000, p = 2,000, 100 lambdas, float32 (bench.py's problem), with a
   per-lambda KKT check in numpy float64;
6. a second fit whose screen set passes 1024, so K2 carries it;
7. the same float64 fit on "cuda" and on "cpu".

The launch counters are zeroed just before phase 5 and read just after
phase 6: those two fits are the main path, and every kernel must have run
in them.  Any failed phase exits non-zero.  The line before the last holds
the kernels' JSON; the last line is ``{"ok": true, "device": ...}``.
Needs one CUDA device; exits 1 without one.
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

    k1_main = next(r for r in k1 if r["S"] == 1024
                   and r["dtype"] == "torch.float32")
    k2_main = next(r for r in k2 if r["S"] == 2048
                   and r["dtype"] == "torch.float32")
    kernels = {"kernels": [
        {"name": "pin_lasso_solve", "route": "cuda",
         "source": "adelie_tpu_torch/csrc/pin_kernels.cu",
         "replaces": "adelie_tpu/solver/pin_pallas.py:366",
         "launches": counts["pin_lasso_solve"],
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"]},
        {"name": "cd_sweep_rows", "route": "cuda",
         "source": "adelie_tpu_torch/csrc/pin_kernels.cu",
         "replaces": "adelie_tpu/solver/pin_pallas.py:307",
         "launches": counts["cd_sweep_rows"],
         "max_abs_err": max(r["max_abs_err"] for r in k2),
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"]},
    ]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
