"""The two lasso pin-solve kernels, their plain PyTorch twins and counters.

Counterpart of ``adelie_tpu/solver/pin_pallas.py``:

* ``pin_lasso_solve`` (K1) runs the whole q = 1 pin solve at one lambda
  for a screen capacity S <= ``MAX_PALLAS_S``;
* ``cd_sweep_rows`` (K2) runs one Gauss-Seidel pass over a list of updates,
  for any S.

For a CUDA tensor each wrapper launches its kernel from
``csrc/pin_kernels.cu`` (built at first use, see ``_build.py``) or raises;
for a CPU tensor it runs the twin, ``pin_lasso_solve_ref`` or
``cd_sweep_rows_ref``.  The twins are Python loops over coordinates with the
kernels' contract: the same update order, the same guarded soft threshold,
the same stopping rules, with scalar arithmetic in the tensors' dtype.

``launches`` counts kernel launches (never twin runs), so that a run can
show that its main path went through the kernels.
"""

import numpy as np
import torch

# the K1/K2 dispatch threshold of the JAX package, kept until re-measured
MAX_PALLAS_S = 1024

launches = {"pin_lasso_solve": 0, "cd_sweep_rows": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _scalar_dtype(t):
    try:
        return _NP_DTYPE[t.dtype]
    except KeyError:
        raise TypeError(
            f"pin kernels take float32 or float64, got {t.dtype}"
        ) from None


def _l1_l2(dt, lmda, alpha):
    lmda, alpha = dt(lmda), dt(alpha)
    return lmda * alpha, lmda * (dt(1.0) - alpha)


def _check_cuda(what, dtype, device, **tensors):
    for name, (t, want_dtype, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if t.dtype != (dtype if want_dtype is None else want_dtype):
            raise TypeError(f"{what}: {name} has dtype {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _route(t, what):
    """True for the kernel, False for the twin; raise for anything else."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or twin for device {t.device}")


# --------------------------------------------------------------------------- #
# K1: pin_lasso_solve                                                          #
# --------------------------------------------------------------------------- #


def pin_lasso_solve(A, grad, beta, diag, valid, active, penalty,
                    lmda, alpha, tol, max_iters, rsq):
    """The whole lasso pin solve at one lambda (positional, S <= 1024).

    ``A`` (S, S) symmetric; ``grad, beta, diag, penalty`` (S,) of A's dtype;
    ``valid, active`` (S,) bool.  Returns ``(beta, grad, active, info)``
    where ``info`` is a (3,) tensor of A's dtype holding
    ``(rsq, iters, done)``: read it with one host copy.
    """
    if not _route(A, "pin_lasso_solve"):
        return pin_lasso_solve_ref(A, grad, beta, diag, valid, active, penalty,
                                   lmda, alpha, tol, max_iters, rsq)
    dt = _scalar_dtype(A)
    S = A.shape[0]
    if A.dim() != 2 or A.shape[1] != S or not 1 <= S <= MAX_PALLAS_S:
        raise ValueError(
            f"pin_lasso_solve: A must be (S, S) with S <= {MAX_PALLAS_S}, "
            f"got {tuple(A.shape)}"
        )
    vec = (None, (S,))
    _check_cuda("pin_lasso_solve", A.dtype, A.device, A=(A, None, (S, S)),
                grad=(grad, *vec), beta=(beta, *vec), diag=(diag, *vec),
                penalty=(penalty, *vec), valid=(valid, torch.bool, (S,)),
                active=(active, torch.bool, (S,)))
    from .. import _build

    lib = _build.load()
    l1, l2 = _l1_l2(dt, lmda, alpha)
    beta_out = torch.empty_like(beta)
    grad_out = torch.empty_like(grad)
    active_out = torch.empty_like(active)
    info = torch.empty(3, dtype=A.dtype, device=A.device)
    fn = getattr(lib, f"adelie_pin_lasso_solve_{_SUFFIX[A.dtype]}")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(A.data_ptr(), diag.data_ptr(), penalty.data_ptr(),
                  valid.data_ptr(), active.data_ptr(), beta.data_ptr(),
                  grad.data_ptr(), beta_out.data_ptr(), grad_out.data_ptr(),
                  active_out.data_ptr(), info.data_ptr(), S, float(l1),
                  float(l2), float(dt(tol)), float(dt(rsq)), int(max_iters),
                  stream)
    _build.check(lib, code, "pin_lasso_solve")
    launches["pin_lasso_solve"] += 1
    return beta_out, grad_out, active_out, info


def pin_lasso_solve_ref(A, grad, beta, diag, valid, active, penalty,
                        lmda, alpha, tol, max_iters, rsq):
    """Plain twin of ``pin_lasso_solve``: same arguments, same results.

    Gauss-Seidel over ascending positions: an active phase (valid and
    active coordinates; at least one sweep, then until convg < tol_f, a
    floor-gated stall or max_iters) and one full sweep over the valid
    coordinates, repeated until a full sweep's convg < tol_f.
    """
    dt = _scalar_dtype(A)
    S = A.shape[0]
    l1, l2 = _l1_l2(dt, lmda, alpha)
    tol = dt(tol)
    max_iters = int(max_iters)
    diag_h = np.asarray(diag.tolist(), dt)
    pen_h = np.asarray(penalty.tolist(), dt)
    valid_h = np.asarray(valid.tolist(), bool)
    act_h = np.asarray(active.tolist(), bool)
    beta_h = np.asarray(beta.tolist(), dt)
    grad = grad.clone()
    rsq = dt(rsq)

    eps = dt(np.finfo(dt).eps)
    lam_cap = np.maximum(np.max(np.abs(diag_h)), dt(1.0))
    tol_f = np.maximum(tol, dt(100.0) * lam_cap * (dt(10.0) * eps) ** 2)
    stall_floor = dt(1e8) * lam_cap * eps * eps

    def sweep(active_only):
        nonlocal rsq
        convg = dt(0.0)
        for i in range(S):
            if not valid_h[i] or (active_only and not act_h[i]):
                continue
            b, g = beta_h[i], dt(grad[i].item())
            bnew = _soft_update(dt, b, g, diag_h[i], pen_h[i], l1, l2)
            d = bnew - b
            if d != 0:
                grad.sub_(A[i] * float(d))
                beta_h[i] = bnew
                act_h[i] = True
                convg = np.maximum(convg, diag_h[i] * d * d)
                rsq = rsq + d * (dt(2.0) * g - d * diag_h[i])
        return convg

    def next_slow(slow, convg, prev):
        return slow + 1 if convg >= dt(0.99) * prev else 0

    def stalled(slow, convg):
        return slow >= 3 and convg <= stall_floor

    convg, slow, iters, done = dt(np.inf), 0, 0, False
    while (not done and iters < max_iters and not stalled(slow, convg)
           and not np.isnan(convg)):
        prev = convg
        c = sweep(True)
        a_slow, it = 0, iters + 1
        while c >= tol_f and it < max_iters and not stalled(a_slow, c):
            a_prev = c
            c = sweep(True)
            a_slow = next_slow(a_slow, c, a_prev)
            it += 1
        iters = it
        convg = sweep(False)
        slow = next_slow(slow, convg, prev)
        iters += 1
        done = bool(convg < tol_f)
    done = (done or stalled(slow, convg)) and not np.isnan(convg)

    like = dict(dtype=A.dtype, device=A.device)
    info = torch.tensor([float(rsq), float(iters), float(done)], **like)
    return (torch.tensor(beta_h, **like), grad,
            torch.tensor(act_h, device=A.device), info)


def _soft_update(dt, b, g, akk, pk, l1, l2):
    """Guarded soft threshold: keep ``b`` where ``akk + l2 pk <= 0``."""
    u = g + akk * b
    mag = np.maximum(np.abs(u) - l1 * pk, dt(0.0))
    den = akk + l2 * pk
    return np.sign(u) * mag / den if den > 0 else b


# --------------------------------------------------------------------------- #
# K2: cd_sweep_rows                                                            #
# --------------------------------------------------------------------------- #


def cd_sweep_rows(A, beta, grad, pos, akk, pk, n, l1, l2, rsq):
    """One Gauss-Seidel pass over the listed updates ``k < n``.

    ``pos`` (C,) int32 positions in sweep order, ``akk, pk`` (C,) their
    diagonals and penalties, ``n`` a one-element int32 tensor on the same
    device (entries past it are never read).  Returns
    ``(beta, grad, moved, info)``: ``moved`` (C,) bool says whether update k
    changed its coordinate, ``info`` (2,) holds ``(convg, rsq)``.
    """
    if not _route(A, "cd_sweep_rows"):
        return cd_sweep_rows_ref(A, beta, grad, pos, akk, pk, n, l1, l2, rsq)
    dt = _scalar_dtype(A)
    S = A.shape[0]
    C = pos.shape[0]
    if A.dim() != 2 or A.shape[1] != S or C < 1:
        raise ValueError(
            f"cd_sweep_rows: A must be (S, S) and the list non-empty, got "
            f"A {tuple(A.shape)}, {C} updates"
        )
    _check_cuda("cd_sweep_rows", A.dtype, A.device, A=(A, None, (S, S)),
                beta=(beta, None, (S,)), grad=(grad, None, (S,)),
                pos=(pos, torch.int32, (C,)), akk=(akk, None, (C,)),
                pk=(pk, None, (C,)), n=(n.reshape(1), torch.int32, (1,)))
    from .. import _build

    lib = _build.load()
    beta_out = beta.clone()
    grad_out = grad.clone()
    moved = torch.empty(C, dtype=torch.bool, device=A.device)
    info = torch.empty(2, dtype=A.dtype, device=A.device)
    fn = getattr(lib, f"adelie_cd_sweep_rows_{_SUFFIX[A.dtype]}")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(A.data_ptr(), beta_out.data_ptr(), grad_out.data_ptr(),
                  pos.data_ptr(), akk.data_ptr(), pk.data_ptr(), n.data_ptr(),
                  moved.data_ptr(), info.data_ptr(), S, C, float(dt(l1)),
                  float(dt(l2)), float(dt(rsq)), stream)
    _build.check(lib, code, "cd_sweep_rows")
    launches["cd_sweep_rows"] += 1
    return beta_out, grad_out, moved, info


def cd_sweep_rows_ref(A, beta, grad, pos, akk, pk, n, l1, l2, rsq):
    """Plain twin of ``cd_sweep_rows``: same arguments, same results."""
    dt = _scalar_dtype(A)
    C = pos.shape[0]
    n = min(int(n.item()), C)
    l1, l2, rsq = dt(l1), dt(l2), dt(rsq)
    pos_h = pos.tolist()
    akk_h = np.asarray(akk.tolist(), dt)
    pk_h = np.asarray(pk.tolist(), dt)
    beta = beta.clone()
    grad = grad.clone()
    moved = [False] * C
    convg = dt(0.0)
    for k in range(n):
        p = pos_h[k]
        b, g = dt(beta[p].item()), dt(grad[p].item())
        bnew = _soft_update(dt, b, g, akk_h[k], pk_h[k], l1, l2)
        d = bnew - b
        beta[p] = float(bnew)
        if d != 0:
            moved[k] = True
            grad.sub_(A[p] * float(d))
            convg = np.maximum(convg, akk_h[k] * d * d)
            rsq = rsq + d * (dt(2.0) * g - d * akk_h[k])
    info = torch.tensor([float(convg), float(rsq)], dtype=A.dtype,
                        device=A.device)
    return beta, grad, torch.tensor(moved, device=A.device), info
