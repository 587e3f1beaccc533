"""The two lasso pin-solve kernels, their plain PyTorch twins and counters.

Counterpart of ``adelie_tpu/solver/pin_pallas.py`` and of the big-S loop
of ``adelie_tpu/solver/pin.py:pin_cov_solve``:

* ``pin_lasso_solve`` (K1) runs the whole q = 1 pin solve at one lambda
  for a screen capacity S <= ``MAX_PALLAS_S``;
* ``pin_lasso_solve_rows`` (K2) runs the whole q = 1 pin solve at one
  lambda above it, with the Gram's rows streamed through shared memory
  (it replaces ``cd_sweep_rows_pallas``, one launch per sweep on the TPU,
  together with the host loop around it).

Both take the screen's slot buffers as they are (``slot_begin, slot_size,
eigvals, penalty, is_active``) and differ in the full sweep: K1 updates
every valid slot at the current gradient, as ``pin_lasso_solve_pallas``
does; K2 first filters the slots by a proposal at the sweep-entry
gradient, as the JAX package's big-S loop does.

For a CUDA tensor each wrapper launches its kernel from
``csrc/pin_kernels.cu`` (built at first use, see ``_build.py``) or raises;
for a CPU tensor it runs the twin, ``pin_lasso_solve_ref`` or
``pin_lasso_solve_rows_ref``.  The twins are Python loops over coordinates
with the kernels' contract: the same update order, the same guarded soft
threshold, the same stopping rules, with scalar arithmetic in the tensors'
dtype.  The twins share one loop and run each pass as
``cd_sweep_rows_ref``, the plain version of the JAX package's
``cd_sweep_rows_pallas``.

``launches`` counts kernel launches (never twin runs), so that a run can
show that its main path went through the kernels.
"""

from dataclasses import dataclass

import numpy as np
import torch

# the K1/K2 dispatch threshold of the JAX package, kept until re-measured
MAX_PALLAS_S = 1024

launches = {"pin_lasso_solve": 0, "pin_lasso_solve_rows": 0}

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


def _check_slot_args(what, A, grad, beta, slot_begin, slot_size, eigvals,
                     penalty, is_active):
    """K1's and K2's common checks of a kernel launch; returns the slot
    buffers in the kernels' dtypes (no-ops on the main path)."""
    S = A.shape[0]
    G = slot_size.shape[0]
    if A.data_ptr() % 16:
        raise ValueError(f"{what}: A must start on a 16-byte boundary (its "
                         "rows are copied 16 bytes at a time)")
    slot_begin = slot_begin.to(torch.int64)
    slot_size = slot_size.to(torch.int32)
    penalty = penalty.to(A.dtype)
    vec = (None, (S,))
    _check_cuda(what, A.dtype, A.device, A=(A, None, (S, S)),
                grad=(grad, *vec), beta=(beta, *vec),
                slot_begin=(slot_begin, torch.int64, (G,)),
                slot_size=(slot_size, torch.int32, (G,)),
                eigvals=(eigvals, None, (G, 1)), penalty=(penalty, None, (G,)),
                is_active=(is_active, torch.bool, (G,)))
    return slot_begin, slot_size, penalty


def pin_lasso_solve(A, grad, beta, slot_begin, slot_size, eigvals, penalty,
                    is_active, lmda, alpha, tol, max_iters, rsq):
    """The whole lasso pin solve at one lambda for a screen capacity
    4 <= S <= ``MAX_PALLAS_S`` with S a multiple of 4.

    The arguments are ``pin_lasso_solve_rows``'s: ``A`` (S, S) symmetric;
    ``grad, beta`` (S,) of A's dtype; the slot buffers ``slot_begin,
    slot_size, penalty, is_active`` (G,) and ``eigvals`` (G, 1).  Returns
    ``(beta, grad, is_active, info)``: ``is_active`` (G,) bool, ``info`` a
    (3,) tensor of A's dtype holding ``(rsq, iters, done)``; read it with
    one host copy.
    """
    if not _route(A, "pin_lasso_solve"):
        return pin_lasso_solve_ref(A, grad, beta, slot_begin, slot_size,
                                   eigvals, penalty, is_active, lmda, alpha,
                                   tol, max_iters, rsq)
    dt = _scalar_dtype(A)
    S = A.shape[0]
    G = slot_size.shape[0]
    if (A.dim() != 2 or A.shape[1] != S or not 4 <= S <= MAX_PALLAS_S
            or S % 4 or G < 1):
        raise ValueError(
            f"pin_lasso_solve: A must be (S, S) with 4 <= S <= "
            f"{MAX_PALLAS_S} a multiple of 4, and G >= 1 slots; got A "
            f"{tuple(A.shape)}, G = {G}"
        )
    slot_begin, slot_size, penalty = _check_slot_args(
        "pin_lasso_solve", A, grad, beta, slot_begin, slot_size, eigvals,
        penalty, is_active)
    from .. import _build

    lib = _build.load()
    l1, l2 = _l1_l2(dt, lmda, alpha)
    beta_out = torch.empty_like(beta)
    grad_out = torch.empty_like(grad)
    active_out = torch.empty_like(is_active)
    info = torch.empty(3, dtype=A.dtype, device=A.device)
    fn = getattr(lib, f"adelie_pin_lasso_solve_{_SUFFIX[A.dtype]}")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(A.data_ptr(), beta.data_ptr(), grad.data_ptr(),
                  slot_begin.data_ptr(), slot_size.data_ptr(),
                  eigvals.data_ptr(), penalty.data_ptr(),
                  is_active.data_ptr(), beta_out.data_ptr(),
                  grad_out.data_ptr(), active_out.data_ptr(), info.data_ptr(),
                  S, G, float(l1), float(l2), float(dt(tol)), float(dt(rsq)),
                  int(max_iters), stream)
    _build.check(lib, code, "pin_lasso_solve")
    launches["pin_lasso_solve"] += 1
    return beta_out, grad_out, active_out, info


def pin_lasso_solve_ref(A, grad, beta, slot_begin, slot_size, eigvals,
                        penalty, is_active, lmda, alpha, tol, max_iters, rsq):
    """Plain twin of ``pin_lasso_solve``: same arguments, same results.

    The active phase sweeps ``is_active & valid`` in ascending slot order
    (at least once, then until convg < tol_f, a floor-gated stall or
    max_iters); a full sweep over every valid slot follows, at the current
    gradient, and its moved slots become active; both repeat until a full
    sweep's convg < tol_f.  Each sweep is one ``cd_sweep_rows_ref``.
    """
    return _pin_solve_ref(A, grad, beta, slot_begin, slot_size, eigvals,
                          penalty, is_active, lmda, alpha, tol, max_iters,
                          rsq, _plain_full_sweep_q1)


def _soft_update(dt, b, g, akk, pk, l1, l2):
    """Guarded soft threshold: keep ``b`` where ``akk + l2 pk <= 0``."""
    u = g + akk * b
    mag = np.maximum(np.abs(u) - l1 * pk, dt(0.0))
    den = akk + l2 * pk
    return np.sign(u) * mag / den if den > 0 else b


# --------------------------------------------------------------------------- #
# K2: pin_lasso_solve_rows                                                     #
# --------------------------------------------------------------------------- #

def pin_lasso_solve_rows(A, grad, beta, slot_begin, slot_size, eigvals,
                         penalty, is_active, lmda, alpha, tol, max_iters,
                         rsq):
    """The whole lasso pin solve at one lambda for a screen capacity
    S > ``MAX_PALLAS_S`` with S a multiple of 4.

    ``A`` (S, S) symmetric; ``grad, beta`` (S,) of A's dtype; the slot
    buffers ``slot_begin, slot_size, penalty, is_active`` (G,) and
    ``eigvals`` (G, 1).  Returns ``(beta, grad, is_active, info)``:
    ``is_active`` (G,) bool, ``info`` a (3,) tensor of A's dtype holding
    ``(rsq, iters, done)``; read it with one host copy.
    """
    if not _route(A, "pin_lasso_solve_rows"):
        return pin_lasso_solve_rows_ref(A, grad, beta, slot_begin, slot_size,
                                        eigvals, penalty, is_active, lmda,
                                        alpha, tol, max_iters, rsq)
    dt = _scalar_dtype(A)
    S = A.shape[0]
    G = slot_size.shape[0]
    if (A.dim() != 2 or A.shape[1] != S or S <= MAX_PALLAS_S or S % 4
            or G < 1):
        raise ValueError(
            f"pin_lasso_solve_rows: A must be (S, S) with S > {MAX_PALLAS_S} "
            f"a multiple of 4, and G >= 1 slots; got A {tuple(A.shape)}, "
            f"G = {G}"
        )
    slot_begin, slot_size, penalty = _check_slot_args(
        "pin_lasso_solve_rows", A, grad, beta, slot_begin, slot_size,
        eigvals, penalty, is_active)
    from .. import _build

    lib = _build.load()
    l1, l2 = _l1_l2(dt, lmda, alpha)
    like = dict(dtype=A.dtype, device=A.device)
    beta_out = torch.empty_like(beta)
    grad_out = torch.empty_like(grad)
    active_out = torch.empty_like(is_active)
    info = torch.empty(3, **like)
    # per-position diagonal, penalty and slot, filled by the kernel, and
    # a pass's list when it does not fit in shared memory
    akk_p = torch.empty(S, **like)
    pk_p = torch.empty(S, **like)
    slot_p = torch.empty(S, dtype=torch.int32, device=A.device)
    plan = torch.empty(S, dtype=torch.int32, device=A.device)
    fn = getattr(lib, f"adelie_pin_lasso_solve_rows_{_SUFFIX[A.dtype]}")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(A.data_ptr(), beta.data_ptr(), grad.data_ptr(),
                  slot_begin.data_ptr(), slot_size.data_ptr(),
                  eigvals.data_ptr(), penalty.data_ptr(),
                  is_active.data_ptr(), beta_out.data_ptr(),
                  grad_out.data_ptr(), active_out.data_ptr(), info.data_ptr(),
                  akk_p.data_ptr(), pk_p.data_ptr(), slot_p.data_ptr(),
                  plan.data_ptr(), S, G, float(l1), float(l2),
                  float(dt(tol)), float(dt(rsq)), int(max_iters), stream)
    _build.check(lib, code, "pin_lasso_solve_rows")
    launches["pin_lasso_solve_rows"] += 1
    return beta_out, grad_out, active_out, info


def pin_lasso_solve_rows_ref(A, grad, beta, slot_begin, slot_size, eigvals,
                             penalty, is_active, lmda, alpha, tol, max_iters,
                             rsq):
    """Plain twin of ``pin_lasso_solve_rows``: same arguments, same results.

    K1's twin with the filtered full sweep (``_full_sweep_q1``) in place of
    the plain one: the active phase compacts ``is_active & valid`` into an
    ascending list once and sweeps it (at least once, then until convg <
    tol_f, a floor-gated stall or max_iters); the filtered full sweep
    follows; both repeat until a full sweep's convg < tol_f.  Each pass is
    one ``cd_sweep_rows_ref`` over its list.
    """
    return _pin_solve_ref(A, grad, beta, slot_begin, slot_size, eigvals,
                          penalty, is_active, lmda, alpha, tol, max_iters,
                          rsq, _full_sweep_q1)


def _pin_solve_ref(A, grad, beta, slot_begin, slot_size, eigvals, penalty,
                   is_active, lmda, alpha, tol, max_iters, rsq, full_sweep):
    """The twins' loop: active phases and ``full_sweep`` passes."""
    dt = _scalar_dtype(A)
    l1, l2 = _l1_l2(dt, lmda, alpha)
    # Python floats (exact values of the dtype) to mix with tensors
    c = _Consts(A, slot_begin, slot_size, eigvals, penalty, float(l1),
                float(l2))

    def active_sweep(carry):
        # the active set is fixed during this phase: compact it once
        plan_a = _make_plan(carry[2] & (slot_size > 0), c)
        return lambda carry: _sweep_q1(carry, c, plan_a, update_active=False)

    (beta, grad, is_active, rsq), iters, done = solve_loop(
        dt, dt(torch.max(torch.abs(eigvals)).item()), tol, max_iters,
        (beta, grad, is_active, rsq), active_sweep,
        lambda carry: full_sweep(carry, c))
    info = torch.tensor([float(rsq), float(iters), float(done)],
                        dtype=A.dtype, device=A.device)
    return beta, grad, is_active, info


def solve_loop(dt, abs_eig_max, tol, max_iters, carry, active_sweep,
               full_sweep):
    """The outer loop of every pin solve's twin (``pin_cov_solve`` of the
    JAX package): an active phase (at least one sweep, then until
    convg < tol_f, a floor-gated stall or ``max_iters``) and a full sweep,
    repeated until a full sweep's convg < tol_f, a stall, ``max_iters`` or
    a NaN.  ``carry`` is ``(beta, grad, is_active, rsq)``;
    ``active_sweep(carry)`` starts a phase and returns its sweep, and a
    sweep or ``full_sweep(carry)`` returns the carry and its convg.
    ``abs_eig_max`` is max |eigvals|.  Returns ``(carry, iters, done)``."""
    # dtype-feasibility floor and floor-gated stall: a stall exit needs
    # three sweeps in a row improving convg by < 1% while convg is
    # already at the dtype's floor
    eps = dt(np.finfo(dt).eps)
    lam_max = np.maximum(abs_eig_max, dt(1.0))
    tol = np.maximum(dt(tol), dt(100.0) * lam_max * (dt(10.0) * eps) ** 2)
    stall_floor = dt(1e8) * lam_max * eps * eps

    def next_slow(slow, convg, prev):
        return slow + 1 if convg >= dt(0.99) * prev else 0

    def stalled(slow, convg):
        return slow >= 3 and convg <= stall_floor

    def active_phase(carry, iters):
        sweep = active_sweep(carry)
        *carry, convg = sweep(carry)
        convg, slow, it = dt(convg), 0, iters + 1
        while convg >= tol and it < max_iters and not stalled(slow, convg):
            prev = convg
            *carry, convg = sweep(carry)
            convg = dt(convg)
            slow = next_slow(slow, convg, prev)
            it += 1
        return carry, it

    convg, slow, iters, done = dt(np.inf), 0, 0, False
    while (not done and iters < max_iters and not stalled(slow, convg)
           and not np.isnan(convg)):
        prev = convg
        carry, iters = active_phase(carry, iters)
        *carry, convg = full_sweep(carry)
        convg = dt(convg)
        slow = next_slow(slow, convg, prev)
        iters += 1
        done = bool(convg < tol)
    # a floor-gated stall is convergence at the dtype's floor; NaN is failure
    done = (done or stalled(slow, convg)) and not np.isnan(convg)
    return tuple(carry), iters, done


@dataclass
class _Consts:
    A: torch.Tensor
    slot_begin: torch.Tensor
    slot_size: torch.Tensor
    eigvals: torch.Tensor
    penalty: torch.Tensor
    l1: float
    l2: float


def _compact(mask):
    """The True slots in ascending order followed by the others (a
    permutation), and the True count as a one-element tensor."""
    idx = torch.argsort((~mask).to(torch.int8), stable=True)
    return idx, mask.sum(dtype=torch.int32).reshape(1)


def _make_plan(mask, c: _Consts):
    """Compact ``mask`` into a sweep plan ``(idx, n, pos, akk, pk)``."""
    idx, n = _compact(mask)
    return (idx, n, c.slot_begin[idx].to(torch.int32),
            c.eigvals[idx, 0].contiguous(), c.penalty[idx].to(c.A.dtype))


def _sweep_q1(carry, c: _Consts, plan, update_active=True):
    """One Gauss-Seidel pass over the slots of ``plan``.  carry: (beta,
    grad, is_active, rsq); returns (beta, grad, is_active, rsq, convg)."""
    beta, grad, is_active, rsq = carry
    idx, n, pos, akk, pk = plan
    beta, grad, moved, info = cd_sweep_rows_ref(c.A, beta, grad, pos, akk,
                                                pk, n, c.l1, c.l2, rsq)
    if update_active:
        # idx is a permutation and moved is False past n
        is_active = is_active.clone()
        is_active[idx] |= moved
    convg, rsq = info.tolist()
    return beta, grad, is_active, rsq, convg


def _plain_full_sweep_q1(carry, c: _Consts):
    """K1's screen-set sweep: every valid slot, in ascending order, at the
    current gradient."""
    return _sweep_q1(carry, c, _make_plan(c.slot_size > 0, c))


def _full_sweep_q1(carry, c: _Consts):
    """Screen-set sweep with a vectorised selection: one soft-threshold
    proposal at the sweep-entry gradient picks the slots that want to move,
    and only those run the sequential pass.  A slot the stale proposal
    misses is caught by the next full sweep, and a pass that moves nothing
    leaves the gradient untouched, so stale equals fresh at the end."""
    beta, grad = carry[0], carry[1]
    zero = torch.zeros((), dtype=c.A.dtype, device=c.A.device)
    valid = c.slot_size > 0
    pos = torch.where(valid, c.slot_begin, 0)
    akk = c.eigvals[:, 0]
    bk = torch.where(valid, beta[pos], zero)
    gk = torch.where(valid, grad[pos], zero)
    u = gk + akk * bk
    vthr = torch.abs(u) - c.l1 * c.penalty
    denom = akk + c.l2 * c.penalty
    bnew = torch.where(
        vthr > 0, torch.sign(u) * vthr / torch.where(denom > 0, denom, 1.0),
        zero,
    )
    sel = valid & (bnew != bk)
    return _sweep_q1(carry, c, _make_plan(sel, c))


def cd_sweep_rows_ref(A, beta, grad, pos, akk, pk, n, l1, l2, rsq):
    """One Gauss-Seidel pass over the listed updates ``k < n``: the inner
    pass of ``pin_lasso_solve_rows_ref``.

    ``pos`` (C,) int32 positions in sweep order, ``akk, pk`` (C,) their
    diagonals and penalties, ``n`` a one-element int32 tensor (entries past
    it are never read).  Returns ``(beta, grad, moved, info)``: ``moved``
    (C,) bool says whether update k changed its coordinate, ``info`` (2,)
    holds ``(convg, rsq)``.
    """
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
