"""The grouped pin-solve kernel (K6), its plain twin and its counters.

``pin_group_solve`` runs the whole pin solve at one lambda when the
screen's padded block width ``qmax`` is above 1: every group, size-1 groups
included, takes the block update of ``bcd.newton_solver`` (``newton_abs``)
in its eigenbasis.  It computes what the JAX package's ``pin_cov_solve``
computes in its grouped branch, the XLA loop of
``adelie_tpu/solver/pin.py:_sweep`` (:232-303) with the outer loop of
``pin_cov_solve`` (:490-594).  The JAX package has no Pallas kernel for it
(its grouped kernel was removed, ``pin.py:486-489``); in PyTorch the same
loop would cost several launches and a host round trip a group update, so
the port runs it as one CUDA kernel (``csrc/pin_group_kernels.cu``).

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it runs the twin, ``pin_group_solve_ref``.  The twin keeps the
kernel's contract and its order of operations: the same lists of slots,
the rotations summed coordinate by coordinate, every block sum in the
order of the kernel's warp reduction (``bcd.lane_sum``), the Gram's rows
``b .. b+q`` summed into the gradient update in order; it runs on the host
in numpy scalars of the tensors' dtype.

``launches`` counts kernel launches (never twin runs).  ``newton``
accumulates, over the solves that ``solver/pin.py`` reads, the group
updates, the Newton root finds (updates that are neither 0 nor the ridge
closed form), their Newton steps and a histogram of steps a find
(``NEWTON_BINS``: 0, [1, 2), [2, 4), ..., [512, 1024), and
``newton_max_iters`` or more), all counted as the full walks take them;
then the steps actually run (``steps_run``) and the finds that ended by
the cycle rule of ``bcd._newton_phase`` (``cycle_exits``), which the
kernel and the twin share.  ``reset_newton()`` zeroes it.
"""

import numpy as np
import torch

from ..bcd import block_update_np, lane_sum
from .pin_kernels import _check_cuda, _l1_l2, _route, _scalar_dtype, solve_loop

# the widest padded block the kernel takes: nine vectors of this length sit
# in its shared memory
MAX_QMAX = 1024
NEWTON_BINS = 12
# info: rsq, iters, done, updates, Newton finds, Newton steps, histogram,
# Newton steps run, cycle exits
INFO_LEN = 8 + NEWTON_BINS

launches = {"pin_group_solve": 0}
newton = {}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_newton():
    newton.update(updates=0, solves=0, iters=0, hist=[0] * NEWTON_BINS,
                  steps_run=0, cycle_exits=0)


reset_newton()


def record_newton(info):
    """Add a solve's counts (``info`` read to the host as a list)."""
    newton["updates"] += int(info[3])
    newton["solves"] += int(info[4])
    newton["iters"] += int(info[5])
    newton["hist"] = [h + int(x) for h, x in
                      zip(newton["hist"], info[6:6 + NEWTON_BINS])]
    newton["steps_run"] += int(info[6 + NEWTON_BINS])
    newton["cycle_exits"] += int(info[7 + NEWTON_BINS])


def newton_bin(iters, max_iters):
    """The histogram bin of a root find that took ``iters`` steps."""
    if iters >= max_iters:
        return NEWTON_BINS - 1
    return min(int(iters).bit_length(), NEWTON_BINS - 2)


def pin_group_solve(A, grad, beta, slot_begin, slot_size, eigvals, eigvecs,
                    penalty, is_active, lmda, alpha, tol, dbeta_tol,
                    newton_tol, newton_max_iters, max_iters, rsq):
    """The whole grouped pin solve at one lambda.

    ``A`` (S, S) symmetric; ``grad, beta`` (S,) of A's dtype; the slot
    buffers ``slot_begin, slot_size, penalty, is_active`` (G,),
    ``eigvals`` (G, qmax) and ``eigvecs`` (G, qmax, qmax) with ``qmax`` a
    power of 2 up to ``MAX_QMAX`` (on the card).  Returns ``(beta, grad,
    is_active, info)``: ``info`` a float64 tensor of ``INFO_LEN`` holding
    ``(rsq, iters, done, updates, Newton finds, Newton steps, histogram,
    Newton steps run, cycle exits)``; read it with one host copy.
    """
    if not _route(A, "pin_group_solve"):
        return pin_group_solve_ref(A, grad, beta, slot_begin, slot_size,
                                   eigvals, eigvecs, penalty, is_active, lmda,
                                   alpha, tol, dbeta_tol, newton_tol,
                                   newton_max_iters, max_iters, rsq)
    dt = _scalar_dtype(A)
    S = A.shape[0]
    G, qmax = eigvals.shape
    if (A.dim() != 2 or A.shape[1] != S or S < 1 or G < 1
            or qmax & (qmax - 1) or not 1 <= qmax <= MAX_QMAX):
        raise ValueError(
            f"pin_group_solve: A must be (S, S) with S >= 1, G >= 1 slots "
            f"and qmax a power of 2 up to {MAX_QMAX}; got A "
            f"{tuple(A.shape)}, eigvals {tuple(eigvals.shape)}")
    slot_begin = slot_begin.to(torch.int64)
    slot_size = slot_size.to(torch.int32)
    penalty = penalty.to(A.dtype)
    vec = (None, (S,))
    _check_cuda("pin_group_solve", A.dtype, A.device, A=(A, None, (S, S)),
                grad=(grad, *vec), beta=(beta, *vec),
                slot_begin=(slot_begin, torch.int64, (G,)),
                slot_size=(slot_size, torch.int32, (G,)),
                eigvals=(eigvals, None, (G, qmax)),
                eigvecs=(eigvecs, None, (G, qmax, qmax)),
                penalty=(penalty, None, (G,)),
                is_active=(is_active, torch.bool, (G,)))
    from .. import _build

    lib = _build.load()
    l1, l2 = _l1_l2(dt, lmda, alpha)
    beta_out = torch.empty_like(beta)
    grad_out = torch.empty_like(grad)
    active_out = torch.empty_like(is_active)
    info = torch.empty(INFO_LEN, dtype=torch.float64, device=A.device)
    # the two lists of slots, when they do not fit in shared memory
    lists = torch.empty(2 * G, dtype=torch.int32, device=A.device)
    fn = getattr(lib, f"adelie_pin_group_solve_{_SUFFIX[A.dtype]}")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(A.data_ptr(), beta.data_ptr(), grad.data_ptr(),
                  slot_begin.data_ptr(), slot_size.data_ptr(),
                  eigvals.data_ptr(), eigvecs.data_ptr(), penalty.data_ptr(),
                  is_active.data_ptr(), beta_out.data_ptr(),
                  grad_out.data_ptr(), active_out.data_ptr(), info.data_ptr(),
                  lists.data_ptr(), S, G, qmax, float(l1), float(l2),
                  float(dt(tol)), float(dt(dbeta_tol)), float(dt(newton_tol)),
                  float(dt(rsq)), int(newton_max_iters), int(max_iters),
                  stream)
    _build.check(lib, code, "pin_group_solve")
    launches["pin_group_solve"] += 1
    return beta_out, grad_out, active_out, info


def pin_group_solve_ref(A, grad, beta, slot_begin, slot_size, eigvals,
                        eigvecs, penalty, is_active, lmda, alpha, tol,
                        dbeta_tol, newton_tol, newton_max_iters, max_iters,
                        rsq):
    """Plain twin of ``pin_group_solve``: same arguments, same results.

    The loop of ``pin_kernels.solve_loop``: the active phase sweeps
    ``is_active & valid`` in ascending slot order, the full sweep every
    valid slot (the JAX package filters the full sweep only at qmax = 1);
    each sweep is ``_group_sweep``.
    """
    dt = _scalar_dtype(A)
    l1, l2 = _l1_l2(dt, lmda, alpha)
    host = [t.detach().cpu().numpy() for t in (
        A, slot_begin, slot_size, eigvals, eigvecs, penalty)]
    A_h, begin_h, size_h, lam_h, V_h, pen_h = host
    pen_h = pen_h.astype(dt)
    valid = size_h > 0
    c = dict(A=A_h, begin=begin_h, size=size_h, lam=lam_h, V=V_h, pen=pen_h,
             l1=l1, l2=l2, dbeta_tol=dt(dbeta_tol), ntol=dt(newton_tol),
             nmax=int(newton_max_iters),
             counts=np.zeros(5 + NEWTON_BINS, np.int64))
    carry = (beta.detach().cpu().numpy().copy(),
             grad.detach().cpu().numpy().copy(),
             is_active.detach().cpu().numpy().copy(), dt(rsq))
    valid_list = np.flatnonzero(valid)

    def active_sweep(carry):
        # the active set is fixed during this phase: list it once
        listed = np.flatnonzero(carry[2] & valid)
        return lambda carry: _group_sweep(carry, c, listed)

    (beta_h, grad_h, active_h, rsq_h), iters, done = solve_loop(
        dt, dt(np.max(np.abs(lam_h), initial=0.0)), tol, max_iters, carry,
        active_sweep, lambda carry: _group_sweep(carry, c, valid_list))
    dev = A.device
    info = torch.tensor([float(rsq_h), float(iters), float(done),
                         *map(float, c["counts"])], dtype=torch.float64,
                        device=dev)
    return (torch.as_tensor(beta_h, device=dev),
            torch.as_tensor(grad_h, device=dev),
            torch.as_tensor(active_h, device=dev), info)


def _group_sweep(carry, c, listed):
    """One Gauss-Seidel pass over the slots ``listed``, in order (the
    JAX package's ``_sweep`` body).  Returns (beta, grad, is_active, rsq,
    convg); ``beta``, ``grad`` and ``is_active`` change in place."""
    beta, grad, is_active, rsq = carry
    A, V_all, lam_all = c["A"], c["V"], c["lam"]
    dt = A.dtype.type
    S = A.shape[0]
    qmax = lam_all.shape[1]
    counts = c["counts"]
    convg = dt(0.0)
    for i in listed:
        b, q = int(c["begin"][i]), int(c["size"][i])
        V, lam = V_all[i], lam_all[i]
        pk = c["pen"][i]
        beta_g = beta[b:b + q].copy()
        grad_g = grad[b:b + q]
        # V^T beta_g and V^T grad_g, summed over the block's coordinates
        beta_t = np.zeros(qmax, dt)
        g_t = np.zeros(qmax, dt)
        for j in range(q):
            beta_t = beta_t + V[j] * beta_g[j]
            g_t = g_t + V[j] * grad_g[j]
        v_t = g_t + lam * beta_t
        x_t, iters, general, run, cycled = block_update_np(
            lam, v_t, c["l1"] * pk, c["l2"] * pk, c["ntol"], c["nmax"])
        counts[0] += 1
        if general:
            counts[1] += 1
            counts[2] += iters
            counts[3 + newton_bin(iters, c["nmax"])] += 1
            counts[3 + NEWTON_BINS] += run
            counts[4 + NEWTON_BINS] += cycled
        d_t = x_t - beta_t
        # skip threshold: exact 0 for q = 1, dbeta_tol^2 q above
        thresh = c["dbeta_tol"] * c["dbeta_tol"] * dt(q) if q > 1 \
            else dt(0.0)
        if not lane_sum(d_t * d_t) > thresh:
            continue
        convg = np.maximum(convg, lane_sum(lam * d_t * d_t) / dt(q))
        rsq = rsq + lane_sum(d_t * (dt(2.0) * g_t - d_t * lam))
        beta_new = np.zeros(q, dt)
        for k in range(qmax):
            beta_new = beta_new + V[:q, k] * x_t[k]
        dbeta = beta_new - beta_g
        # grad -= A[:, b:b+q] dbeta, from the rows b..b+q of the symmetric A
        acc = np.zeros(S, dt)
        for j in range(q):
            acc = acc + A[b + j] * dbeta[j]
        grad -= acc
        beta[b:b + q] = beta_new
        is_active[i] = True
    return beta, grad, is_active, rsq, convg
