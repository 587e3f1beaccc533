"""Screen-set ("pin") solver in covariance form, groups of size 1.

Counterpart of the q = 1 parts of ``adelie_tpu/solver/pin.py``.  The screened
columns are gathered once per screen-set change into a dense block ``Xs``,
whose weighted (centered) Gram

    A = Xs^T diag(w) Xs - means means^T

carries the coordinate descent: with the centered gradient ``g`` the update
of coordinate i needs only ``g_i``, ``A[i, i]`` and, after it, the row AXPY
``g -= delta A[i, :]``.  The sweeps themselves are the two kernels of
``pin_kernels``: K1 runs the whole solve when S <= 1024, K2 each sweep
above.  Dispatch depends only on S, never on the device; the kernels'
wrappers decide between kernel and twin by the tensors' device.

Groups of size > 1 are not ported yet (queue 3 of ROADMAP.md).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..configs import matmul_precision
from .pin_kernels import MAX_PALLAS_S, cd_sweep_rows, pin_lasso_solve


def _q1_only(qmax):
    if qmax != 1:
        raise NotImplementedError(
            "groups of size > 1 are not ported yet (ROADMAP.md queue 3: "
            "groups of size > 1)"
        )


# --------------------------------------------------------------------------- #
# screen-set derived quantities                                                #
# --------------------------------------------------------------------------- #


def screen_gram(Xs, w, intercept: bool):
    """Weighted (optionally centered) Gram of the gathered screen block.

    ``Xs`` (n, S) with zero-padded columns; returns ``(A, means)`` with
    ``A = Xs^T diag(w) Xs - means means^T`` when ``intercept`` (w sums to 1).
    """
    with matmul_precision():
        means = w @ Xs
        A = Xs.T @ (Xs * w[:, None])
    if intercept:
        A = A - torch.outer(means, means)
    return A, means


def insert_cols(Xs, Xnew, s_old: int):
    """Write the new screen columns into the padded block at ``s_old``
    (in place: the block is owned by the screen cache)."""
    Xs[:, s_old:s_old + Xnew.shape[1]] = Xnew
    return Xs


def screen_gram_extend(A_pad, Xs, Xnew, w, means_pad, s_old: int,
                       intercept: bool):
    """Extend the screen Gram after the screen set grew by appending.

    The old Gram is the leading block of the new one, so only the cross
    block ``Xs^T diag(w) Xnew`` (S x dS) is formed and written into both
    off-diagonal strips of ``A_pad`` (in place; ``A_pad``/``means_pad`` are
    already padded to the new capacity, ``Xs`` already holds the new
    columns).  Returns ``(A, means)`` equal up to rounding to a full
    ``screen_gram`` of the extended block.
    """
    dS = Xnew.shape[1]
    with matmul_precision():
        means_new = w @ Xnew
        cross = Xs.T @ (Xnew * w[:, None])
    means_pad[s_old:s_old + dS] = means_new
    if intercept:
        cross = cross - means_pad[:, None] * means_new[None, :]
    A_pad[:, s_old:s_old + dS] = cross
    A_pad[s_old:s_old + dS, :] = cross.T
    return A_pad, means_pad


def screen_eigh(A, slot_begin, slot_size, qmax: int):
    """Per-slot "eigendecomposition" of the diagonal blocks, q = 1 branch:
    the eigenvalue is the clamped diagonal entry, the eigenvector 1.
    Invalid slots (size 0) get eigenvalue 0."""
    _q1_only(qmax)
    lam = torch.where(slot_size > 0, A[slot_begin, slot_begin],
                      torch.zeros((), dtype=A.dtype, device=A.device))
    lam = torch.clamp(lam, min=0.0)[:, None]
    return lam, torch.ones_like(lam)[:, :, None]


# --------------------------------------------------------------------------- #
# sweeps of the big-S regime (S > 1024): one K2 launch each                    #
# --------------------------------------------------------------------------- #


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
    permutation), and the True count as a device tensor: no host sync."""
    idx = torch.argsort((~mask).to(torch.int8), stable=True)
    return idx, mask.sum(dtype=torch.int32).reshape(1)


def _make_plan(mask, c: _Consts):
    """Compact ``mask`` into a sweep plan ``(idx, n, pos, akk, pk)``."""
    idx, n = _compact(mask)
    return (idx, n, c.slot_begin[idx].to(torch.int32),
            c.eigvals[idx, 0].contiguous(), c.penalty[idx].to(c.A.dtype))


def _sweep_q1(carry, c: _Consts, plan, update_active=True):
    """One Gauss-Seidel pass over the slots of ``plan``: one K2 launch and
    one host copy of ``(convg, rsq)``.  carry: (beta, grad, is_active, rsq);
    returns (beta, grad, is_active, rsq, convg)."""
    beta, grad, is_active, rsq = carry
    idx, n, pos, akk, pk = plan
    beta, grad, moved, info = cd_sweep_rows(c.A, beta, grad, pos, akk, pk, n,
                                            c.l1, c.l2, rsq)
    if update_active:
        # idx is a permutation and moved is False past n
        is_active = is_active.clone()
        is_active[idx] |= moved
    convg, rsq = info.tolist()
    return beta, grad, is_active, rsq, convg


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


# --------------------------------------------------------------------------- #
# the solve                                                                    #
# --------------------------------------------------------------------------- #


def _pin_lasso_dispatch(A, grad, beta, slot_begin, slot_size, eigvals,
                        penalty, is_active, lmda, alpha, tol, max_iters, rsq):
    """Adapt the (G_cap,) slot buffers to K1's (S,) positions: q = 1 means
    slot_begin[i] == i for valid slots; invalid slots scatter into the
    never-valid position S - 1."""
    S = A.shape[0]
    like = dict(dtype=A.dtype, device=A.device)
    m = slot_size > 0
    pos = torch.where(m, slot_begin, S - 1).long()
    diag_s = torch.zeros(S, **like)
    diag_s[pos] = torch.where(m, eigvals[:, 0], torch.zeros((), **like))
    pen_s = torch.ones(S, **like)
    pen_s[pos] = torch.where(m, penalty.to(A.dtype), torch.ones((), **like))
    valid_s = torch.zeros(S, dtype=torch.bool, device=A.device)
    valid_s[pos] = m
    act_s = torch.zeros(S, dtype=torch.bool, device=A.device)
    act_s[pos] = is_active & m

    beta_n, grad_n, act_n, info = pin_lasso_solve(
        A, grad.contiguous(), beta.contiguous(), diag_s, valid_s, act_s,
        pen_s, lmda, alpha, tol, max_iters, rsq,
    )
    rsq_n, iters, done = info.tolist()
    return beta_n, grad_n, act_n[pos] & m, rsq_n, int(iters), bool(done)


def pin_cov_solve(A, grad, beta, slot_begin, slot_size, eigvals, penalty,
                  is_active, lmda, alpha, tol, max_iters, rsq):
    """Solve the pinned lasso / elastic net at one lambda.

    Alternates (a) CD over the active set until ``convg < tol`` with (b)
    full screen-set sweeps that grow the active set, and stops when a full
    sweep converges (reference ``pin::naive::solve``).  ``A`` (S, S);
    ``grad, beta`` (S,); slot buffers (G_cap,); ``eigvals`` (G_cap, 1).
    Returns ``(beta, grad, is_active, rsq, iters, done)`` with the last
    three on the host.
    """
    _q1_only(eigvals.shape[1])
    S = A.shape[0]
    if S <= MAX_PALLAS_S:
        return _pin_lasso_dispatch(A, grad, beta, slot_begin, slot_size,
                                   eigvals, penalty, is_active, lmda, alpha,
                                   tol, max_iters, rsq)

    dt = np.float32 if A.dtype == torch.float32 else np.float64
    l1 = dt(lmda) * dt(alpha)
    l2 = dt(lmda) * (dt(1.0) - dt(alpha))
    # dtype-feasibility floor and floor-gated stall (see pin_kernels): a
    # stall exit needs three sweeps in a row improving convg by < 1% while
    # convg is already at the dtype's floor
    eps = dt(np.finfo(dt).eps)
    lam_max = np.maximum(dt(torch.max(torch.abs(eigvals)).item()), dt(1.0))
    tol = np.maximum(dt(tol), dt(100.0) * lam_max * (dt(10.0) * eps) ** 2)
    stall_floor = dt(1e8) * lam_max * eps * eps
    # Python floats (exact values of the dtype) to mix with tensors
    c = _Consts(A, slot_begin, slot_size, eigvals, penalty, float(l1),
                float(l2))

    def next_slow(slow, convg, prev):
        return slow + 1 if convg >= dt(0.99) * prev else 0

    def stalled(slow, convg):
        return slow >= 3 and convg <= stall_floor

    def active_phase(beta, grad, is_active, rsq, iters):
        # the active set is fixed during this phase: compact it once
        plan_a = _make_plan(is_active & (slot_size > 0), c)
        beta, grad, is_active, rsq, convg = _sweep_q1(
            (beta, grad, is_active, rsq), c, plan_a, update_active=False)
        convg, slow, it = dt(convg), 0, iters + 1
        while convg >= tol and it < max_iters and not stalled(slow, convg):
            prev = convg
            beta, grad, is_active, rsq, convg = _sweep_q1(
                (beta, grad, is_active, rsq), c, plan_a, update_active=False)
            convg = dt(convg)
            slow = next_slow(slow, convg, prev)
            it += 1
        return beta, grad, is_active, rsq, it

    convg, slow, iters, done = dt(np.inf), 0, 0, False
    while (not done and iters < max_iters and not stalled(slow, convg)
           and not np.isnan(convg)):
        prev = convg
        beta, grad, is_active, rsq, iters = active_phase(
            beta, grad, is_active, rsq, iters)
        beta, grad, is_active, rsq, convg = _full_sweep_q1(
            (beta, grad, is_active, rsq), c)
        convg = dt(convg)
        slow = next_slow(slow, convg, prev)
        iters += 1
        done = bool(convg < tol)
    # a floor-gated stall is convergence at the dtype's floor; NaN is failure
    done = (done or stalled(slow, convg)) and not np.isnan(convg)
    return beta, grad, is_active, rsq, iters, done
