"""Screen-set ("pin") solver in covariance form, groups of size 1.

Counterpart of the q = 1 parts of ``adelie_tpu/solver/pin.py``.  The screened
columns are gathered once per screen-set change into a dense block ``Xs``,
whose weighted (centered) Gram

    A = Xs^T diag(w) Xs - means means^T

carries the coordinate descent: with the centered gradient ``g`` the update
of coordinate i needs only ``g_i``, ``A[i, i]`` and, after it, the row AXPY
``g -= delta A[i, :]``.  Each solve is one launch of one of the two
kernels of ``pin_kernels``, K1 when S <= 1024 and K2 above, both on the
screen's slot buffers as they are, and one host copy of
``(rsq, iters, done)`` after it.  Dispatch depends only on S,
never on the device; the kernels' wrappers decide between kernel and twin
by the tensors' device.

Groups of size > 1 are not ported yet (queue 3 of ROADMAP.md).
"""

import torch

from ..configs import matmul_precision
from .pin_kernels import MAX_PALLAS_S, pin_lasso_solve, pin_lasso_solve_rows


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
# the solve                                                                    #
# --------------------------------------------------------------------------- #


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
    solve = (pin_lasso_solve if A.shape[0] <= MAX_PALLAS_S
             else pin_lasso_solve_rows)
    beta, grad, is_active, info = solve(
        A, grad.contiguous(), beta.contiguous(), slot_begin, slot_size,
        eigvals, penalty, is_active, lmda, alpha, tol, max_iters, rsq,
    )
    rsq_n, iters, done = info.tolist()
    return beta, grad, is_active, rsq_n, int(iters), bool(done)
