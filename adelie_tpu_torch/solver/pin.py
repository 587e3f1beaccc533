"""Screen-set ("pin") solver in covariance form.

Counterpart of ``adelie_tpu/solver/pin.py``.  The screened
columns are gathered once per screen-set change into a dense block ``Xs``,
whose weighted (centered) Gram

    A = Xs^T diag(w) Xs - means means^T

carries the block coordinate descent: with the centered gradient ``g`` the
update of a group at positions ``b .. b+q`` needs only ``g[b:b+q]``, its
diagonal block of ``A`` (through the block's eigendecomposition, one
batched ``eigh`` a screen) and, after it, ``g -= A[:, b:b+q] dbeta``.

Each solve is one kernel launch and one host copy of its ``info`` after it.
The dispatch depends on the screen's padded block width ``qmax`` and on S,
never on the device: ``qmax == 1`` runs K1 (S <= 1024) or K2 (above) of
``pin_kernels``, the closed-form lasso update; ``qmax > 1`` runs K6 of
``pin_group_kernels`` for every group, size-1 groups included, as the JAX
package's grouped sweep does.  The kernels' wrappers decide between kernel
and twin by the tensors' device.
"""

import torch

from ..configs import matmul_precision
from .pin_group_kernels import pin_group_solve, record_newton
from .pin_kernels import MAX_PALLAS_S, pin_lasso_solve, pin_lasso_solve_rows


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
    """Batched eigendecomposition of the slots' diagonal blocks of ``A``.

    Returns ``(eigvals (G, qmax), eigvecs (G, qmax, qmax))``.  Each block is
    ``A[b:b+qmax, b:b+qmax]`` with the rows and columns past the slot's
    size zeroed (reference per-group ``SelfAdjointEigenSolver``,
    solver_gaussian_naive.hpp:113): one batched ``torch.linalg.eigh``, the
    padding giving eigenvalue 0, which the block update treats as inert.
    Negative eigenvalues are clamped to 0 (reference :127-131).  At
    ``qmax == 1`` the eigenvalue is the clamped diagonal and the vector 1.
    Invalid slots (size 0) get eigenvalues 0.
    """
    if qmax == 1:
        lam = torch.where(slot_size > 0, A[slot_begin, slot_begin],
                          torch.zeros((), dtype=A.dtype, device=A.device))
        lam = torch.clamp(lam, min=0.0)[:, None]
        return lam, torch.ones_like(lam)[:, :, None]
    S = A.shape[0]
    lane = torch.arange(qmax, device=A.device)
    idx = torch.clamp(slot_begin[:, None] + lane, max=S - 1)   # (G, qmax)
    mask = lane[None, :] < slot_size[:, None]
    blocks = A[idx[:, :, None], idx[:, None, :]]
    blocks = torch.where(mask[:, :, None] & mask[:, None, :], blocks,
                         torch.zeros((), dtype=A.dtype, device=A.device))
    lam, V = torch.linalg.eigh(blocks)
    # eigh on the card returns column-major blocks; K6 reads row-major ones
    return torch.clamp(lam, min=0.0), V.contiguous()


# --------------------------------------------------------------------------- #
# the solve                                                                    #
# --------------------------------------------------------------------------- #


def pin_cov_solve(A, grad, beta, slot_begin, slot_size, eigvals, eigvecs,
                  penalty, is_active, lmda, alpha, tol, dbeta_tol, newton_tol,
                  newton_max_iters, max_iters, rsq):
    """Solve the pinned group elastic net at one lambda.

    Alternates (a) coordinate descent over the active set until
    ``convg < tol`` with (b) full screen-set sweeps that grow the active
    set, and stops when a full sweep converges (reference
    ``pin::naive::solve``).  ``A`` (S, S); ``grad, beta`` (S,); slot buffers
    (G_cap,); ``eigvals`` (G_cap, qmax), ``eigvecs`` (G_cap, qmax, qmax).
    ``dbeta_tol``, ``newton_tol`` and ``newton_max_iters`` serve the block
    updates of groups in a ``qmax > 1`` solve.  Returns ``(beta, grad,
    is_active, rsq, iters, done)`` with the last three on the host; a
    grouped solve's Newton counts go to ``pin_group_kernels.newton``.
    """
    if eigvals.shape[1] > 1:
        beta, grad, is_active, info = pin_group_solve(
            A, grad.contiguous(), beta.contiguous(), slot_begin, slot_size,
            eigvals, eigvecs, penalty, is_active, lmda, alpha, tol,
            dbeta_tol, newton_tol, newton_max_iters, max_iters, rsq,
        )
        info = info.tolist()
        record_newton(info)
    else:
        solve = (pin_lasso_solve if A.shape[0] <= MAX_PALLAS_S
                 else pin_lasso_solve_rows)
        beta, grad, is_active, info = solve(
            A, grad.contiguous(), beta.contiguous(), slot_begin, slot_size,
            eigvals, penalty, is_active, lmda, alpha, tol, max_iters, rsq,
        )
        info = info.tolist()
    rsq_n, iters, done = info[:3]
    return beta, grad, is_active, rsq_n, int(iters), bool(done)
