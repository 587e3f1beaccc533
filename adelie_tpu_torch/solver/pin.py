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
For ``X (x) I_K`` (the multi-response problem) the Gram is formed one
class at a time from the child's columns (``kron_gram``, ``kron_cross``)
and scattered into the same slot layout.

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
    At its peak it holds the Gram, the (n, S) product ``Xs * w`` and, while
    centering, an eighth of the Gram (``subtract_outer_``).
    """
    with matmul_precision():
        means = w @ Xs
        A = Xs.T @ (Xs * w[:, None])
    if intercept:
        subtract_outer_(A, means)
    return A, means


def subtract_outer_(A, means):
    """``A -= outer(means, means)`` in place, in row blocks of at most an
    eighth of the rows (at least 256), so one Gram and one block of the
    outer product are alive at a time.  Each entry is ``a - m_i m_j``
    rounded twice, as in ``A - torch.outer(means, means)``: the same
    bits."""
    S = A.shape[0]
    step = max(256, S // 8)
    for i in range(0, S, step):
        A[i:i + step] -= torch.outer(means[i:i + step], means)
    return A


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


def kron_cross(Xc, Xnew, W):
    """The per-class weighted cross blocks ``Xc^T diag(W[:, k]) Xnew`` of a
    Kronecker screen: (K, c, d) for ``Xc`` (n, c), ``Xnew`` (n, d) and the
    class weights ``W`` (n, K), all from one GEMM
    ``Xc^T [Xnew W_0 | ... | Xnew W_{K-1}]``, the (n, K d) product its only
    temporary."""
    n, d = Xnew.shape
    with matmul_precision():
        P = (Xnew[:, None, :] * W[:, :, None]).reshape(n, W.shape[1] * d)
        out = Xc.T @ P
    return out.reshape(Xc.shape[1], W.shape[1], d).permute(1, 0, 2)


def kron_gram(Xc, W):
    """The screen Gram of ``X (x) I_K`` in its nonzero blocks: for the
    child's gathered columns ``Xc`` (n, c) and the flattened weights as
    ``W`` (n, K), the per-class Grams ``G[k] = Xc^T diag(W[:, k]) Xc``
    (K, c, c).  Entry ((q, k), (q', k')) of the flattened Gram is
    ``G[k][q, q']`` if k == k', else 0: the naive gather's (n K, S) block
    computes the same sums with K - 1 of every K terms zero."""
    return kron_cross(Xc, Xc, W).contiguous()


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
    # an invalid slot's block is all zeros, whose eigenvalues the card's
    # batched eigh has returned as NaN: they are set to 0, as the CPU gives
    # them (the pin solves take max |eigvals| for their tolerance floor)
    lam = torch.where(mask[:, :1], torch.clamp(lam, min=0.0),
                      torch.zeros((), dtype=A.dtype, device=A.device))
    # eigh on the card returns column-major blocks; K6 reads row-major ones
    return lam, V.contiguous()


# --------------------------------------------------------------------------- #
# the solve                                                                    #
# --------------------------------------------------------------------------- #


def pin_cov_launch(A, grad, beta, slot_begin, slot_size, eigvals, eigvecs,
                   penalty, is_active, lmda, alpha, tol, dbeta_tol, newton_tol,
                   newton_max_iters, max_iters, rsq):
    """Launch the pin solve at one lambda (``pin_cov_solve``'s arguments)
    and return ``(beta, grad, is_active, info)`` with ``info`` still on the
    device: a caller that has more to read copies it with that, in one
    host copy, and hands the list to ``pin_info``."""
    if eigvals.shape[1] > 1:
        return pin_group_solve(
            A, grad.contiguous(), beta.contiguous(), slot_begin, slot_size,
            eigvals, eigvecs, penalty, is_active, lmda, alpha, tol,
            dbeta_tol, newton_tol, newton_max_iters, max_iters, rsq,
        )
    solve = (pin_lasso_solve if A.shape[0] <= MAX_PALLAS_S
             else pin_lasso_solve_rows)
    return solve(
        A, grad.contiguous(), beta.contiguous(), slot_begin, slot_size,
        eigvals, penalty, is_active, lmda, alpha, tol, max_iters, rsq,
    )


def pin_info(info, grouped: bool):
    """``(rsq, iters, done)`` of a solve's ``info`` read to the host as a
    list; a grouped solve's Newton counts go to
    ``pin_group_kernels.newton``."""
    if grouped:
        record_newton(info)
    rsq_n, iters, done = info[:3]
    return rsq_n, int(iters), bool(done)


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
    beta, grad, is_active, info = pin_cov_launch(
        A, grad, beta, slot_begin, slot_size, eigvals, eigvecs, penalty,
        is_active, lmda, alpha, tol, dbeta_tol, newton_tol, newton_max_iters,
        max_iters, rsq)
    return (beta, grad, is_active,
            *pin_info(info.tolist(), eigvals.shape[1] > 1))
