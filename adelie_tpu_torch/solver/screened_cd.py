"""The screened coordinate-descent fit of the standalone solvers (BVLS,
pinball).

Counterpart of ``adelie_tpu/solver/screened_cd.py``: the screened atoms'
Gram is formed once a fit by the caller, and the whole fit (the sweeps
over the screen, the active-set refinement, the pruning, the loss) runs
in covariance form in one call, K7 of ``screened_cd_kernels`` on a CUDA
tensor (full sweeps and segments of device work, a host read after each)
and its twin on a CPU tensor.  The host drives the KKT screening rounds
around it.

``mode``:

* ``"box"``: the BVLS update ``b <- clip(b + g / d, lower, upper)``; an
  active slot is pruned when it sits at a bound (solver_bvls.hpp);
* ``"pinball"``: the asymmetric soft threshold (solver_pinball.hpp); an
  active slot is pruned at zero.
"""

import torch

from . import screened_cd_kernels as kernels

__all__ = ["padded", "screened_cd_fit"]


def padded(values, S_cap, like, fill=0):
    """``values`` in the first slots of an (S_cap,) tensor of ``like``
    (dtype and device), ``fill`` past them."""
    out = torch.full((S_cap,), fill, **like)
    out[:len(values)] = torch.as_tensor(values, **like)
    return out


def screened_cd_fit(Q, diag, beta, grad, lo, hi, valid, is_active, loss,
                    tol_scale, max_iters, iters0, mode):
    """The JAX package's ``screened_cd_fit``: ``Q`` (S, S) the Gram of the
    screened atoms (padded), ``diag`` (S,) the quadratic diagonal (0 on
    padding), ``beta``/``grad`` (S,), ``lo``/``hi`` (S,) the bounds
    (``"box"``) or the negative and positive penalties (``"pinball"``),
    ``valid``/``is_active`` (S,) bool, ``loss`` the running loss,
    ``tol_scale`` (convergence when max d db^2 <= tol_scale), ``max_iters``
    the cap on the total sweeps and ``iters0`` the sweeps already spent.

    Returns ``(beta, grad, is_active, loss, iters, converged)``: three
    tensors on Q's device and three host values (``info`` is on the
    host)."""
    beta, grad, is_active, info = kernels.screened_cd_solve(
        Q, diag, beta, grad, lo, hi, valid, is_active, loss, tol_scale,
        max_iters, iters0, mode)
    loss_h, iters, done = info[:3].tolist()
    return beta, grad, is_active, loss_h, int(iters), bool(done)
