"""The screened coordinate-descent kernel (K7), its plain twin and counter.

K7 runs the whole fit of BVLS's and pinball's screened problem, the device
loop of ``adelie_tpu/solver/screened_cd.py:screened_cd_fit``, in one launch
(``csrc/screened_cd_kernels.cu``, built at first use, see ``_build.py``).
The JAX package runs it as an XLA ``while_loop``; it has no Pallas kernel.

``screened_cd_solve`` takes ``screened_cd_fit``'s arguments.  For a CUDA
tensor it launches K7 or raises; for a CPU tensor it runs the twin,
``screened_cd_solve_ref``: a Python loop over the coordinates with the
kernel's contract, the same update order and scalar arithmetic in the
tensors' dtype (numpy scalars), and the same AXPY ``grad - delta Q[:, i]``
elementwise.  Both return ``(beta, grad, is_active, info)`` with ``info``
a (5,) float64 tensor holding ``(loss, iters, converged, moves,
updates)``: the running loss, the sweep count (``iters0`` included), 1.0
when a full sweep converged, the number of moving updates and the number
of slots visited.  The twin also marks, in an optional ``moved`` array,
the slots that moved: the columns of Q a fit had to read, which a bound
counts once each (the kernel, bit-equal, moves the same slots).

``launches`` counts kernel launches (never twin runs), so that a run can
show that its main path went through the kernel.
"""

import numpy as np
import torch

launches = {"screened_cd_solve": 0}

MODES = {"box": 0, "pinball": 1}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _mode(mode):
    try:
        return MODES[mode]
    except KeyError:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got "
                         f"{mode!r}") from None


def _dtype(Q):
    try:
        return _NP_DTYPE[Q.dtype]
    except KeyError:
        raise TypeError(f"screened_cd_solve takes float32 or float64, got "
                        f"{Q.dtype}") from None


def screened_cd_solve(Q, diag, beta, grad, lo, hi, valid, is_active, loss,
                      tol_scale, max_iters, iters0, mode):
    """The whole screened fit.

    ``Q`` (S, S) is the Gram of the screened atoms; the update of slot i
    reads its column ``Q[:, i]``.  K7 reads it as rows of ``Q^T``: a
    ``Q`` that is the transpose of a contiguous tensor is taken as it is,
    another is copied once.  ``diag, beta, grad, lo, hi`` (S,) of Q's
    dtype; ``valid, is_active`` (S,) bool; ``loss`` and ``tol_scale``
    scalars (rounded to the dtype); ``max_iters`` and ``iters0`` ints;
    ``mode`` "box" (BVLS) or "pinball".
    """
    m = _mode(mode)
    dt = _dtype(Q)
    if Q.device.type == "cpu":
        return screened_cd_solve_ref(Q, diag, beta, grad, lo, hi, valid,
                                     is_active, loss, tol_scale, max_iters,
                                     iters0, mode)
    if Q.device.type != "cuda":
        raise ValueError(f"screened_cd_solve: no kernel or twin for device "
                         f"{Q.device}")
    S = Q.shape[0]
    if Q.dim() != 2 or Q.shape[1] != S or S < 1:
        raise ValueError(f"screened_cd_solve: Q must be (S, S), got "
                         f"{tuple(Q.shape)}")
    Qt = Q.mT.contiguous()
    for name, t, want in (("diag", diag, Q.dtype), ("beta", beta, Q.dtype),
                          ("grad", grad, Q.dtype), ("lo", lo, Q.dtype),
                          ("hi", hi, Q.dtype), ("valid", valid, torch.bool),
                          ("is_active", is_active, torch.bool)):
        if t.device != Q.device:
            raise ValueError(f"screened_cd_solve: {name} is on {t.device}, "
                             f"not {Q.device}")
        if t.dtype != want:
            raise TypeError(f"screened_cd_solve: {name} has dtype {t.dtype}")
        if tuple(t.shape) != (S,):
            raise ValueError(f"screened_cd_solve: {name} has shape "
                             f"{tuple(t.shape)}, expected ({S},)")
        if not t.is_contiguous():
            raise ValueError(f"screened_cd_solve: {name} is not contiguous")
    from .. import _build

    lib = _build.load()
    beta_out = torch.empty_like(beta)
    grad_out = torch.empty_like(grad)
    active_out = torch.empty_like(is_active)
    info = torch.empty(5, dtype=torch.float64, device=Q.device)
    # the active list, where it does not fit in shared memory
    lst = torch.empty(S, dtype=torch.int32, device=Q.device)
    fn = getattr(lib, f"adelie_screened_cd_solve_{_SUFFIX[Q.dtype]}")
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(Qt.data_ptr(), diag.data_ptr(), beta.data_ptr(),
                  grad.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                  valid.data_ptr(), is_active.data_ptr(), beta_out.data_ptr(),
                  grad_out.data_ptr(), active_out.data_ptr(), info.data_ptr(),
                  lst.data_ptr(), S, m, float(dt(loss)), float(dt(tol_scale)),
                  int(max_iters), int(iters0), stream)
    _build.check(lib, code, "screened_cd_solve")
    launches["screened_cd_solve"] += 1
    return beta_out, grad_out, active_out, info


def _nan_max(a, b):
    """max that propagates NaN, as jnp.maximum does."""
    if np.isnan(a) or np.isnan(b):
        return a + b
    return a if a > b else b


def _update(box, dt, d, g, b, lo, hi):
    if box:
        x = b + (dt(0.0) if d <= 0 else g / d)
        x = lo if x < lo else x
        return hi if x > hi else x
    g0 = g + d * b
    mag = _nan_max(_nan_max(-lo - g0, g0 - hi), dt(0.0))
    sgn = dt(1.0) if g0 + lo >= 0 else dt(-1.0)
    return b if d <= 0 else sgn * mag / d


def screened_cd_solve_ref(Q, diag, beta, grad, lo, hi, valid, is_active,
                          loss, tol_scale, max_iters, iters0, mode,
                          moved=None):
    """Plain twin of ``screened_cd_solve``: same arguments, same results,
    on CPU tensors.  ``moved``, a (S,) bool numpy array, gets True at
    every slot that moved."""
    box = _mode(mode) == MODES["box"]
    dt = _dtype(Q)
    Qt = Q.mT.contiguous().numpy()
    d_h = diag.numpy().astype(dt)
    lo_h = lo.numpy().astype(dt)
    hi_h = hi.numpy().astype(dt)
    v_h = valid.numpy().astype(bool)
    b = beta.numpy().astype(dt)             # copies
    g = grad.numpy().astype(dt)
    act = is_active.numpy().astype(bool)
    S = len(b)
    loss = dt(loss)
    tol_scale = dt(tol_scale)
    moves = updates = 0

    def sweep(active_only):
        nonlocal g, loss, moves, updates
        convg = dt(0.0)
        for i in range(S):
            if not v_h[i] or (active_only and not act[i]):
                continue
            updates += 1
            d, gi, bi = d_h[i], g[i], b[i]
            bn = _update(box, dt, d, gi, bi, lo_h[i], hi_h[i])
            delta = bn - bi
            if not delta != 0:
                continue
            sd2 = d * delta * delta
            convg = _nan_max(convg, sd2)
            loss = loss - (delta * gi - dt(0.5) * sd2)
            moves += 1
            g = g - delta * Qt[i]
            b[i] = bn
            act[i] = True
            if moved is not None:
                moved[i] = True
        return convg

    it, done = int(iters0), False
    while not done and it < max_iters:
        convg = sweep(False)
        it += 1
        done = bool(convg <= tol_scale)
        if not done:
            convg = sweep(True)
            it += 1
            while convg > tol_scale and it < max_iters:
                convg = sweep(True)
                it += 1
        keep = (b > lo_h) & (b < hi_h) if box else b != 0
        act &= keep
    info = torch.tensor([float(loss), float(it), float(done), float(moves),
                         float(updates)], dtype=torch.float64)
    return (torch.from_numpy(b), torch.from_numpy(g), torch.from_numpy(act),
            info)
