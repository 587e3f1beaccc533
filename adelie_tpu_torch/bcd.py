"""Block-coordinate-descent group-update solvers.

Counterpart of ``adelie_tpu/bcd.py``.  Solves the (eigenbasis-rotated)
group elastic-net block update

    minimize_x  1/2 x' diag(L) x - v' x + l1 ||x||_2 + l2/2 ||x||_2^2

with ``L >= 0`` diagonal:

* ``x = 0`` iff ``||v||_2 <= l1``;
* if ``l1 == 0``: the closed form ``x = v / (L + l2)``;
* otherwise ``x_i = h v_i / ((L_i + l2) h + l1)`` where ``h = ||x||_2`` is
  the root of ``phi(h) = sum_i v_i^2 / ((L_i + l2) h + l1)^2 - 1``, found
  by one of four strategies (``newton``, ``newton_abs``, ``newton_brent``,
  ``brent``); ``solve`` also offers proximal gradient (``ista``, ``fista``,
  ``fista_adares``).

The functions take tensors or arrays in float32 or float64 and compute in
that dtype.  The root finds are data-dependent loops over a handful of
scalars, so they run on the host in numpy scalars of the dtype; on the card
the grouped pin solve runs the same loops inside its kernel
(``csrc/pin_group_kernels.cu``, K6), and ``solver/pin_group_kernels.py``'s
twin calls ``block_update_np`` for its block updates.  Every sum over a
block is taken in the order of K6's warp reduction (``lane_sum``), and no
product is fused into an addition, so the twin and the kernel round alike.

Padded lanes must have ``L == 0`` and ``v == 0``; they then give ``x == 0``.
"""

import numpy as np
import torch

from .utils import types

__all__ = [
    "root_function",
    "root_lower_bound",
    "root_upper_bound",
    "objective",
    "root",
    "solve",
    "newton_solver",
    "block_update_np",
    "lane_sum",
]

# lanes of one warp: K6 reduces a block's vector over at most this many
LANES = 32


def _np(x, dtype=None):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _dtype(*xs):
    dt = np.result_type(*[np.asarray(x).dtype for x in xs])
    return dt.type if dt in (np.float32, np.float64) else np.float64


def _tiny(dt):
    return dt(float(np.finfo(dt).tiny) * 1e8)


def lane_sum(x):
    """``sum(x)`` in K6's order: lane ``l`` of ``W = min(pow2(len), 32)``
    lanes adds entries ``l, l + W, l + 2W, ...`` in turn from 0, then the
    lanes are folded in halves (the warp's xor butterfly)."""
    n = x.shape[0]
    W = 1
    while W < min(n, LANES):
        W *= 2
    R = -(-n // W)
    if R * W != n:
        x = np.concatenate([x, np.zeros(R * W - n, x.dtype)])
    acc = np.zeros(W, x.dtype)
    for r in range(R):
        acc = acc + x[r * W:(r + 1) * W]
    h = W // 2
    while h:
        acc = acc[:h] + acc[h:2 * h]
        h //= 2
    return acc[0]


def _root_function(h, buf1, v, l1):
    den = buf1 * h + l1
    return lane_sum((v * v) / (den * den)) - buf1.dtype.type(1.0)


def _masked_size(v):
    # lanes with v != 0: the reference's p is only a bound, and counting
    # the nonzero lanes keeps it one (and tighter) on padded blocks
    dt = v.dtype.type
    return np.maximum(lane_sum((v != 0).astype(v.dtype)), dt(1.0))


def _root_lower_bound(buf1, v, l1):
    """Largest h with phi(h) >= 0 guaranteed, from the quadratic minorant
    a h^2 + 2 b h + c <= 0 (reference bcd/utils.hpp root_lower_bound)."""
    dt = v.dtype.type
    b = l1 * lane_sum(buf1)
    a = lane_sum(buf1 * buf1)
    v_l1 = lane_sum(np.abs(v))
    c = l1 * l1 * _masked_size(v) - v_l1 * v_l1
    discr = b * b - a * c
    if discr > dt(-1e-12):
        h_min = (-b + np.sqrt(np.maximum(discr, dt(0.0)))) \
            / np.maximum(a, _tiny(dt))
    else:
        h_min = dt(0.0)
    return np.maximum(h_min, dt(0.0))


def _root_upper_bound(buf1, v, l1, zero_tol=1e-14):
    """(h_max, min nonzero entry of buf1) with phi(h_max) <= 0, nearly so
    with zero eigenvalues (reference bcd/utils.hpp root_upper_bound)."""
    dt = v.dtype.type
    nz = buf1 > dt(zero_tol)
    safe = np.where(nz, buf1, dt(1.0))
    vi2 = v * v
    h_max = lane_sum(np.where(nz, vi2 / (safe * safe), dt(0.0)))
    v_S = lane_sum(np.where(buf1 <= 0, vi2, dt(0.0)))
    denom = dt(1.0) - v_S / (l1 * l1)
    h_max = np.sqrt(np.maximum(h_max / (denom if denom > 0 else dt(1.0)),
                               dt(0.0)))
    min_nnz = np.min(np.where(nz, buf1, dt(np.inf)), initial=dt(np.inf))
    return h_max, (min_nnz if np.isfinite(min_nnz) else dt(1.0))


def _newton_step(buf1, v, l1, h, tiny):
    dt = v.dtype.type
    inv = dt(1.0) / (buf1 * h + l1)
    vi = v * inv
    sq = vi * vi
    t = lane_sum(sq)
    sqrt_t = np.sqrt(t)
    fh = t - dt(1.0)
    dfh = -lane_sum(sq * buf1 * inv) * (dt(1.0) + sqrt_t) \
        / np.maximum(t, tiny)
    return fh, dfh


def _newton_phase(buf1, v, l1, h0, tol, max_iters):
    """Guarded Newton on phi from ``h0`` (newton.hpp newton_solver_base):
    phi is convex and decreasing on h >= 0, so Newton from the left
    converges monotonically.  Returns (h, iters, steps run, cycled).

    The walk's state is h alone, so in floating point it is eventually
    periodic.  Brent's cycle detection watches for an h that repeats bit
    for bit: a saved h is compared with each of the next ``power`` steps,
    then replaced by the newest, ``power`` doubled.  A repeat at step k
    with period p means every h of the cycle has failed ``tol``, so the
    walk runs to ``max_iters``; ``(max_iters - k) mod p`` more steps end
    on the h that walk ends on, and ``iters`` is ``max_iters`` as for the
    full walk.  K6 exits its walks by the same rule."""
    dt = v.dtype.type
    tiny = _tiny(dt)
    h = dt(h0)
    fh, dfh = _newton_step(buf1, v, l1, h, tiny)
    it = 0
    saved, since, power = h.tobytes(), 0, 1
    while np.abs(fh) > tol and it < max_iters:
        h = np.maximum(h - fh / dfh, dt(0.0))
        fh, dfh = _newton_step(buf1, v, l1, h, tiny)
        it += 1
        since += 1
        if it < max_iters and h.tobytes() == saved:
            run = it
            for _ in range((max_iters - it) % since):
                h = np.maximum(h - fh / dfh, dt(0.0))
                fh, dfh = _newton_step(buf1, v, l1, h, tiny)
                run += 1
            return h, max_iters, run, True
        if since == power:
            saved, since, power = h.tobytes(), 0, 2 * power
    return h, it, it, False


def _newton_abs_init(buf1, v, l1, tol):
    """Adaptive bisection from h_max toward h_min until phi(h) >= 0, so
    that Newton starts left of the root (newton.hpp:213-260)."""
    dt = v.dtype.type
    h_min = _root_lower_bound(buf1, v, l1)
    h_max, min_nnz = _root_upper_bound(buf1, v, l1)
    if h_max - h_min <= dt(1e-1):
        return h_min

    def toward_min(h):
        w = np.maximum(l1 / (min_nnz * h + l1), dt(0.05))
        return w * h_min + (dt(1.0) - w) * h

    h = toward_min(np.maximum(h_max, h_min))
    fh = _root_function(h, buf1, v, l1)
    it = 1
    while fh < 0 and np.abs(fh) > tol and it < 100:
        h = toward_min(h)
        fh = _root_function(h, buf1, v, l1)
        it += 1
    return h


def brent_root_scalar(f, a, b, x_tol, y_tol, max_iters):
    """Brent's method on a scalar function over the bracket [a, b]
    (reference optimization/bisect.hpp brent, :12-103), with the JAX
    package's loop: the state (a, b, c, d, do_bisect) freezes once the
    x-interval or |f(b)| tolerance is met.  Returns (sol, iters)."""
    dt = np.result_type(np.asarray(a).dtype, np.asarray(b).dtype).type
    a, b = dt(a), dt(b)
    x_tol, y_tol = dt(x_tol), dt(y_tol)
    fa, fb = f(a), f(b)
    if np.abs(fa) < np.abs(fb):
        a, b, fa, fb = b, a, fb, fa
    c, fc, d = a, fa, a
    do_bisect = True
    it = 0
    with np.errstate(all="ignore"):
        while it < max_iters:
            if np.abs(b - a) <= x_tol or np.abs(fb) <= dt(2.0) * y_tol:
                break
            if np.abs(fa - fc) > y_tol and np.abs(fb - fc) > y_tol:
                s = (a * fb * fc / ((fa - fb) * (fa - fc))
                     + b * fa * fc / ((fb - fa) * (fb - fc))
                     + c * fa * fb / ((fc - fa) * (fc - fb)))
            else:
                s = b - fb * (b - a) / (fb - fa)
            delta = np.abs(dt(2.0) * x_tol * np.abs(b))
            min1, min2, min3 = np.abs(s - b), np.abs(b - c), np.abs(c - d)
            bad = (((s < dt(0.25) * (dt(3.0) * a + b)) and (s > b))
                   or (do_bisect and min1 >= min2 * dt(0.5))
                   or (not do_bisect and min1 >= min3 * dt(0.5))
                   or (do_bisect and min2 < delta)
                   or (not do_bisect and min3 < delta))
            if bad:
                s = dt(0.5) * (a + b)
            do_bisect = bool(bad)
            fs = f(s)
            found = np.abs(fs) < y_tol
            d, c, fc = c, b, fb
            if fs * fa < 0:
                b, fb = s, fs
            else:
                a, fa = s, fs
            if np.abs(fa) < np.abs(fb):
                a, b, fa, fb = b, a, fb, fa
            if found:
                b = s
            it += 1
            if found:
                break
    return b, it


def _brent_root(buf1, v, l1, tol, max_iters):
    """Brent on phi over [root_lower_bound, root_upper_bound(zero_tol=0)]
    (reference brent.hpp:11-36)."""
    h_min = _root_lower_bound(buf1, v, l1)
    h_max, _ = _root_upper_bound(buf1, v, l1, zero_tol=0.0)
    h_max = np.maximum(h_max, h_min)
    return brent_root_scalar(lambda h: _root_function(h, buf1, v, l1),
                             h_min, h_max, tol, tol, max_iters)


def block_update_np(L, v, l1, l2, tol=1e-12, max_iters=1000,
                    method="newton_abs"):
    """``newton_solver`` on numpy arrays ``L, v`` of one float dtype, with
    scalars ``l1, l2, tol`` cast to it: returns ``(x, iters, general, run,
    cycled)``, ``general`` False in the zero and ridge cases (``iters`` and
    ``run`` 0 there), else True with ``iters`` the Newton (or Brent) steps
    of the full walk, ``run`` those taken and ``cycled`` whether the
    Newton walk ended by ``_newton_phase``'s cycle rule."""
    dt = v.dtype.type
    l1, l2, tol = dt(l1), dt(l2), dt(tol)
    buf1 = L + l2
    if np.sqrt(lane_sum(v * v)) <= l1:
        return np.zeros_like(v), 0, False, 0, False
    if l1 <= 0:
        x = np.where(v != 0, v / np.where(buf1 != 0, buf1, dt(1.0)), dt(0.0))
        return x, 0, False, 0, False
    cycled = False
    if method == "newton_abs":
        h, iters, run, cycled = _newton_phase(
            buf1, v, l1, _newton_abs_init(buf1, v, l1, tol), tol, max_iters)
    elif method == "newton":
        h, iters, run, cycled = _newton_phase(buf1, v, l1, dt(0.0), tol,
                                              max_iters)
    elif method == "newton_brent":
        h0, it0 = _brent_root(buf1, v, l1, tol, max_iters)
        h, it1, run1, cycled = _newton_phase(buf1, v, l1, h0, tol, max_iters)
        iters, run = it0 + it1, it0 + run1
    elif method == "brent":
        h, iters = _brent_root(buf1, v, l1, tol, max_iters)
        run = iters
    else:
        raise ValueError(f"Unknown newton method: {method}")
    return (h * v) / (buf1 * h + l1), iters, True, run, cycled


def newton_solver(L, v, l1, l2, tol=1e-12, max_iters=1000,
                  method="newton_abs"):
    """Solve the block update; returns ``(x, iters)``, ``x`` a tensor of
    ``v``'s dtype on ``v``'s device (a CPU tensor for an array).

    ``method`` selects the root strategy (reference
    bcd/unconstrained/{newton.hpp, brent.hpp}): ``newton`` (guarded Newton
    from h = 0), ``newton_abs`` (adaptive bisection, then Newton),
    ``newton_brent`` (Brent to tolerance, then Newton), ``brent``.
    """
    method = types.newton_method(method, param="method")
    dt = _dtype(v)
    x, iters = block_update_np(_np(L, dt), _np(v, dt), l1, l2, tol,
                               int(max_iters), method)[:2]
    device = v.device if isinstance(v, torch.Tensor) else "cpu"
    return torch.as_tensor(x, device=device), int(iters)


# --------------------------------------------------------------------------- #
# the public functions of adelie_tpu.bcd                                      #
# --------------------------------------------------------------------------- #


def _problem(quad, linear):
    dt = _dtype(quad, linear)
    return dt, _np(quad, dt), _np(linear, dt)


def root_function(h, *, quad, linear, l1):
    """phi(h) = sum v_i^2 / (quad_i h + l1)^2 - 1 (reference bcd.py:81)."""
    dt, quad, linear = _problem(quad, linear)
    return float(_root_function(dt(h), quad, linear, dt(l1)))


def root_lower_bound(*, quad, linear, l1):
    """Lower bound on the root of phi (reference bcd.py:5)."""
    dt, quad, linear = _problem(quad, linear)
    return float(_root_lower_bound(quad, linear, dt(l1)))


def root_upper_bound(*, quad, linear, l1, zero_tol=1e-14):
    """Upper bound on the root of phi (reference bcd.py:40)."""
    dt, quad, linear = _problem(quad, linear)
    return float(_root_upper_bound(quad, linear, dt(l1), zero_tol)[0])


def objective(beta, *, quad, linear, l1, l2):
    """1/2 b'Sb - v'b + l1||b|| + l2/2||b||^2 (reference bcd.py:123)."""
    dt, quad, linear = _problem(quad, linear)
    beta = _np(beta, dt)
    sq = float(np.sum(beta * beta))
    return float(0.5 * np.sum(quad * beta * beta) - np.sum(linear * beta)
                 + l1 * np.sqrt(sq) + 0.5 * l2 * sq)


def root(*, quad, linear, l1, l2=0.0, tol=1e-12, max_iters=1000):
    """Root ||x||_2 of the solved block update (reference bcd.py:264)."""
    dt, quad, linear = _problem(quad, linear)
    x = block_update_np(quad, linear, l1, l2, tol, int(max_iters))[0]
    return float(np.sqrt(np.sum(x * x)))


def _ista(quad, linear, l1, l2, tol, max_iters, accel, adares):
    """(F)ISTA on the block update (reference bcd/unconstrained/ista.hpp:
    10-94): proximal gradient with step 1/L, L = max(quad) + l2, the prox of
    l1 ||.||_2 the group soft threshold; ``accel`` adds Nesterov momentum,
    ``adares`` resets it when the update opposes the velocity."""
    dt = linear.dtype.type
    l1, l2, tol = dt(l1), dt(l2), dt(tol)
    q = quad + l2
    t = dt(1.0) / np.maximum(np.max(q), dt(1e-30))

    def prox(u):
        nrm = np.sqrt(np.sum(u * u))
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = np.maximum(dt(1.0) - t * l1 / np.maximum(nrm, dt(1e-300)),
                               dt(0.0))
        return scale * u

    x = z = np.zeros_like(linear)
    s = dt(1.0)
    it, diff = 0, dt(np.inf)
    while diff > tol and it < max_iters:
        x_new = prox(z - t * (q * z - linear))
        s_new = dt(0.5) * (dt(1.0) + np.sqrt(dt(1.0) + dt(4.0) * s * s)) \
            if accel else s
        mom = (s - dt(1.0)) / s_new if accel else dt(0.0)
        if adares and np.sum((z - x_new) * (x_new - x)) > 0:
            mom, s_new = dt(0.0), dt(1.0)
        z = x_new + mom * (x_new - x) if accel else x_new
        diff = np.max(np.abs(x_new - x), initial=dt(0.0))
        x, s, it = x_new, s_new, it + 1
    return x, it


def solve(*, quad, linear, l1, l2, tol: float = 1e-12, max_iters: int = 1000,
          solver: str = "newton_abs"):
    """Solve the BCD update (reference bcd.py:182): the Newton family
    (``newton``, ``newton_abs``, ``newton_brent``, ``brent``) or proximal
    gradient (``ista``, ``fista``, ``fista_adares``).  Returns a dict with
    ``beta`` (a numpy array) and ``iters``."""
    solver = types.bcd_solver(solver, param="solver")
    dt, quad, linear = _problem(quad, linear)
    if solver in ("ista", "fista", "fista_adares"):
        x, iters = _ista(quad, linear, l1, l2, tol, int(max_iters),
                         solver != "ista", solver == "fista_adares")
    else:
        x, iters = block_update_np(quad, linear, l1, l2, tol,
                                   int(max_iters), solver)[:2]
    return {"beta": np.asarray(x), "iters": int(iters)}
