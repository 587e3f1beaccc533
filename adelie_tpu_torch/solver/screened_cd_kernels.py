"""The screened coordinate-descent kernels (K7), their plain twin and counter.

K7 runs the whole fit of BVLS's and pinball's screened problem, the device
loop of ``adelie_tpu/solver/screened_cd.py:screened_cd_fit``
(``csrc/screened_cd_kernels.cu``, built at first use, see ``_build.py``).
The JAX package runs it as an XLA ``while_loop``; it has no Pallas kernel.

``screened_cd_solve`` takes ``screened_cd_fit``'s arguments.  For a CUDA
tensor it runs the fit on the card in segments or raises; for a CPU
tensor it runs the twin, ``screened_cd_solve_ref``: a Python loop over the
coordinates with the kernels' contract, the same update order and scalar
arithmetic in the tensors' dtype (numpy scalars), and the same AXPY
``grad - delta Q[:, i]`` elementwise.  Both return ``(beta, grad,
is_active, info)`` with ``info`` a (5,) float64 tensor on the host holding
``(loss, iters, converged, moves, updates)``: the running loss, the sweep
count (``iters0`` included), 1.0 when a full sweep converged, the number
of moving updates and the number of slots visited.  The twin also marks,
in an optional ``moved`` array, the slots that moved: the columns of Q a
fit had to read, which a bound counts once each (the kernels, bit-equal,
move the same slots).

On the card a fit is segments that the host drives (``run_segments``):
a full sweep of every valid slot in the chain kernel (one block), which
either converges or opens an active phase and lists its slots; the
gather, which copies the phase's block ``Q^T[list][:, list]`` into a
compact matrix, so that a move touches the listed slots only; segments
of the active phase on that block in the chain kernel, whose rows a
ring of bulk copies brings into shared memory ahead of the updates (the
list's order is fixed), each segment logging its moves' deltas; and
after each segment the replay, which applies the logged moves, in order,
to every slot not listed.  The replay does to each such slot what the
twin does, the same products and subtractions in the same order, so the
fit keeps the twin's bits.  What bounds a fit is the chain of updates on
one SM: an update's own arithmetic and one barrier (the source note
has the design).  The host reads the fit's state, one copy of
``ST_LEN`` doubles, after each full sweep and each segment, and launches
no kernel that the state shows has nothing to do: a full sweep costs a
launch and a read, a phase it opens a gather, and each segment of the
phase 2 launches (1 when every slot is listed) and a read.  The
compact block and the log are sized from the list's length, read after
the full sweep that opens the phase: ``na`` rows of ``ldc(na)`` values,
and at most ``LOG_ENTRIES`` deltas (a sweep at least).

``run_segments`` is written once: it takes its steps as arguments, the
kernels (``KernelSteps``) or their plain stand-ins in numpy on CPU tensors
(``PlainSteps``: a compact chain, a logged replay).  ``screened_cd_solve_
segmented`` runs the stand-ins, so a CPU test holds the segmented scheme,
with a log as short as one sweep, against the twin bit for bit.

``launches`` counts kernel launches (never twin or stand-in runs), so that
a run can show that its main path went through the kernels, and
``worked`` those whose work the state read after them shows (a full
sweep counted, a phase's list gathered, a segment's sweeps logged, a
log replayed onto slots not listed); ``segments`` counts the card's
fits, rounds (segments of active phases), host reads, listed updates and
moves and keeps the largest list; ``timing``, when a list, gets
``(step, start, end)`` CUDA events around every launch, ``step`` one of
"full", "gather", "active" and "replay".
"""

import ctypes

import numpy as np
import torch

launches = {"screened_cd_solve": 0, "screened_cd_gather": 0,
            "screened_cd_replay": 0}
worked = dict(launches)
segments = {"fits": 0, "rounds": 0, "reads": 0, "listed_updates": 0,
            "listed_moves": 0, "na_max": 0}
timing = None

MODES = {"box": 0, "pinball": 1}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}

# the fit's state (doubles), as csrc/screened_cd_kernels.cu lays it out:
# the first INFO_LEN entries are the fit's info
(LOSS, ITERS, DONE, MOVES, UPDATES, PHASE, FRESH, NA, NR, PHASE_SWEEPS,
 LOGGED, LIST_MOVES, LIST_UPDATES, CONVG) = range(14)
ST_LEN = 16
INFO_LEN = 5
STAGE_FULL, STAGE_ACTIVE = 0, 1
# the active phase's compact vectors: grad, beta, diag, lo, hi, and Q's
# diagonal and next element of each listed row
CD_VECS = 7
# deltas the log holds at most (one sweep at least): 8 MB in float64
LOG_ENTRIES = 1 << 20
_ALL_SWEEPS = 2 ** 31 - 1


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


def ldc(n):
    """The row stride of the compact block: a multiple of 16 bytes."""
    return 4 if n < 4 else (n + 3) // 4 * 4


def _state0(dt, loss, iters0):
    state = [0.0] * ST_LEN
    state[LOSS] = float(dt(loss))
    state[ITERS] = float(iters0)
    return state


def _finished(state, max_iters):
    return bool(state[DONE]) or (not state[PHASE]
                                 and state[ITERS] >= max_iters)


def run_segments(steps, max_iters):
    """The host's loop over a fit's steps, for the kernels and their plain
    stand-ins alike.  ``steps`` has ``state0`` (the host's copy of the
    initial state), ``full``, ``gather(na)``, ``active`` and ``replay``
    (one step each on the fit's state) and ``read`` (the state: one host
    copy).  With no phase open: a full sweep and a read; if the sweep
    opened a phase, the gather of its ``na`` listed slots' block.  With a
    phase open: a segment of it, the replay of its log when some slots
    are not listed, and a read.  Each step runs only when the state read
    before it says it has work.  Returns the last state read and the
    counts: ``rounds`` (segments), ``reads``, and by step the runs whose
    work the state read after them shows."""
    state = steps.state0
    n = dict(rounds=0, reads=0, full=0, gather=0, active=0, replay=0)
    while not _finished(state, max_iters):
        if not state[PHASE]:
            iters = state[ITERS]
            steps.full()
            state = steps.read()
            n["reads"] += 1
            n["full"] += state[ITERS] > iters
            if not state[PHASE]:
                continue
            na = int(state[NA])
            steps.gather(na)
            n["gather"] += na > 0
        replay = state[NA] > 0 and state[NR] > 0
        steps.active()
        if replay:
            steps.replay()
        state = steps.read()
        n["reads"] += 1
        n["rounds"] += 1
        n["active"] += state[LOGGED] > 0
        n["replay"] += replay and state[LOGGED] > 0
    return state, n


def _log_sweeps(log_sweeps):
    sweeps = _ALL_SWEEPS if log_sweeps is None else int(log_sweeps)
    if sweeps < 1:
        raise ValueError(f"log_sweeps must be at least 1, got {log_sweeps}")
    return sweeps


def _log_len(na, log_sweeps):
    """The deltas a log holds for a phase of ``na`` listed slots: whole
    sweeps, at most ``log_sweeps`` and ``LOG_ENTRIES`` deltas, one sweep
    at least.  The log grows to it (it never shrinks within a fit), and a
    segment logs as many sweeps as the log holds, at most ``log_sweeps``."""
    na = max(na, 1)
    return na * min(log_sweeps, max(1, LOG_ENTRIES // na))


class KernelSteps:
    """The steps of ``run_segments`` on the card: the chain, the gather and
    the replay kernels on the fit's state in device memory.  Takes
    ``screened_cd_solve``'s arguments (CUDA tensors); for the checks, a
    segment's log of at most ``log_sweeps`` sweeps, ``layout`` (-1: by
    the budget; else at most 0, neither the compact vectors nor the ring
    in shared memory, or 1, the ring alone) and ``ring`` (0: by the
    budget; else the ring's rows at most, 2 or more).  The results do not
    depend on them."""

    def __init__(self, Q, diag, beta, grad, lo, hi, valid, is_active, loss,
                 tol_scale, max_iters, iters0, mode, log_sweeps=None,
                 layout=-1, ring=0):
        from .. import _build

        m = _mode(mode)
        dt = _dtype(Q)
        if Q.device.type != "cuda":
            raise ValueError(f"KernelSteps: Q is on {Q.device}, not a CUDA "
                             f"device")
        S = Q.shape[0]
        if Q.dim() != 2 or Q.shape[1] != S or S < 1:
            raise ValueError(f"screened_cd_solve: Q must be (S, S), got "
                             f"{tuple(Q.shape)}")
        for name, t, want in (("diag", diag, Q.dtype), ("beta", beta, Q.dtype),
                              ("grad", grad, Q.dtype), ("lo", lo, Q.dtype),
                              ("hi", hi, Q.dtype),
                              ("valid", valid, torch.bool),
                              ("is_active", is_active, torch.bool)):
            if t.device != Q.device:
                raise ValueError(f"screened_cd_solve: {name} is on "
                                 f"{t.device}, not {Q.device}")
            if t.dtype != want:
                raise TypeError(f"screened_cd_solve: {name} has dtype "
                                f"{t.dtype}")
            if tuple(t.shape) != (S,):
                raise ValueError(f"screened_cd_solve: {name} has shape "
                                 f"{tuple(t.shape)}, expected ({S},)")
            if not t.is_contiguous():
                raise ValueError(f"screened_cd_solve: {name} is not "
                                 f"contiguous")
        self.lib = _build.load()
        self._check = _build.check
        self.device = Q.device
        self.S, self.mode = S, m
        self.max_iters = int(max_iters)
        self.tol = float(dt(tol_scale))
        self.log_sweeps = _log_sweeps(log_sweeps)
        self.layout, self.ring = int(layout), int(ring)
        # the inputs the kernels only read, and the fit's state in place
        self.Qt = Q.mT.contiguous()
        self.diag, self.lo, self.hi, self.valid = diag, lo, hi, valid
        self.beta, self.grad = beta.clone(), grad.clone()
        self.act = is_active.clone()
        self.state0 = _state0(dt, loss, iters0)
        self.na_max = 0
        dev = dict(device=Q.device)
        # the state filled on the card: a copy from the host would wait
        # for the work queued before it
        self.st = torch.zeros(ST_LEN, dtype=torch.float64, **dev)
        self.st[LOSS] = self.state0[LOSS]
        self.st[ITERS] = self.state0[ITERS]
        # the phase's lists; its compact block, the compact vectors past
        # shared memory and the log, sized once a phase opens (grown only)
        self.list = torch.empty(S, dtype=torch.int32, **dev)
        self.rest = torch.empty(S, dtype=torch.int32, **dev)
        self.Qc = torch.empty(0, dtype=Q.dtype, **dev)
        self.cvec = torch.empty(0, dtype=Q.dtype, **dev)
        self.log = torch.empty(_log_len(0, 1), dtype=Q.dtype, **dev)
        self._stream = torch.cuda.current_stream(Q.device)
        self._sfx = _SUFFIX[Q.dtype]
        self._bind()

    def _bind(self):
        """Each launch's arguments, fixed until a buffer grows: the kernels
        update the tensors in place."""
        lib, p, sfx = self.lib, (lambda t: t.data_ptr()), self._sfx
        stream = self._stream.cuda_stream
        self._chain = (
            getattr(lib, f"adelie_screened_cd_solve_{sfx}"),
            (p(self.Qt), p(self.Qc), p(self.diag), p(self.lo), p(self.hi),
             p(self.valid), p(self.beta), p(self.grad), p(self.act),
             p(self.list), p(self.rest), p(self.cvec), p(self.log),
             p(self.st), self.S, self.mode))
        self._tail = (self.tol, self.max_iters, self.log.numel(),
                      self.log_sweeps, self.layout, self.ring, stream)
        self._gather = (getattr(lib, f"adelie_screened_cd_gather_{sfx}"),
                        (p(self.Qt), p(self.list), p(self.st), p(self.Qc),
                         self.S, stream))
        self._replay = (getattr(lib, f"adelie_screened_cd_replay_{sfx}"),
                        (p(self.Qt), p(self.list), p(self.rest),
                         p(self.grad), p(self.log), p(self.st), self.S,
                         stream))

    def _launch(self, key, step, fn, args):
        """One launch on the fit's stream; the caller has made the fit's
        device the current one (``run_kernel_fit`` does)."""
        if timing is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
        self._check(self.lib, fn(*args), key)
        launches[key] += 1
        if timing is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            timing.append((step, start, end))

    def full(self):
        fn, args = self._chain
        self._launch("screened_cd_solve", "full", fn,
                     args + (STAGE_FULL,) + self._tail)

    def active(self):
        fn, args = self._chain
        self._launch("screened_cd_solve", "active", fn,
                     args + (STAGE_ACTIVE,) + self._tail)

    def gather(self, na):
        """The block of a phase of ``na`` listed slots, into a compact
        matrix (and the vectors and log) grown to its size if need be."""
        grown = False
        for name, n in (("Qc", na * ldc(na)), ("cvec", CD_VECS * ldc(na)),
                        ("log", _log_len(na, self.log_sweeps))):
            if getattr(self, name).numel() < n:
                setattr(self, name, torch.empty(n, dtype=self.Qt.dtype,
                                                device=self.device))
                grown = True
        if grown:
            self._bind()
        if na > 0:
            self._launch("screened_cd_gather", "gather", *self._gather)

    def replay(self):
        self._launch("screened_cd_replay", "replay", *self._replay)

    def read(self):
        state = self.st.tolist()
        self.na_max = max(self.na_max, int(state[NA]))
        return state

    def snapshot(self):
        """The state, the fit's vectors, the open phase's lists, compact
        block and log, on the host (for a step-by-step comparison)."""
        st = self.st.cpu().numpy()
        na = int(st[NA])
        return _snapshot(st, self.beta.cpu().numpy(), self.grad.cpu().numpy(),
                         self.act.cpu().numpy(), self.list.cpu().numpy(),
                         self.rest.cpu().numpy(),
                         self.Qc[:na * ldc(na)].cpu().numpy(),
                         self.log[:int(st[LOGGED]) * na].cpu().numpy())

    def result(self, state):
        return (self.beta, self.grad, self.act,
                torch.tensor(state[:INFO_LEN], dtype=torch.float64))


def _snapshot(st, b, g, act, lst, rest, Qc, log):
    na, nr = int(st[NA]), int(st[NR])
    out = dict(state=st.copy(), beta=b.copy(), grad=g.copy(),
               active=act.astype(bool))
    if st[PHASE] or st[LOGGED]:
        out.update(list=lst[:na].copy(), rest=rest[:nr].copy(),
                   log=log[:int(st[LOGGED]) * na].copy())
        # the compact block, once the phase's gather has sized it
        if Qc.ndim == 1 and Qc.size >= na * ldc(na):
            out["Qc"] = Qc[:na * ldc(na)].reshape(na, ldc(na))[:, :na].copy()
        elif Qc.ndim == 2 and Qc.shape[0] >= na:
            out["Qc"] = Qc[:na, :na].copy()
    return out


class PlainSteps:
    """The kernels' steps in numpy on CPU tensors, each the kernel's
    operations in its order on numpy scalars of the dtype: a full sweep
    (the twin's), the gather (fancy indexing), a segment of the active
    phase on the compact block with its log, and the replay of the log on
    the slots not listed.  Takes ``KernelSteps``'s arguments (CPU tensors,
    no layout)."""

    def __init__(self, Q, diag, beta, grad, lo, hi, valid, is_active, loss,
                 tol_scale, max_iters, iters0, mode, log_sweeps=None):
        if Q.device.type != "cpu":
            raise ValueError(f"PlainSteps: Q is on {Q.device}, not the CPU")
        self.box = _mode(mode) == MODES["box"]
        self.dt = dt = _dtype(Q)
        self.Qt = Q.mT.contiguous().numpy()
        self.d = diag.numpy().astype(dt)
        self.lo = lo.numpy().astype(dt)
        self.hi = hi.numpy().astype(dt)
        self.v = valid.numpy().astype(bool)
        self.b = beta.numpy().astype(dt)            # copies
        self.g = grad.numpy().astype(dt)
        self.act = is_active.numpy().astype(bool)
        self.S = S = len(self.b)
        self.tol = dt(tol_scale)
        self.max_iters = int(max_iters)
        self.log_sweeps = _log_sweeps(log_sweeps)
        self.state0 = _state0(dt, loss, iters0)
        self.st = np.array(self.state0)
        self.list = np.zeros(S, np.int32)
        self.rest = np.zeros(S, np.int32)
        self.Qc = np.zeros((0, 0), dt)
        # the log grows as KernelSteps's does: a segment's sweeps depend on
        # its length
        self.log = np.zeros(_log_len(0, 1), dt)

    def _step(self, gi, bi, d, lo, hi):
        """One coordinate's update: (b', delta)."""
        bn = _update(self.box, self.dt, d, gi, bi, lo, hi)
        return bn, bn - bi

    def _keep(self):
        return ((self.b > self.lo) & (self.b < self.hi) if self.box
                else self.b != 0)

    def full(self):
        st, dt = self.st, self.dt
        if st[DONE] or st[PHASE] or st[ITERS] >= self.max_iters:
            return
        loss, convg = dt(st[LOSS]), dt(0.0)
        moves = updates = 0
        g, b = self.g, self.b
        for i in range(self.S):
            if not self.v[i]:
                continue
            updates += 1
            d, gi = self.d[i], g[i]
            bn, delta = self._step(gi, b[i], d, self.lo[i], self.hi[i])
            if not delta != 0:
                continue
            sd2 = d * delta * delta
            convg = _nan_max(convg, sd2)
            loss = loss - (delta * gi - dt(0.5) * sd2)
            moves += 1
            g = g - delta * self.Qt[i]
            b[i] = bn
            self.act[i] = True
        self.g = g
        done = bool(convg <= self.tol)
        st[LOSS] = float(loss)
        st[ITERS] += 1
        st[DONE] = float(done)
        st[MOVES] += moves
        st[UPDATES] += updates
        if done:
            self.act &= self._keep()
            return
        listed = self.v & self.act
        na = int(listed.sum())
        self.list[:na] = np.flatnonzero(listed)
        self.rest[:self.S - na] = np.flatnonzero(~listed)
        st[PHASE] = st[FRESH] = 1.0
        st[NA], st[NR], st[PHASE_SWEEPS] = na, self.S - na, 0

    def gather(self, na):
        n = _log_len(na, self.log_sweeps)
        if len(self.log) < n:
            self.log = np.zeros(n, self.dt)
        if self.st[FRESH] and na > 0:
            lst = self.list[:na]
            self.Qc = self.Qt[np.ix_(lst, lst)]

    def active(self):
        st, dt = self.st, self.dt
        st[LOGGED] = 0
        if not st[PHASE]:
            return
        na = int(st[NA])
        lst = self.list[:na]
        L = min(self.log_sweeps, len(self.log) // max(na, 1))
        gc, bc = self.g[lst], self.b[lst]
        dc, lc, hc = self.d[lst], self.lo[lst], self.hi[lst]
        loss, convg_last = dt(st[LOSS]), dt(st[CONVG])
        it, ps = int(st[ITERS]), int(st[PHASE_SWEEPS])
        moves = updates = nsw = 0
        closed = False
        while True:
            if ps > 0 and not (convg_last > self.tol and it < self.max_iters):
                closed = True
                break
            if nsw == L:
                break
            convg = dt(0.0)
            base = nsw * na
            for k in range(na):
                updates += 1
                d, gi = dc[k], gc[k]
                bn, delta = self._step(gi, bc[k], d, lc[k], hc[k])
                if not delta != 0:
                    self.log[base + k] = 0
                    continue
                sd2 = d * delta * delta
                convg = _nan_max(convg, sd2)
                loss = loss - (delta * gi - dt(0.5) * sd2)
                moves += 1
                gc = gc - delta * self.Qc[k]
                bc[k] = bn
                self.log[base + k] = delta
            it, nsw, ps, convg_last = it + 1, nsw + 1, ps + 1, convg
        self.g[lst] = gc
        self.b[lst] = bc
        if closed:
            self.act &= self._keep()
            st[PHASE] = 0.0
        st[LOSS], st[ITERS], st[CONVG] = float(loss), it, float(convg_last)
        st[MOVES] += moves
        st[UPDATES] += updates
        st[LIST_MOVES] += moves
        st[LIST_UPDATES] += updates
        st[PHASE_SWEEPS], st[LOGGED], st[FRESH] = ps, nsw, 0.0

    def replay(self):
        st = self.st
        na, nr, nsw = int(st[NA]), int(st[NR]), int(st[LOGGED])
        if not (nsw and na and nr):
            return
        rest = self.rest[:nr]
        Qr = self.Qt[np.ix_(self.list[:na], rest)]
        gr = self.g[rest]
        for e in range(nsw * na):
            d = self.log[e]
            if d != 0:
                gr = gr - d * Qr[e % na]
        self.g[rest] = gr

    def read(self):
        return self.st.tolist()

    def snapshot(self):
        return _snapshot(self.st, self.b, self.g, self.act, self.list,
                         self.rest, self.Qc, self.log)

    def result(self, state):
        return (torch.from_numpy(self.b), torch.from_numpy(self.g),
                torch.from_numpy(self.act),
                torch.tensor(state[:INFO_LEN], dtype=torch.float64))


def screened_cd_solve(Q, diag, beta, grad, lo, hi, valid, is_active, loss,
                      tol_scale, max_iters, iters0, mode):
    """The whole screened fit.

    ``Q`` (S, S) is the Gram of the screened atoms; the update of slot i
    reads its column ``Q[:, i]``.  The kernels read it as rows of ``Q^T``:
    a ``Q`` that is the transpose of a contiguous tensor is taken as it
    is, another is copied once.  ``diag, beta, grad, lo, hi`` (S,) of Q's
    dtype; ``valid, is_active`` (S,) bool; ``loss`` and ``tol_scale``
    scalars (rounded to the dtype); ``max_iters`` and ``iters0`` ints;
    ``mode`` "box" (BVLS) or "pinball".
    """
    _mode(mode)
    _dtype(Q)
    if Q.device.type == "cpu":
        return screened_cd_solve_ref(Q, diag, beta, grad, lo, hi, valid,
                                     is_active, loss, tol_scale, max_iters,
                                     iters0, mode)
    if Q.device.type != "cuda":
        raise ValueError(f"screened_cd_solve: no kernel or twin for device "
                         f"{Q.device}")
    return run_kernel_fit(KernelSteps(Q, diag, beta, grad, lo, hi, valid,
                                      is_active, loss, tol_scale, max_iters,
                                      iters0, mode))


def run_kernel_fit(steps):
    """A fit on the card: ``run_segments`` over ``steps`` (a
    ``KernelSteps``), its counts added to ``segments`` and ``worked``.
    Returns ``(beta, grad, is_active, info)``."""
    with torch.cuda.device(steps.device):
        state, n = run_segments(steps, steps.max_iters)
    segments["fits"] += 1
    segments["rounds"] += n["rounds"]
    segments["reads"] += n["reads"]
    segments["listed_updates"] += int(state[LIST_UPDATES])
    segments["listed_moves"] += int(state[LIST_MOVES])
    segments["na_max"] = max(segments["na_max"], steps.na_max)
    worked["screened_cd_solve"] += n["full"] + n["active"]
    worked["screened_cd_gather"] += n["gather"]
    worked["screened_cd_replay"] += n["replay"]
    return steps.result(state)


def screened_cd_solve_segmented(Q, diag, beta, grad, lo, hi, valid,
                                is_active, loss, tol_scale, max_iters, iters0,
                                mode, log_sweeps=None, stats=None):
    """``screened_cd_solve``'s segments with the kernels' plain stand-ins
    (``PlainSteps``) on CPU tensors: the same results as the twin, bit for
    bit, however short the log.  ``stats`` gets ``run_segments``'s
    counts."""
    steps = PlainSteps(Q, diag, beta, grad, lo, hi, valid, is_active, loss,
                       tol_scale, max_iters, iters0, mode, log_sweeps)
    state, n = run_segments(steps, max_iters)
    if stats is not None:
        stats.update(n)
    return steps.result(state)


def active_layout(na, S, dtype):
    """The active phase's layout on the card for ``na`` listed slots of S:
    (2, depth) with the compact vectors and a ring of ``depth`` rows in
    shared memory, (1, depth) with the ring alone, (0, 0) with neither."""
    from .. import _build

    depth = ctypes.c_int(0)
    itemsize = torch.empty((), dtype=dtype).element_size()
    layout = _build.load().adelie_screened_cd_active_layout(
        int(na), int(S), itemsize, ctypes.byref(depth))
    return layout, depth.value


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
