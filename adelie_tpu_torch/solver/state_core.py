"""Host-side solver state and the device screen cache.

Counterpart of ``adelie_tpu/solver/state_core.py``.  The host (numpy) side
keeps the dynamic screen/active bookkeeping and the per-lambda outputs, and
doubles as the warm-start carrier.  The device side keeps the residual, the
full gradient and a *screen cache*: the gathered screened columns, their
weighted Gram and the per-slot diagonals, in capacity-bucketed buffers
(``ScreenCache``; for ``X (x) I_K``, ``KroneckerScreenCache``, which keeps
the child's columns and one Gram a class).
"""

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..configs import configs
from ..matrix.wrappers import MatrixNaiveKroneckerEye
from ..utils import TORCH_DTYPE, bucket, bucket_pow2
from ..utils.groups import GroupIndex, group_sum
from .pin import (insert_cols, kron_cross, kron_gram, screen_eigh,
                  screen_gram, screen_gram_extend)


def abs_grad_kernel(grad, cols_padded, beta_padded, penalty_cols, cols,
                    l2_scale):
    """Per-group norms ``||grad_g - (1-alpha) lmda pen_g beta_g||_2``
    (reference update_abs_grad, solver_base.hpp:21-110) over the groups of
    ``cols`` (a ``GroupIndex``).  Padded slots (``cols_padded < 0``) are
    dropped; the squares are summed by ``group_sum``.
    """
    # padded slots write to a spare last entry, which is then cut off
    p = grad.shape[0]
    beta_cols = torch.zeros(p + 1, dtype=grad.dtype, device=grad.device)
    beta_cols[torch.where(cols_padded >= 0, cols_padded, p)] = beta_padded
    beta_cols = beta_cols[:p]
    # (penalty * beta) first: at the huge-lambda dry fit beta is nonzero only
    # where penalty == 0, so the large l2_scale meets no nonzero operand
    gadj = grad - l2_scale * (penalty_cols * beta_cols)
    return torch.sqrt(torch.clamp(group_sum(gadj * gadj, cols), min=0.0))


def screen_cap(n: int) -> int:
    """The screen capacity for ``n`` slots: its bucket, rounded up to a
    multiple of 4, the pin kernels' unit (the extra slots are invalid)."""
    cap = bucket(n, configs.screen_cap_min)
    return cap + (-cap) % 4


def screen_layout(state):
    """The slot layout of the screen set: ``(begins, sizes, S_val, cols,
    qmax, S_cap, G_cap)``, the groups' first slots and sizes, the values
    they hold, their columns, the padded block width and the capacities."""
    ss = state.screen_set
    gs = state.group_sizes[ss]
    begins = np.concatenate([[0], np.cumsum(gs)])[:-1]
    S_val = int(begins[-1] + gs[-1]) if len(ss) else 0
    cols = np.concatenate(
        [np.arange(state.groups[g], state.groups[g] + state.group_sizes[g])
         for g in ss]
    ).astype(np.int64) if len(ss) else np.zeros(0, np.int64)
    qmax = bucket_pow2(int(gs.max())) if len(ss) else 1
    # a qmax margin so a group's block never runs off the end
    S_cap = screen_cap(S_val + qmax)
    G_cap = bucket(len(ss), configs.group_cap_min)
    return begins, gs, S_val, cols, qmax, S_cap, G_cap


class ScreenCache:
    """Device-resident derived quantities of the current screen set.

    The screened columns are gathered into one dense block ``Xs``; the
    screen solves read only the Gram ``A``, the slot buffers and the
    block's three products (``screen_grad``, ``screen_apply``,
    ``screen_apply_many``).  ``KroneckerScreenCache`` keeps the same
    interface for ``X (x) I_K``."""

    def __init__(self):
        self.version = -1          # host screen-set version this reflects
        self.cols = None           # np (S_val,) column indices
        self.S_val = 0
        self.S_cap = 0
        self.G_cap = 0
        self.qmax = 1
        self.Xs = None             # (n, S_cap) uncentered gathered block
        self.cols_padded = None    # (S_cap,) int64, -1 padding
        self.slot_begin = None     # (G_cap,) int64
        self.slot_size = None      # (G_cap,) int32
        self.penalty_slots = None  # (G_cap,)
        self.A = None
        self.means_s = None
        self.eigvals = None
        self.eigvecs = None
        self._weights_ref = None   # weights tensor A/means were built with
        self._pending_ext = None   # gathered extension awaiting
                                   # rebuild_weighted
        self._prev_ss = None       # screen_set of the last structure build
        self._A_prev = None        # incremental base for the Gram's extension
        self._means_prev = None

    # -- the screen block's products (callers set the matmul precision) -- #
    def screen_grad(self, u):
        """``Xs^T u`` (S_cap,) for a weighted residual ``u`` (n,)."""
        return u @ self.Xs

    def screen_apply(self, d):
        """``Xs d`` (n,) for screen values ``d`` (S_cap,)."""
        return self.Xs @ d

    def screen_apply_many(self, D):
        """``Xs D_c`` for every row of ``D`` (C, S_cap): (C, n)."""
        return D @ self.Xs.T

    # -- structure ------------------------------------------------------- #
    def rebuild_structure(self, state):
        """Re-gather columns after a screen-set change.  The screen set only
        grows by appending, so when the previous gather is a prefix of the
        new one only the new columns are gathered, and the Gram is extended
        by one cross block (``screen_gram_extend``)."""
        if self._try_extend_structure(state):
            return
        self._full_rebuild_structure(state)

    def _slot_buffers(self, state, begins, sizes, S_cap, G_cap, cols):
        dev = state.device
        cols_padded = np.full(S_cap, -1, np.int64)
        cols_padded[: len(cols)] = cols
        slot_begin = np.zeros(G_cap, np.int64)
        slot_size = np.zeros(G_cap, np.int32)
        penalty_slots = np.ones(G_cap, state.dtype)
        G = len(state.screen_set)
        slot_begin[:G] = begins
        slot_size[:G] = sizes
        penalty_slots[:G] = state.penalty[state.screen_set]
        self.cols_padded = torch.as_tensor(cols_padded, device=dev)
        self.slot_begin = torch.as_tensor(slot_begin, device=dev)
        self.slot_size = torch.as_tensor(slot_size, device=dev)
        self.penalty_slots = torch.as_tensor(penalty_slots, device=dev)

    def _gather_all(self, state, cols, S_cap):
        """Gather the screen's columns ``cols`` into a new block."""
        Xs = torch.zeros((state.n, S_cap), dtype=state.torch_dtype,
                         device=state.device)
        if len(cols):
            Xs[:, :len(cols)] = state.X.gather(
                torch.as_tensor(cols, device=state.device))
        self.Xs = Xs

    def _gather_new(self, state, cols, s_old, S_cap):
        """Gather the appended columns ``cols[s_old:]`` into the block.
        Returns the pending extension for ``_gram_extend``, or None (and
        changes nothing) when the block cannot take them."""
        dS = len(cols) - s_old
        dS_pad = bucket_pow2(dS)
        if s_old + dS_pad > S_cap:
            return None
        Xnew = torch.zeros((state.n, dS_pad), dtype=state.torch_dtype,
                           device=state.device)
        Xnew[:, :dS] = state.X.gather(
            torch.as_tensor(cols[s_old:], device=state.device))
        Xs = self.Xs
        if S_cap != self.S_cap:
            grown = torch.zeros((state.n, S_cap), dtype=Xs.dtype,
                                device=Xs.device)
            grown[:, : self.S_cap] = Xs
            Xs = grown
        self.Xs = insert_cols(Xs, Xnew, s_old)
        return (s_old, Xnew)

    def _full_rebuild_structure(self, state):
        ss = state.screen_set
        begins, gs, S_val, cols, qmax, S_cap, G_cap = screen_layout(state)
        self._gather_all(state, cols, S_cap)
        self.cols = cols
        self.S_val, self.S_cap, self.G_cap, self.qmax = S_val, S_cap, G_cap, qmax
        self._slot_buffers(state, begins, gs, S_cap, G_cap, cols)
        self.begins_host = begins
        self.sizes_host = gs
        self.A = None  # force the weighted rebuild
        self._pending_ext = None
        self._A_prev = None
        self._means_prev = None
        self._prev_ss = np.asarray(ss).copy()

    def _try_extend_structure(self, state):
        """Append-only path: gather just the new columns and stash the
        extension so rebuild_weighted can extend the Gram."""
        ss = state.screen_set
        prev = self._prev_ss
        if (
            prev is None
            or self.cols is None
            or self._pending_ext is not None   # don't stack unapplied exts
            or len(ss) <= len(prev)
            or not np.array_equal(ss[: len(prev)], prev)
        ):
            return False
        new_groups = np.asarray(ss[len(prev):], int)
        gs_new = state.group_sizes[new_groups]
        qmax_new = bucket_pow2(int(max(int(gs_new.max()), 1)))
        if qmax_new > self.qmax:
            return False
        s_old = self.S_val
        S_val = s_old + int(gs_new.sum())
        S_cap = screen_cap(S_val + self.qmax)
        G_cap = bucket(len(ss), configs.group_cap_min)

        new_cols = np.concatenate(
            [np.arange(state.groups[g], state.groups[g] + state.group_sizes[g])
             for g in new_groups]
        ).astype(np.int64)
        cols = np.concatenate([self.cols, new_cols])
        ext = self._gather_new(state, cols, s_old, S_cap)
        if ext is None:
            return False

        begins = np.concatenate(
            [self.begins_host,
             s_old + np.concatenate([[0], np.cumsum(gs_new)])[:-1]]
        ).astype(self.begins_host.dtype)
        sizes = np.concatenate([self.sizes_host, gs_new])

        self.cols = cols
        self.S_val, self.S_cap, self.G_cap = S_val, S_cap, G_cap
        self._slot_buffers(state, begins, sizes, S_cap, G_cap, cols)
        self.begins_host = begins
        self.sizes_host = sizes
        self._prev_ss = np.asarray(ss).copy()
        self._pending_ext = ext
        # the old weighted quantities are the incremental base (None if
        # rebuild_weighted never ran for the previous structure: then
        # rebuild_weighted recomputes in full)
        self._A_prev = self.A
        self._means_prev = self.means_s
        self.A = None
        return True

    # -- the weighted Gram ------------------------------------------------ #
    def _gram(self, weights, intercept):
        return screen_gram(self.Xs, weights, intercept)

    def _gram_extend(self, A_pad, means_pad, ext, weights, intercept):
        s_old, Xnew = ext
        return screen_gram_extend(A_pad, self.Xs, Xnew, weights, means_pad,
                                  s_old, intercept)

    def rebuild_weighted(self, weights, intercept):
        """(Re)compute the Gram and the per-slot diagonals.  A pending
        append-only extension with the SAME weights tensor as the previous
        Gram extends it by one cross block; anything else recomputes (an
        IRLS iteration's new weights always do), and consumes the pending
        extension either way."""
        ext = self._pending_ext
        if (
            ext is not None
            and self._A_prev is not None
            and weights is self._weights_ref
        ):
            A_pad = self._A_prev
            means_pad = self._means_prev
            if A_pad.shape[0] != self.S_cap:
                old = A_pad.shape[0]
                A_pad = torch.zeros((self.S_cap, self.S_cap), dtype=A_pad.dtype,
                                    device=A_pad.device)
                A_pad[:old, :old] = self._A_prev
                means_pad = torch.zeros(self.S_cap, dtype=A_pad.dtype,
                                        device=A_pad.device)
                means_pad[:old] = self._means_prev
            self.A, self.means_s = self._gram_extend(A_pad, means_pad, ext,
                                                     weights, intercept)
        else:
            # drop the old Gram, and the new columns of an extension the
            # full Gram covers, before the new one is formed: an IRLS
            # refresh would otherwise hold both
            ext = self._pending_ext = None
            self.A = self._A_prev = self.eigvals = self.eigvecs = None
            self.A, self.means_s = self._gram(weights, intercept)
        self._pending_ext = None
        self._weights_ref = weights
        self._A_prev = self.A
        self._means_prev = self.means_s
        self.eigvals, self.eigvecs = screen_eigh(
            self.A, self.slot_begin, self.slot_size, self.qmax
        )

    def pad_screen_values(self, values, state):
        out = np.zeros(self.S_cap, state.dtype)
        out[: self.S_val] = values
        return torch.as_tensor(out, device=state.device)

    def pad_group_bools(self, flags, device):
        out = np.zeros(self.G_cap, bool)
        out[: len(flags)] = flags
        return torch.as_tensor(out, device=device)


class KroneckerScreenCache(ScreenCache):
    """The screen cache of ``X (x) I_K`` (the multi-response problem):
    it keeps the Kronecker structure and never gathers the (n K, S)
    block, K - 1 of whose every K entries are zero.

    Slot j is flattened column ``q K + k``: column q of the child, class k
    (the intercepts' K slots included: column 0 of ``concatenate([1,
    X])``).  The cache keeps the child's gathered columns ``Xc`` (n,
    c_cap), each once, with one spare zero column past them, and each
    slot's (child position, class); the per-class Grams ``G`` of those
    columns (``pin.kron_gram``: K from one GEMM), scattered into the
    (S_cap, S_cap) slot layout that K1, K2 and K6 read as before (entries
    of two classes are 0).  The extension after an append forms only the
    new columns' cross blocks, per class.  The screen gradient, the
    residual update and the streamed residuals are (n, K) products with
    ``Xc``.  The multi-response problem runs without the implicit
    intercept (its intercepts are columns), so the Gram is not centered
    and the screen means are zero."""

    def __init__(self, K):
        super().__init__()
        self.K = int(K)
        self.Xc = None             # (n, c_cap) the child's columns, 0-padded
        self.ccols = None          # np the child's column indices in Xc
        self.G = None              # (K, c_cap, c_cap) per-class Grams
        self.slot_c = None         # (S_cap,) int64 position in Xc (padding:
                                   # the spare zero column)
        self.slot_k = None         # (S_cap,) int64 class
        self._classes = None       # per class (slots, positions), host

    # -- products with the child's columns -------------------------------- #
    def screen_grad(self, u):
        P = self.Xc.T @ u.reshape(-1, self.K)          # (c_cap, K)
        return P[self.slot_c, self.slot_k]

    def _values(self, D):
        """(..., S_cap) screen values -> (..., c_cap, K), by class."""
        out = torch.zeros(D.shape[:-1] + (self.Xc.shape[1], self.K),
                          dtype=D.dtype, device=D.device)
        S = self.S_val
        out[..., self.slot_c[:S], self.slot_k[:S]] = D[..., :S]
        return out

    def screen_apply(self, d):
        return (self.Xc @ self._values(d)).reshape(-1)

    def screen_apply_many(self, D):
        return (self.Xc @ self._values(D)).reshape(D.shape[0], -1)

    # -- structure ------------------------------------------------------- #
    def _slot_maps(self, state, cols, S_cap):
        K, dev = self.K, state.device
        pos = np.asarray([self._cpos[int(q)] for q in cols // K], np.int64)
        cls = (cols % K).astype(np.int64)
        slot_c = np.full(S_cap, self.Xc.shape[1] - 1, np.int64)
        slot_k = np.zeros(S_cap, np.int64)
        slot_c[:len(cols)], slot_k[:len(cols)] = pos, cls
        self.slot_c = torch.as_tensor(slot_c, device=dev)
        self.slot_k = torch.as_tensor(slot_k, device=dev)
        self._classes = [(np.flatnonzero(cls == k), pos[cls == k])
                         for k in range(K)]

    def _child_cols(self, state, qs):
        """Append the child columns ``qs`` not yet in ``Xc`` (in order of
        first appearance); returns (their first position, their block or
        None)."""
        c_old = len(self.ccols)
        fresh = [int(q) for q in dict.fromkeys(qs.tolist())
                 if int(q) not in self._cpos]
        c_cap = bucket(c_old + len(fresh) + 1, configs.screen_cap_min)
        child = state.X.child
        if self.Xc is None or c_cap != self.Xc.shape[1]:
            Xc = torch.zeros((child.rows(), c_cap), dtype=state.torch_dtype,
                             device=state.device)
            if self.Xc is not None:
                Xc[:, :c_old] = self.Xc[:, :c_old]
            self.Xc = Xc
        if not fresh:
            return c_old, None
        Xnew = child.gather(torch.as_tensor(fresh, device=state.device))
        self.Xc[:, c_old:c_old + len(fresh)] = Xnew
        for i, q in enumerate(fresh):
            self._cpos[q] = c_old + i
        self.ccols = np.concatenate([self.ccols, np.asarray(fresh, np.int64)])
        return c_old, Xnew

    def _gather_all(self, state, cols, S_cap):
        self.Xc, self.G = None, None
        self.ccols, self._cpos = np.zeros(0, np.int64), {}
        self._child_cols(state, cols // self.K)
        self._slot_maps(state, cols, S_cap)

    def _gather_new(self, state, cols, s_old, S_cap):
        c_old, Xnew = self._child_cols(state, cols[s_old:] // self.K)
        self._slot_maps(state, cols, S_cap)
        return (c_old, Xnew, s_old)

    # -- the weighted Gram ------------------------------------------------ #
    def _check_intercept(self, intercept):
        if intercept:
            raise ValueError(
                "a Kronecker screen block runs without the implicit "
                "intercept: the multi-response problem carries its "
                "intercepts as columns")

    def _scatter(self, A, s_from):
        """Write ``G``'s entries of the slots from ``s_from`` on (their rows
        and columns against every slot) into ``A``."""
        dev = A.device
        for k, (J, C) in enumerate(self._classes):
            g = self.G[k]
            new = J >= s_from
            Jn, Cn = (torch.as_tensor(J[new], device=dev),
                      torch.as_tensor(C[new], device=dev))
            Jd, Cd = torch.as_tensor(J, device=dev), torch.as_tensor(C,
                                                                     device=dev)
            A[Jd[:, None], Jn[None, :]] = g[Cd[:, None], Cn[None, :]]
            if s_from:
                A[Jn[:, None], Jd[None, :]] = g[Cn[:, None], Cd[None, :]]

    def _means(self):
        """The screen means, read only with the implicit intercept, which
        this block refuses: zero."""
        return torch.zeros(self.S_cap, dtype=self.Xc.dtype,
                           device=self.Xc.device)

    def _gram(self, weights, intercept):
        self._check_intercept(intercept)
        self.G = None
        W = weights.reshape(-1, self.K)
        self.G = kron_gram(self.Xc, W)
        A = torch.zeros((self.S_cap, self.S_cap), dtype=self.Xc.dtype,
                        device=self.Xc.device)
        self._scatter(A, 0)
        return A, self._means()

    def _gram_extend(self, A_pad, means_pad, ext, weights, intercept):
        self._check_intercept(intercept)
        c_old, Xnew, s_old = ext
        W = weights.reshape(-1, self.K)
        G = self.G
        c_cap = self.Xc.shape[1]
        if G.shape[1] != c_cap:
            grown = torch.zeros((G.shape[0], c_cap, c_cap), dtype=G.dtype,
                                device=G.device)
            grown[:, :G.shape[1], :G.shape[2]] = G
            G = grown
        if Xnew is not None:
            dc = Xnew.shape[1]
            cross = kron_cross(self.Xc, Xnew, W)
            G[:, :, c_old:c_old + dc] = cross
            G[:, c_old:c_old + dc, :] = cross.transpose(1, 2)
        self.G = G
        self._scatter(A_pad, s_old)
        return A_pad, self._means()


@dataclass
class NaiveStateBase:
    """Shared solver state (reference state_base.hpp:58-100)."""

    # problem definition
    X: Any = None
    groups: np.ndarray = None
    group_sizes: np.ndarray = None
    alpha: float = 1.0
    penalty: np.ndarray = None
    intercept: bool = True
    dtype: Any = np.float64
    n: int = 0
    p: int = 0
    device: torch.device = torch.device("cpu")

    # configs
    max_iters: int = int(1e5)
    tol: float = 1e-7
    # the block updates of groups of size > 1 (bcd.newton_solver)
    newton_tol: float = 1e-12
    newton_max_iters: int = 1000
    adev_tol: float = 0.9
    ddev_tol: float = 0.0
    early_exit: bool = True
    min_ratio: float = 1e-2
    lmda_path_size: int = 100
    max_screen_size: int = None
    max_active_size: int = None
    pivot_subset_ratio: float = 0.1
    pivot_subset_min: int = 1
    pivot_slack_ratio: float = 1.25
    screen_cap_active_mult: float = None
    screen_rule: str = "pivot"
    setup_lmda_max: bool = True
    setup_lmda_path: bool = True
    # lambdas fitted per chunk (BASIL batching): basil.screen sizes its
    # screen set by it, so it stays at the JAX package's value
    lmda_chunk: int = 100

    # dynamic invariants
    screen_set: np.ndarray = None          # (S_G,) group indices
    screen_begins: np.ndarray = None
    screen_beta: np.ndarray = None         # (S_val,)
    screen_is_active: np.ndarray = None    # (S_G,) bool
    lmda: float = np.inf
    lmda_max: Optional[float] = None
    lmda_path: Optional[np.ndarray] = None
    grad: Any = None                       # device (p,)
    abs_grad: np.ndarray = None            # host (G,)

    # outputs
    betas: list = field(default_factory=list)      # scipy sparse rows
    intercepts: list = field(default_factory=list)
    lmdas: list = field(default_factory=list)
    devs: list = field(default_factory=list)
    active_sizes: list = field(default_factory=list)
    screen_sizes: list = field(default_factory=list)
    n_valid_solutions: list = field(default_factory=list)
    benchmark: dict = field(default_factory=lambda: {
        "screen": [], "fit_screen": [],
        # per streamed pass of the host-streamed driver: its KKT seconds
        "kkt": [],
        # per processed lambda: CD sweeps and sweeps x screened groups
        # (gaussian), IRLS iterations (GLMs)
        "cd_iters": [], "cd_updates": [], "irls_iters": [],
        # per pin solve (a GLM's: per IRLS iteration), dry fits included:
        # the screen capacity S of its Gram (S > 1024 runs K2)
        "pin_caps": [],
    })
    total_time: float = 0.0
    error: str = ""

    # internals
    _cache: ScreenCache = field(default_factory=ScreenCache)
    _screen_version: int = 0
    _group_cols: Any = None      # GroupIndex on the device
    _penalty_cols: Any = None    # device (p,)

    def __post_init__(self):
        self.dtype = np.dtype(self.dtype)
        self.torch_dtype = TORCH_DTYPE[self.dtype]
        if isinstance(self.X, MatrixNaiveKroneckerEye):
            self._cache = KroneckerScreenCache(self.X.K)
        if self.groups is None:
            return
        G = len(self.groups)
        if self.max_screen_size is None:
            self.max_screen_size = G
        if self.max_active_size is None:
            self.max_active_size = G
        self._group_cols = GroupIndex(self.groups, self.group_sizes, self.p,
                                      self.device)
        self._penalty_cols = torch.as_tensor(
            np.repeat(self.penalty, self.group_sizes).astype(self.dtype),
            device=self.device,
        )

    @property
    def screen_hash(self):
        return set(int(i) for i in self.screen_set)

    def prune_inactive_zeros(self):
        """Drop all-zero groups from the sticky active set.  The active set
        is a performance hint: the pin solve's full sweeps and the KKT pass
        re-admit any group that should move."""
        if self.screen_is_active is None or not len(self.screen_set):
            return
        act = self.screen_is_active
        for i in np.flatnonzero(act):
            b = self.screen_begins[i]
            q = self.group_sizes[self.screen_set[i]]
            if not np.any(self.screen_beta[b:b + q]):
                act[i] = False

    def extend_screen_set(self, new_groups):
        if len(new_groups) == 0:
            return
        self.screen_set = np.concatenate(
            [self.screen_set, np.asarray(new_groups, self.screen_set.dtype)]
        )
        gs = self.group_sizes[self.screen_set]
        self.screen_begins = np.concatenate([[0], np.cumsum(gs)])[:-1].astype(int)
        add_val = int(self.group_sizes[np.asarray(new_groups, int)].sum())
        self.screen_beta = np.concatenate(
            [self.screen_beta, np.zeros(add_val, self.screen_beta.dtype)]
        )
        self.screen_is_active = np.concatenate(
            [self.screen_is_active, np.zeros(len(new_groups), bool)]
        )
        self._screen_version += 1

    @property
    def active_set_size(self):
        return int(self.screen_is_active.sum())

    def ensure_screen_cache(self):
        if self._cache.version != self._screen_version:
            self._cache.rebuild_structure(self)
            self._cache.version = self._screen_version
        return self._cache

    def update_abs_grad(self, lmda):
        cache = self.ensure_screen_cache()
        beta_padded = cache.pad_screen_values(self.screen_beta, self)
        ag = abs_grad_kernel(
            self.grad, cache.cols_padded, beta_padded, self._penalty_cols,
            self._group_cols, (1.0 - self.alpha) * min(lmda, 1e30),
        )
        self.abs_grad = ag.cpu().numpy()

    def screen_mask_dev(self):
        """Device (G,) bool mask of the screened groups, cached per screen
        version."""
        if getattr(self, "_screen_mask_ver", None) != self._screen_version:
            m = np.zeros(len(self.groups), bool)
            m[self.screen_set] = True
            self._screen_mask_cache = torch.as_tensor(m, device=self.device)
            self._screen_mask_ver = self._screen_version
        return self._screen_mask_cache
