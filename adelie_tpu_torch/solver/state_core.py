"""Host-side solver state and the device screen cache.

Counterpart of ``adelie_tpu/solver/state_core.py``.  The host (numpy) side
keeps the dynamic screen/active bookkeeping and the per-lambda outputs, and
doubles as the warm-start carrier.  The device side keeps the residual, the
full gradient and a *screen cache*: the gathered screened columns, their
weighted Gram and the per-slot diagonals, in capacity-bucketed buffers.
"""

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..configs import configs
from ..utils import TORCH_DTYPE, bucket, bucket_pow2
from .pin import insert_cols, screen_eigh, screen_gram, screen_gram_extend


def group_cols(groups, group_sizes, p):
    """(G, Q) int64 column indices of each group, ``Q`` the largest group
    size rounded up to a power of 2, padded with ``p`` (a zero entry that
    ``group_sum`` appends)."""
    Q = bucket_pow2(int(group_sizes.max())) if len(group_sizes) else 1
    lane = np.arange(Q)
    cols = np.where(lane[None, :] < group_sizes[:, None],
                    groups[:, None] + lane[None, :], p)
    return cols.astype(np.int64)


def group_sum(x, cols):
    """Per-group sums of ``x`` (p,) or (p, C) over the groups of ``cols``
    (``group_cols``), in a fixed order: the (G, Q) gather, zero-padded, is
    folded in halves, ``x[:, :Q/2] + x[:, Q/2:]`` and so on.  So the sums do
    not depend on the device or the run (``index_add_`` on the card adds by
    atomics, in no fixed order), and a group of one is its entry."""
    if cols.shape[1] == 1:
        # every group one column: group g is column g
        return x
    pad = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    g = torch.cat([x, pad])[cols]
    h = g.shape[1] // 2
    while h:
        g = g[:, :h] + g[:, h:2 * h]
        h //= 2
    return g[:, 0]


def abs_grad_kernel(grad, cols_padded, beta_padded, penalty_cols, cols,
                    l2_scale):
    """Per-group norms ``||grad_g - (1-alpha) lmda pen_g beta_g||_2``
    (reference update_abs_grad, solver_base.hpp:21-110) over the groups of
    ``cols`` (``group_cols``).  Padded slots (``cols_padded < 0``) are
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


class ScreenCache:
    """Device-resident derived quantities of the current screen set."""

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
        self._pending_ext = None   # (s_old, Xnew) awaiting rebuild_weighted
        self._prev_ss = None       # screen_set of the last structure build
        self._A_prev = None        # incremental base for screen_gram_extend
        self._means_prev = None

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

    def _full_rebuild_structure(self, state):
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

        Xs = torch.zeros((state.n, S_cap), dtype=state.torch_dtype,
                         device=state.device)
        if S_val:
            Xs[:, :S_val] = state.X.gather(
                torch.as_tensor(cols, device=state.device))

        self.cols = cols
        self.S_val, self.S_cap, self.G_cap, self.qmax = S_val, S_cap, G_cap, qmax
        self.Xs = Xs
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
            or self.Xs is None
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
        dS = int(gs_new.sum())
        S_val = s_old + dS
        S_cap = screen_cap(S_val + self.qmax)
        G_cap = bucket(len(ss), configs.group_cap_min)
        dS_pad = bucket_pow2(dS)
        if s_old + dS_pad > S_cap:
            return False

        new_cols = np.concatenate(
            [np.arange(state.groups[g], state.groups[g] + state.group_sizes[g])
             for g in new_groups]
        ).astype(np.int64)
        Xnew = torch.zeros((state.n, dS_pad), dtype=state.torch_dtype,
                           device=state.device)
        Xnew[:, :dS] = state.X.gather(
            torch.as_tensor(new_cols, device=state.device))

        Xs = self.Xs
        if S_cap != self.S_cap:
            grown = torch.zeros((state.n, S_cap), dtype=Xs.dtype,
                                device=Xs.device)
            grown[:, : self.S_cap] = Xs
            Xs = grown
        Xs = insert_cols(Xs, Xnew, s_old)

        cols = np.concatenate([self.cols, new_cols])
        begins = np.concatenate(
            [self.begins_host,
             s_old + np.concatenate([[0], np.cumsum(gs_new)])[:-1]]
        ).astype(self.begins_host.dtype)
        sizes = np.concatenate([self.sizes_host, gs_new])

        self.cols = cols
        self.S_val, self.S_cap, self.G_cap = S_val, S_cap, G_cap
        self.Xs = Xs
        self._slot_buffers(state, begins, sizes, S_cap, G_cap, cols)
        self.begins_host = begins
        self.sizes_host = sizes
        self._prev_ss = np.asarray(ss).copy()
        self._pending_ext = (s_old, Xnew)
        # the old weighted quantities are the incremental base (None if
        # rebuild_weighted never ran for the previous structure: then
        # rebuild_weighted recomputes in full)
        self._A_prev = self.A
        self._means_prev = self.means_s
        self.A = None
        return True

    def rebuild_weighted(self, weights, intercept):
        """(Re)compute the Gram and the per-slot diagonals.  A pending
        append-only extension with the SAME weights tensor as the previous
        Gram extends it by one cross block; anything else recomputes."""
        ext = self._pending_ext
        if (
            ext is not None
            and self._A_prev is not None
            and weights is self._weights_ref
        ):
            s_old, Xnew = ext
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
            self.A, self.means_s = screen_gram_extend(
                A_pad, self.Xs, Xnew, weights, means_pad, s_old, intercept,
            )
        else:
            self.A, self.means_s = screen_gram(self.Xs, weights, intercept)
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
        "cd_iters": [], "cd_updates": [],
        # per pin solve, dry fits included: the screen capacity S of its
        # Gram (S > 1024 runs K2)
        "pin_caps": [],
    })
    total_time: float = 0.0
    error: str = ""

    # internals
    _cache: ScreenCache = field(default_factory=ScreenCache)
    _screen_version: int = 0
    _group_cols: Any = None      # device (G, Q) int64, see group_cols
    _penalty_cols: Any = None    # device (p,)

    def __post_init__(self):
        self.dtype = np.dtype(self.dtype)
        self.torch_dtype = TORCH_DTYPE[self.dtype]
        if self.groups is None:
            return
        G = len(self.groups)
        if self.max_screen_size is None:
            self.max_screen_size = G
        if self.max_active_size is None:
            self.max_active_size = G
        self._group_cols = torch.as_tensor(
            group_cols(np.asarray(self.groups), np.asarray(self.group_sizes),
                       self.p), device=self.device)
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
