"""The gaussian path over a host-streamed matrix.

Counterpart of the gaussian half of ``adelie_tpu/solver/streamed.py``.  A
full gradient costs a pass over the panel in host memory, so a chunk of
lambdas runs in three steps instead of the in-device driver's one loop:

1. optimistic fits (``fused.gaussian_chunk_step`` with no KKT check): each
   lambda against the screened columns only, with the same early exit,
   pin-failure and sweep-budget stops;
2. one streamed KKT pass: every processed lambda's weighted residual is
   rebuilt from its coefficients (``residual_stack``) and ``X.mul_many``
   returns all their gradients in one pass over the panel; ``kkt_finalize``
   turns them into group norms and verdicts;
3. certify and roll back (host): the accepted prefix ends at the first KKT
   failure or pin failure; after a KKT failure the state keeps the failed
   lambda's iterate (reference solver_base.hpp:605-686) and the screen set
   grows from its gradient.  A pin failure after a KKT failure is a
   speculative fit and does not raise.

The JAX package hands ``mul_many`` a ``lmda_chunk``-row stack padded past
the processed lambdas; here only the processed lambdas' residuals go, with
the same results (nothing reads the padded columns), so the dry fit at
``lmda_max`` costs K5 one column, not a hundred.  Not ported:
``debug_check_state`` (``state.check_state`` is ROADMAP.md queue 10) and the
streamed GLM, constrained and multi-response drivers (queues 5 and 7).
"""

import numpy as np
import torch

from ..configs import configs, matmul_precision
from ..exceptions import MaxCDsError
from ..utils import Stopwatch
from .fused import ChunkCarry, gaussian_chunk_step
from .gaussian import GaussianNaiveDriver

__all__ = ["StreamedGaussianDriver", "kkt_finalize", "residual_stack"]


def residual_stack(resid0, Xs, betas, beta0, w):
    """Per-lambda residuals from the emitted coefficients:
    ``R_c = resid0 - Xs (beta_c - beta0)``.  Returns the weighted
    residuals ``U = R * w`` (C, n) and their sums ``R w`` (C,)."""
    dB = betas - beta0[None, :]
    with matmul_precision():
        R = resid0[None, :] - dB @ Xs.T
        rsums = R @ w
    return R * w[None, :], rsums


def _thresholds(lmdas, alpha, penalty_groups):
    """(G, C) KKT thresholds ``lmda_c alpha p_g``."""
    lm = torch.as_tensor(np.asarray(lmdas, float) * alpha,
                         dtype=penalty_groups.dtype,
                         device=penalty_groups.device)
    return lm[None, :] * penalty_groups[:, None]


def kkt_finalize(Gfull, X_means, rsums, lmdas, alpha, penalty_cols, betas,
                 cols_padded, group_ids, penalty_groups, screen_mask,
                 num_groups, intercept):
    """Per-lambda group norms and KKT verdicts from the streamed (p, C)
    gradient stack (reference update_abs_grad solver_base.hpp:21-110 and
    kkt :410-433, over a whole chunk).  ``lmdas`` is a host array.
    Returns ``(abs_grad (G, C), kkts (C,) bool, G (p, C))``."""
    G = Gfull - X_means[:, None] * rsums[None, :] if intercept else Gfull
    p, C = G.shape
    # padded slots write to a spare last row, which is then cut off
    Bcols = torch.zeros((p + 1, C), dtype=G.dtype, device=G.device)
    Bcols[torch.where(cols_padded >= 0, cols_padded, p)] = betas.T
    Bcols = Bcols[:p]
    l2s = torch.as_tensor((1.0 - alpha) * np.minimum(lmdas, 1e30),
                          dtype=G.dtype, device=G.device)
    gadj = G - l2s[None, :] * (penalty_cols[:, None] * Bcols)
    sq = torch.zeros((num_groups, C), dtype=G.dtype, device=G.device)
    sq.index_add_(0, group_ids, gadj * gadj)
    abs_grad_all = torch.sqrt(torch.clamp(sq, min=0.0))
    viol = abs_grad_all > _thresholds(lmdas, alpha, penalty_groups)
    kkts = ~torch.any(viol & ~screen_mask[:, None], dim=0)
    return abs_grad_all, kkts, G


def _resid_at(resid0, Xs, beta_t, beta0):
    with matmul_precision():
        return resid0 - Xs @ (beta_t - beta0)


def _spec_viol_margin(abs_grad_all, lmdas, alpha, penalty_groups,
                      screen_mask, ok_mask):
    """Per-group worst relative KKT-violation margin over the chunk's
    converged lambdas (-inf for screened groups or no violation).  Dividing
    by the threshold keeps margins comparable across lambdas; unpenalized
    groups (threshold 0) are always screened, so the floor never picks."""
    thr = _thresholds(lmdas, alpha, penalty_groups)
    marg = (abs_grad_all - thr) / torch.clamp(thr, min=1e-30)
    marg = torch.where(ok_mask[None, :], marg, -torch.inf)
    marg = torch.max(marg, dim=1).values
    return torch.where(screen_mask, -torch.inf, marg)


def _union_speculative_violators(s, penalty_groups, screen_mask,
                                 abs_grad_all, lmdas, ok_mask, first_fail):
    """Grow the screen set by every group that violates KKT at any
    converged lambda of the failed chunk, not only at the first failure.

    The later fits are speculative, but their gradients came with the
    chunk's one pass, and they predict the groups that the coming retries
    would add one pass at a time.  Every accepted lambda still has to pass
    the next streamed certificate.  Over ``max_screen_size`` the first
    failure's violators, which the retry's screen must add anyway, go
    first, then the others by margin.  Gated by
    ``configs.stream_speculative_union``."""
    if not configs.stream_speculative_union:
        return
    room = s.max_screen_size - len(s.screen_set)
    if room <= 0:
        return
    ok = torch.as_tensor(ok_mask, device=abs_grad_all.device)
    marg_h = _spec_viol_margin(abs_grad_all, lmdas, s.alpha, penalty_groups,
                               screen_mask, ok).cpu().numpy()
    idx = np.flatnonzero(marg_h > 0)
    if not len(idx):
        return
    hash_ = s.screen_hash
    idx = np.asarray([int(i) for i in idx if int(i) not in hash_], int)
    if len(idx) > room:
        order = np.argsort(-marg_h[idx], kind="stable")
        lm_ff = float(np.asarray(lmdas[first_fail], s.dtype))
        thr_ff = lm_ff * float(s.alpha) * np.asarray(s.penalty, float)
        ag_ff = abs_grad_all[:, first_fail].cpu().numpy()
        mand = np.asarray([int(i) for i in idx if ag_ff[i] > thr_ff[i]], int)
        spec = idx[order]
        spec = spec[~np.isin(spec, mand)]
        mand = mand[np.argsort(-marg_h[mand], kind="stable")]
        idx = np.concatenate([mand, spec])[:room]
    s.extend_screen_set(idx)


class StreamedGaussianDriver(GaussianNaiveDriver):
    """Gaussian BASIL driver over a host-streamed matrix: the in-device
    driver's ``solve_path`` (screening, chunk schedule) with ``_run_chunk``
    replaced by optimistic fits, one streamed KKT pass and certify."""

    def _run_chunk(self, lmdas, record):
        s = self.s
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()
        if cache.A is None:
            cache.rebuild_weighted(s.weights, s.intercept)
        lmdas = np.asarray(lmdas, float)
        if not len(lmdas):
            s.benchmark["fit_screen"].append(sw.elapsed())
            return 0, False, True

        beta0 = cache.pad_screen_values(s.screen_beta, s)
        resid0 = s.resid
        carry = ChunkCarry(
            beta=beta0,
            active=cache.pad_group_bools(s.screen_is_active, s.device),
            resid=resid0, rsq=float(s.rsq), abs_grad=None,
            prev_dev=self._prev_dev, have_prev=self._have_prev_dev,
        )
        carry, emits = gaussian_chunk_step(cache, carry, lmdas,
                                           **self._loop_args())
        n_proc = len(emits)
        lm = lmdas[:n_proc]
        dones = np.asarray([e.done for e in emits])
        rsums_h = torch.stack([e.resid_sum for e in emits]).tolist()

        # one streamed pass for the chunk's KKT
        sw_k = Stopwatch().start()
        betas = torch.stack([e.beta for e in emits])
        U, rsums = residual_stack(resid0, cache.Xs, betas, beta0, s.weights)
        abs_grad_all, kkts, Gstack = kkt_finalize(
            s.X.mul_many(U), s.X_means, rsums, lm, s.alpha,
            s._penalty_cols, betas, cache.cols_padded, s._group_ids,
            self._penalty_groups_dev, s.screen_mask_dev(), len(s.groups),
            s.intercept,
        )
        kkts_h = kkts.cpu().numpy()
        s.benchmark["kkt"].append(sw_k.elapsed())

        # certify: the accepted prefix ends at the first KKT failure or pin
        # failure
        accept = dones & kkts_h
        fails = np.flatnonzero(~accept)
        pin_failed = bool(len(fails)) and not bool(dones[fails[0]])
        if len(fails):
            t = n_acc = int(fails[0])
            kkt_clean = early_stopped = False
            if pin_failed:
                # keep the last accepted iterate, not the unconverged one
                t -= 1
        else:
            t, n_acc = n_proc - 1, n_proc
            kkt_clean, early_stopped = True, carry.early_seen

        if record and n_acc:
            S_val = cache.S_val
            G_s = len(s.screen_set)
            betas_h = betas[:n_acc].cpu().numpy()
            actives_h = torch.stack([e.active for e in emits[:n_acc]]) \
                .cpu().numpy()
            for i, e in enumerate(emits[:n_acc]):
                self._record(lm[i], betas_h[i][:S_val], e.rsq, rsums_h[i],
                             cache)
                s.n_valid_solutions.append(True)
                s.active_sizes.append(int(actives_h[i].sum()))
                s.screen_sizes.append(len(s.screen_set))
                s.benchmark["cd_iters"].append(e.iters)
                s.benchmark["cd_updates"].append(e.iters * G_s)

        # advance to the target iterate (a KKT-failed fit keeps its
        # iterate for the retry)
        if t >= 0:
            s.screen_beta = betas[t].cpu().numpy()[: cache.S_val].copy()
            s.screen_is_active = \
                emits[t].active.cpu().numpy()[: len(s.screen_set)].copy()
            s.resid = _resid_at(resid0, cache.Xs, betas[t], beta0)
            s.rsq = emits[t].rsq
            s.resid_sum = rsums_h[t]
            s.abs_grad = abs_grad_all[:, t].cpu().numpy()
            s.grad = Gstack[:, t].clone()
            s.lmda = float(lm[t])
        if record and n_acc:
            self._prev_dev = emits[n_acc - 1].dev
            self._have_prev_dev = True
        s.benchmark["fit_screen"].append(sw.elapsed())
        if pin_failed:
            raise MaxCDsError(int(fails[0]))
        if not kkt_clean:
            _union_speculative_violators(
                s, self._penalty_groups_dev, s.screen_mask_dev(),
                abs_grad_all, lm, dones, first_fail=int(fails[0]))
        return n_acc, early_stopped, kkt_clean
