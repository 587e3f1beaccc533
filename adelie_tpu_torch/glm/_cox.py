"""Cox proportional hazards GLM (stratified start-stop, Efron/Breslow ties).

Counterpart of ``adelie_tpu/glm/_cox.py`` (``GlmCox``, ``CoxWeightView``).
The index machinery (sort orders, searchsorted cut points, tie groups,
stratum offsets) depends only on the static (start, stop, status, strata,
weights) data, so it is built once on the host in numpy; ``gradient``,
``hessian`` and ``loss`` are then tensor code: ``exp``, gathers,
``cumsum``, permutation writes and sums over tie groups.

Per-stratum partial sums use the identity

    sum_{k in stratum} v_k 1{s_k <= t}  =  cs[b + cut] - cs[b]

with ``cs`` the cumulative sum of stratum-ordered values, a zero prepended,
``b`` the stratum's begin and ``cut`` the host's ``searchsorted`` count.
Every sum adds in a fixed order, the same on every device and in every
run: tie groups are contiguous runs of the stop order, so their sums are
``group_sum`` over the runs (``index_add_`` on the card adds by atomics,
in no fixed order), and the cumulative sums are ``fixed_cumsum``'s.  The
permutation writes have unique indices.
"""

import numpy as np
import torch

from ..logger import logger
from ..utils import types
from ..utils.groups import GroupIndex, group_sum
from . import GlmBase

# the row width of fixed_cumsum's row scans
SCAN_ROW = 1024


def fixed_cumsum(v):
    """The inclusive cumulative sum of ``v`` (n,), in an order fixed by n
    alone: rows of ``SCAN_ROW`` entries, each scanned along the row, then
    offset by the sum of the rows before it (the row totals' own
    ``fixed_cumsum``).  ``torch.cumsum`` of a 1-D tensor on the card is a
    device-wide scan whose look-back adds the blocks' sums in the order
    the blocks finish, so its last bits change from run to run; a scan
    along rows of a 2-D tensor is done by each row's block in a fixed
    order."""
    n = v.shape[0]
    k = SCAN_ROW
    m = -(-n // k)
    pad = torch.zeros(max(m, 2) * k - n, dtype=v.dtype, device=v.device)
    rows = torch.cat([v, pad]).view(-1, k).cumsum(1)
    if m <= 1:
        return rows[0, :n]
    before = torch.cat([torch.zeros(1, dtype=v.dtype, device=v.device),
                        fixed_cumsum(rows[:-1, -1])])
    return (rows + before[:, None]).view(-1)[:n]


class GlmCox(GlmBase):
    """Cox partial-likelihood GLM (reference glm/glm_cox.{hpp,ipp})."""

    def __init__(self, start, stop, status, strata=None, weights=None,
                 tie_method="efron", dtype=None):
        status = np.asarray(status)
        if dtype is None:
            dtype = (status.dtype if status.dtype in (np.float32, np.float64)
                     else np.float64)
        super().__init__("cox", status, weights, dtype)
        n = status.size
        self.tie_method = types.tie_method(tie_method)
        self.start = np.asarray(start, np.float64)
        self.stop = np.asarray(stop, np.float64)
        self.status = np.asarray(status, np.float64)
        if self.start.size != n or self.stop.size != n:
            raise ValueError("start/stop must be (n,) where status is (n,).")
        # a subject is at risk at u iff start < u <= stop; an event on a
        # row with stop <= start is outside its own risk set (an improper
        # likelihood whose intercept drifts without bound): censored
        bad = (self.stop <= self.start) & (self.status != 0)
        if np.any(bad):
            logger.warning(
                f"cox: {int(bad.sum())} row(s) have stop <= start with "
                "status=1; such rows are never at risk and their events "
                "are treated as censored.")
            self.status = np.where(bad, 0.0, self.status)
        if strata is None:
            strata = np.zeros(n, int)
        self.strata = np.asarray(strata, int)
        if self.strata.size != n:
            raise ValueError("strata must be (n,) where status is (n,).")
        self._build_index_machinery()

    # ------------------------------------------------------------------ #
    # host-side static index machinery (reference glm_cox.ipp:19-194)      #
    # ------------------------------------------------------------------ #

    def _build_index_machinery(self):
        n = self.status.size
        w = self.weights.numpy().astype(np.float64)
        strata = self.strata
        n_strata = int(strata.max()) + 1 if n else 1

        stop_order = np.empty(n, np.int64)
        start_order = np.empty(n, np.int64)
        begin_to = np.empty(n, np.int64)
        end_to = np.empty(n, np.int64)
        asum_t_idx = np.empty(n, np.int64)
        asum_s_idx = np.empty(n, np.int64)
        fwd_tt_idx = np.empty(n, np.int64)
        fwd_ts_idx = np.empty(n, np.int64)
        begin_so = np.empty(n, np.int64)
        tie_id = np.empty(n, np.int64)

        pos = 0
        tie_count = 0
        for m in range(n_strata):
            idx_m = np.nonzero(strata == m)[0]
            sz = len(idx_m)
            if sz == 0:
                continue
            b, e = pos, pos + sz
            so_stop = idx_m[np.argsort(self.stop[idx_m], kind="stable")]
            so_start = idx_m[np.argsort(self.start[idx_m], kind="stable")]
            stop_m = self.stop[so_stop]
            start_m = self.start[so_start]
            stop_order[b:e] = so_stop
            start_order[b:e] = so_start
            begin_to[b:e] = b
            end_to[b:e] = e
            begin_so[b:e] = b
            # at risk: sums over {stop >= u} and {start >= u}, u = stop_m
            asum_t_idx[b:e] = b + np.searchsorted(stop_m, stop_m, side="left")
            asum_s_idx[b:e] = b + np.searchsorted(start_m, stop_m,
                                                  side="left")
            # forward partial sums of stop-ordered values at thresholds
            fwd_tt_idx[b:e] = b + np.searchsorted(stop_m, stop_m,
                                                  side="right")
            fwd_ts_idx[b:e] = b + np.searchsorted(stop_m, start_m,
                                                  side="right")
            # tie groups: runs of equal stop within the stratum
            new_grp = np.ones(sz, bool)
            new_grp[1:] = stop_m[1:] != stop_m[:-1]
            tie_id[b:e] = tie_count + np.cumsum(new_grp) - 1
            tie_count += int(new_grp.sum())
            pos = e

        # the tie groups as runs of the stop order, for group_sum
        first_pos = (np.flatnonzero(np.r_[True, tie_id[1:] != tie_id[:-1]])
                     if n else np.zeros(0, np.int64))
        self._tie_index = GroupIndex(first_pos, np.diff(np.r_[first_pos, n]),
                                     n, "cpu")
        self._first_pos_gather = torch.as_tensor(
            first_pos[tie_id] if n else tie_id)

        status_to = self.status[stop_order]
        weights_to = w[stop_order]
        indic_to = status_to * (weights_to != 0)

        # weights_size_to / weights_mean_to (reference init_weights_*_to)
        seg_cnt = np.zeros(tie_count)
        np.add.at(seg_cnt, tie_id, indic_to)
        weights_size_to = indic_to * seg_cnt[tie_id]
        seg_w = np.zeros(tie_count)
        np.add.at(seg_w, tie_id, weights_to * indic_to)
        weights_mean_to = indic_to * seg_w[tie_id]
        nz = (status_to != 0) & (weights_to != 0)
        weights_mean_to[nz] = weights_mean_to[nz] / weights_size_to[nz]

        # scale (reference cox::_scale): Efron k_i / |H(t_i)| among the
        # events of nonzero weight tied at t_i
        scale_to = np.zeros(n)
        if self.tie_method == "efron":
            cum_indic = np.cumsum(indic_to) - indic_to  # exclusive prefix
            rank = cum_indic - cum_indic[first_pos[tie_id]]
            size = seg_cnt[tie_id]
            with np.errstate(divide="ignore", invalid="ignore"):
                scale_to = np.where(size > 0,
                                    indic_to * rank / np.maximum(size, 1),
                                    0.0)

        dt = self.dtype
        self._n_ties = tie_count
        self._stop_order = torch.as_tensor(stop_order)
        self._start_order = torch.as_tensor(start_order)
        self._begin_to = torch.as_tensor(begin_to)
        self._end_to = torch.as_tensor(end_to)
        self._begin_so = torch.as_tensor(begin_so)
        self._asum_t_idx = torch.as_tensor(asum_t_idx)
        self._asum_s_idx = torch.as_tensor(asum_s_idx)
        self._fwd_tt_idx = torch.as_tensor(fwd_tt_idx)
        self._fwd_ts_idx = torch.as_tensor(fwd_ts_idx)
        self._tie_id = torch.as_tensor(tie_id)
        self._status_to = torch.as_tensor(status_to.astype(dt))
        self._weights_to = torch.as_tensor(weights_to.astype(dt))
        self._indic_to = torch.as_tensor(indic_to.astype(dt))
        self._weights_size_to = torch.as_tensor(weights_size_to.astype(dt))
        self._weights_mean_to = torch.as_tensor(weights_mean_to.astype(dt))
        self._scale_to = torch.as_tensor(scale_to.astype(dt))
        self._status_dev = torch.as_tensor(self.status.astype(dt))

    def to(self, device, dtype=None):
        out = super().to(device, dtype)
        out._tie_index = self._tie_index.to(device)
        return out

    # ------------------------------------------------------------------ #
    # shared pieces                                                        #
    # ------------------------------------------------------------------ #

    @staticmethod
    def _csum0(v):
        """Cumulative sum with a zero prepended (partial-sum gathers)."""
        return torch.cat([torch.zeros(1, dtype=v.dtype, device=v.device),
                          fixed_cumsum(v)])

    @staticmethod
    def _sfx0(v):
        """Suffix sums, ``sfx[k] = sum_{j >= k} v[j]`` and ``sfx[n] = 0``.
        The at-risk sums are small tails of the ordering late in a path;
        as differences of large prefix sums they would cancel in float32
        (negative risk sums, an inf gradient), as differences of the small
        suffix sums they stay accurate."""
        rev = fixed_cumsum(v.flip(0)).flip(0)
        return torch.cat([rev, torch.zeros(1, dtype=v.dtype,
                                           device=v.device)])

    def _tie_sum(self, v):
        """Each position's sum over its tie group (``v`` in stop order)."""
        return group_sum(v, self._tie_index)[self._tie_id]

    def weight_bundle(self, w):
        """The weight-derived arrays from a weight vector ``w`` on the
        device: the index machinery does not depend on the weights, so
        this serves fold weights without rebuilding it (the host build
        computes the same arrays in float64 numpy for the default
        weights)."""
        w = torch.as_tensor(w, dtype=self.torch_dtype,
                            device=self._status_to.device)
        weights_to = w[self._stop_order]
        indic_to = self._status_to * (weights_to != 0)
        seg_cnt = self._tie_sum(indic_to)
        weights_size_to = indic_to * seg_cnt
        wm = indic_to * self._tie_sum(weights_to * indic_to)
        nz = (self._status_to != 0) & (weights_to != 0)
        weights_mean_to = torch.where(
            nz, wm / torch.clamp(weights_size_to, min=1.0),
            torch.zeros((), dtype=wm.dtype, device=wm.device))
        if self.tie_method == "efron":
            cum_indic = fixed_cumsum(indic_to) - indic_to
            rank = cum_indic - cum_indic[self._first_pos_gather]
            scale_to = torch.where(
                seg_cnt > 0, indic_to * rank / torch.clamp(seg_cnt, min=1.0),
                torch.zeros((), dtype=wm.dtype, device=wm.device))
        else:
            scale_to = torch.zeros_like(indic_to)
        return {"w": w, "weights_to": weights_to, "indic_to": indic_to,
                "weights_size_to": weights_size_to,
                "weights_mean_to": weights_mean_to, "scale_to": scale_to}

    def _wb_parts(self, wb):
        if wb is None:
            return (self.weights, self._indic_to, self._weights_mean_to,
                    self._scale_to)
        return (wb["w"], wb["indic_to"], wb["weights_mean_to"],
                wb["scale_to"])

    def _risk_total(self, z, indic_to, scale_to):
        """The at-risk sum less scale x the ties' sum, in stop order."""
        z_to = z[self._stop_order]
        z_so = z[self._start_order]
        sfx_t = self._sfx0(z_to)
        sfx_s = self._sfx0(z_so)
        risk1 = sfx_t[self._asum_t_idx] - sfx_t[self._end_to]
        risk2 = sfx_s[self._asum_s_idx] - sfx_s[self._end_to]
        ties_risk = indic_to * self._tie_sum(z_to * indic_to)
        # float32 rounding can leave a tiny negative where the sum is ~0;
        # clamp so 1/risk stays finite
        return torch.clamp(risk1 - risk2 - scale_to * ties_risk, min=0.0)

    def _accumulate(self, v_to, scale_factor, indic_to):
        """``acc`` (original order) with ``acc[stop_order[i]] = fwd_tt[i] -
        ties[i]`` and ``acc[start_order[i]] -= fwd_ts[i]`` (reference
        glm_cox.ipp:395-405)."""
        cs_v = self._csum0(v_to)
        gs1 = cs_v[self._fwd_tt_idx] - cs_v[self._begin_to]
        gs2 = cs_v[self._fwd_ts_idx] - cs_v[self._begin_so]
        gs3 = indic_to * self._tie_sum(scale_factor * v_to * indic_to)
        acc = torch.zeros_like(v_to)
        acc[self._stop_order] = gs1 - gs3
        acc[self._start_order] = acc[self._start_order] + (-gs2)
        return acc

    def _z(self, eta, w):
        # exp(eta - max): the gradient and Hessian depend on z only through
        # ratios to risk sums, so the shift removes the float32 overflow
        # near eta = 88 for free
        return w * torch.exp(eta - torch.max(eta))

    def _finite(self, v):
        return torch.where(torch.isfinite(v), v,
                           torch.zeros((), dtype=v.dtype, device=v.device))

    # ------------------------------------------------------------------ #
    # GLM interface                                                        #
    # ------------------------------------------------------------------ #

    def gradient(self, eta, wb=None):
        w, indic, wmean, scale = self._wb_parts(wb)
        z = self._z(eta, w)
        risk_total = self._risk_total(z, indic, scale)
        guard = ((self._status_to == 0) | (wmean == 0)).to(z.dtype)
        # z underflow can zero a risk set of nonzero event weight; those
        # positions add 0 to acc * z anyway: keep acc finite
        v_to = self._finite(self._status_to * wmean / (risk_total + guard))
        acc = self._accumulate(v_to, scale, indic)
        return w * self._status_dev - acc * z

    def hessian(self, eta, grad, wb=None):
        w, indic, wmean, scale = self._wb_parts(wb)
        z = self._z(eta, w)
        risk_total = self._risk_total(z, indic, scale)
        guard = ((self._status_to == 0) | (wmean == 0)).to(z.dtype)
        v_to = self._finite(self._status_to * wmean
                            / (risk_total**2 + guard))
        acc = self._accumulate(v_to, scale * (2.0 - scale), indic)
        return w * self._status_dev - grad - acc * z * z

    def loss(self, eta, wb=None):
        w, indic, wmean, scale = self._wb_parts(wb)
        eta_max = torch.max(eta)
        z = w * torch.exp(eta - eta_max)
        risk_total = self._risk_total(z, indic, scale)
        # positions with risk_total <= 0 have a zero status x weight-mean
        # coefficient, so the sentinel never contributes (the reference
        # clips at -double max, glm_cox.ipp:500)
        ok = risk_total > 0
        one = torch.ones((), dtype=z.dtype, device=z.device)
        log_term = torch.where(ok, torch.log(torch.where(ok, risk_total, one)),
                               -1e30 * one)
        return (-torch.sum(self._status_dev * w * (eta - eta_max))
                + torch.sum(self._status_to * wmean * log_term))

    def loss_full(self):
        wm = self._weights_mean_to.cpu().numpy().astype(np.float64)
        ws = self._weights_size_to.cpu().numpy().astype(np.float64)
        st = self._status_to.cpu().numpy().astype(np.float64)
        sc = self._scale_to.cpu().numpy().astype(np.float64)
        inner_arg = ws * wm * (1 - sc)
        ok = inner_arg > 0
        inner = np.where(ok, np.log(np.where(ok, inner_arg, 1.0)), -1e30)
        return torch.as_tensor((wm * st * inner).sum(),
                               dtype=self.torch_dtype)

    def loss_full_w(self, wb):
        """The saturated loss under a weight bundle, on the device."""
        wm = wb["weights_mean_to"]
        ws = wb["weights_size_to"]
        sc = wb["scale_to"]
        inner_arg = ws * wm * (1 - sc)
        ok = inner_arg > 0
        one = torch.ones((), dtype=wm.dtype, device=wm.device)
        inner = torch.where(ok, torch.log(torch.where(ok, inner_arg, one)),
                            -1e30 * one)
        return torch.sum(wm * self._status_to * inner)

    def inv_link(self, eta):
        return torch.exp(eta)

    def with_weights(self, weights):
        """A view with other weights (fold weights) that never rebuilds the
        index machinery."""
        return CoxWeightView(self, weights)

    def reweight(self, weights):
        return GlmCox(start=self.start, stop=self.stop, status=self.status,
                      strata=self.strata, weights=np.asarray(weights),
                      tie_method=self.tie_method, dtype=self.dtype)


class CoxWeightView:
    """``GlmCox`` with other weights: every weight-derived array comes from
    ``weight_bundle`` on the device, the index machinery is the base's."""

    is_multi = False
    name = "cox"
    opt = False

    def __init__(self, base, weights):
        self._base = base
        self.dtype = base.dtype
        self.torch_dtype = base.torch_dtype
        self.weights = torch.as_tensor(weights, dtype=base.torch_dtype,
                                       device=base._status_to.device)
        self.y = base.y

    def to(self, device, dtype=None):
        return CoxWeightView(self._base.to(device, dtype), self.weights)

    def _wb(self):
        return self._base.weight_bundle(self.weights)

    def gradient(self, eta):
        return self._base.gradient(eta, wb=self._wb())

    def hessian(self, eta, grad):
        return self._base.hessian(eta, grad, wb=self._wb())

    def inv_hessian_gradient(self, eta, grad, hess):
        return self._base.inv_hessian_gradient(eta, grad, hess)

    def loss(self, eta):
        return self._base.loss(eta, wb=self._wb())

    def loss_full(self):
        return self._base.loss_full_w(self._wb())

    def inv_link(self, eta):
        return self._base.inv_link(eta)
