"""One-hot expansion of discrete columns, never formed (reference
matrix_naive_one_hot; factory ``matrix.one_hot``).

Counterpart of ``adelie_tpu/matrix/_one_hot.py``.  Column g of Z is one
column when ``levels[g] <= 0`` (continuous) and ``levels[g]`` indicator
columns ``1{Z_g == k}`` otherwise.  The column metadata lives on the
device, so a screen's ``gather`` is one vectorized select.  ``mul`` and
``sq_mul`` sum each indicator column's rows through ``base.FixedSum``
(the rows of each level laid out once on the host), where the JAX package
scatter-adds: a fixed order, no atomics on the card.  ``mean`` is 0 and
``var`` 1 on indicator columns, so ``standardize`` leaves them as they are
(reference matrix_naive_one_hot.ipp:560-591).
"""

import numpy as np
import torch

from ..configs import matmul_precision
from ..device import resolve_device
from ..utils import TORCH_DTYPE
from .base import FixedSum, MatrixNaiveBase


def _float_dtype(mat, dtype):
    """``dtype``, else the array's if float32 or float64, else float64."""
    if dtype is None:
        dtype = mat.dtype if mat.dtype in TORCH_DTYPE else np.float64
    dtype = np.dtype(dtype)
    if dtype not in TORCH_DTYPE:
        raise TypeError(f"matrices are float32 or float64, not {dtype}")
    return dtype


def _levels_of(Z, levels):
    """``levels`` as an int array, each discrete column of ``Z`` checked to
    hold integers in [0, levels[g])."""
    d = Z.shape[1]
    levels = np.zeros(d, int) if levels is None else np.asarray(levels, int)
    if levels.shape != (d,):
        raise ValueError(f"levels must have {d} entries, got {levels.shape}")
    for g in np.flatnonzero(levels > 0):
        col = Z[:, g]
        if not (np.all(col == np.round(col)) and col.min(initial=0) >= 0
                and col.max(initial=0) < levels[g]):
            raise ValueError(f"column {g} must hold integers in "
                             f"[0, {levels[g]})")
    return levels


class MatrixNaiveOneHotDense(MatrixNaiveBase):
    def __init__(self, mat, levels=None, *, dtype=None, device=None):
        mat = np.asarray(mat)
        self.dtype = _float_dtype(mat, dtype)
        self.torch_dtype = TORCH_DTYPE[self.dtype]
        self.device = dev = resolve_device(device)
        n, d = mat.shape
        levels = _levels_of(mat, levels)
        widths = np.where(levels <= 0, 1, levels)
        outer = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
        p = int(outer[-1])
        col_feat = np.repeat(np.arange(d), widths)
        col_level = np.arange(p) - np.repeat(outer[:-1], widths)
        col_cont = np.repeat(levels <= 0, widths)

        self._rows, self._cols = n, p
        self._levels = levels
        self._outer = outer
        self._Z = self._vec(mat)
        self._col_feat = torch.as_tensor(col_feat, device=dev)
        self._col_level = self._vec(col_level)
        self._col_cont = torch.as_tensor(col_cont, device=dev)
        cont = np.flatnonzero(levels <= 0)
        disc = np.flatnonzero(levels > 0)
        self._cont_cols = torch.as_tensor(outer[cont], device=dev)
        self._Z_cont = self._vec(mat[:, cont])
        # row i's column in each discrete block: outer[g] + Z[i, g]
        disc_idx = outer[disc][None, :] + mat[:, disc].astype(np.int64)
        self._disc_idx = torch.as_tensor(disc_idx, device=dev)
        self._disc_sum = FixedSum(disc_idx, p, dev,
                                  src=np.repeat(np.arange(n), len(disc)))
        self._disc_cols = torch.as_tensor(np.flatnonzero(~col_cont),
                                          device=dev)

    def _sum(self, u, Zc):
        """``out[j] = sum_i u_i X_ij`` with the continuous columns' values
        ``Zc`` (Z_cont or its square)."""
        out = self._disc_sum.apply(u)
        if len(self._cont_cols):
            with matmul_precision():
                out[self._cont_cols] = u @ Zc
        return out

    def mul(self, v, w):
        return self._sum(v * w, self._Z_cont)

    def sq_mul(self, w):
        return self._sum(self._vec(w), self._Z_cont * self._Z_cont)

    def gather(self, indices):
        idx = torch.as_tensor(indices, device=self.device).long()
        Zc = self._Z.index_select(1, self._col_feat[idx])
        ind = (Zc == self._col_level[idx]).to(self.torch_dtype)
        return torch.where(self._col_cont[idx], Zc, ind)

    def tmul(self, beta):
        beta = self._vec(beta)
        out = beta[self._disc_idx].sum(dim=1)
        if len(self._cont_cols):
            with matmul_precision():
                out = out + self._Z_cont @ beta[self._cont_cols]
        return out

    def mean(self, w):
        out = super().mean(w)
        out[self._disc_cols] = 0
        return out

    def var(self, centers, w):
        out = super().var(centers, w)
        out[self._disc_cols] = 1
        return out
