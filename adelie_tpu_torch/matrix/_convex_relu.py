"""Convex (gated) ReLU feature matrices, never formed (reference
matrix_naive_convex_relu, matrix_naive_convex_gated_relu; factories
``matrix.convex_relu`` and ``matrix.convex_gated_relu``).

Counterpart of ``adelie_tpu/matrix/_convex_relu.py``:

    gated:  Y = [D_1 Z, ..., D_m Z]    (n, m d)
    full:   X = [Y, -Y]                (n, 2 m d)

with ``D_k = diag(mask[:, k])``.  Column block k of ``Y^T u`` is
``Z^T (mask_k * u)``, for every k at once: on a dense Z one product
``(mask * u)^T Z``; on a sparse Z (scipy) a gather of the masked (n, m)
right-hand side through the padded CSC plane of ``_sparse.py`` and a sum
along its lanes, without densifying Z.
"""

import numpy as np
import scipy.sparse as sp
import torch

from ..configs import matmul_precision
from ..device import resolve_device
from ..utils import TORCH_DTYPE
from ._one_hot import _float_dtype
from ._sparse import MatrixNaiveSparse
from .base import MatrixNaiveBase


class MatrixNaiveConvexGatedRelu(MatrixNaiveBase):
    def __init__(self, mat, mask, *, dtype=None, device=None):
        self._is_sparse = sp.issparse(mat)
        if not self._is_sparse:
            mat = np.asarray(mat)
        self.dtype = _float_dtype(mat, dtype)
        self.torch_dtype = TORCH_DTYPE[self.dtype]
        self.device = resolve_device(device)
        n, d = mat.shape
        mask = np.asarray(mask).astype(bool)
        if mask.ndim != 2 or mask.shape[0] != n:
            raise ValueError(f"mask must be ({n}, m), got {mask.shape}")
        if self._is_sparse:
            self._Zsp = MatrixNaiveSparse(mat, dtype=self.dtype,
                                          layout="padded",
                                          device=self.device)
        else:
            self._Z = self._vec(mat)
        self._rows, self._d, self._m = n, d, mask.shape[1]
        self._cols = self._m * d
        self._mask = self._vec(mask)

    def _mul_md(self, u, square=False):
        """``[Z^T (mask_k * u)]_k`` (Z squared if ``square``) as (m d,)."""
        U = self._mask * u[:, None]                             # (n, m)
        with matmul_precision():
            if not self._is_sparse:
                Z = self._Z * self._Z if square else self._Z
                return (U.T @ Z).reshape(-1)
            vals = self._Zsp._cvals
            vals = vals * vals if square else vals
            G = U[self._Zsp._cidx]                              # (d, L, m)
            return (vals[:, :, None] * G).sum(dim=1).T.reshape(-1)

    def mul(self, v, w):
        return self._mul_md(v * w)

    def sq_mul(self, w):
        return self._mul_md(self._vec(w), square=True)

    def gather(self, indices):
        idx = torch.as_tensor(indices, device=self.device).long()
        k, j = idx // self._d, idx % self._d
        Zc = (self._Zsp.gather(j) if self._is_sparse
              else self._Z.index_select(1, j))
        return Zc * self._mask.index_select(1, k)

    def tmul(self, beta):
        """``sum_k mask_k * (Z @ B_k)`` for ``B`` = beta as (m, d); a 2-D
        beta a column at a time."""
        beta = self._vec(beta)
        if beta.dim() == 2:
            return torch.stack([self._tmul_n(b) for b in beta.T], dim=1)
        return self._tmul_n(beta)

    def _tmul_n(self, beta):
        B = beta.reshape(self._m, self._d)
        with matmul_precision():
            if not self._is_sparse:
                ZB = self._Z @ B.T                              # (n, m)
            else:
                G = B.T[self._Zsp._ridx]                        # (n, Lr, m)
                ZB = (self._Zsp._rvals[:, :, None] * G).sum(dim=1)
        return (ZB * self._mask).sum(dim=1)


class MatrixNaiveConvexRelu(MatrixNaiveConvexGatedRelu):
    """``X = [Y, -Y]`` (reference matrix_naive_convex_relu)."""

    def __init__(self, mat, mask, *, dtype=None, device=None):
        super().__init__(mat, mask, dtype=dtype, device=device)
        self._half = self._cols
        self._cols = 2 * self._half

    def mul(self, v, w):
        half = super().mul(v, w)
        return torch.cat([half, -half])

    def sq_mul(self, w):
        half = super().sq_mul(w)
        return torch.cat([half, half])

    def gather(self, indices):
        idx = torch.as_tensor(indices, device=self.device).long()
        sign = 1 - 2 * (idx >= self._half).to(self.torch_dtype)
        return super().gather(idx % self._half) * sign

    def tmul(self, beta):
        beta = self._vec(beta)
        return super().tmul(beta[:self._half] - beta[self._half:])
