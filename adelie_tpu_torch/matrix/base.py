"""Matrix protocol for adelie_tpu_torch.

Counterpart of ``adelie_tpu/matrix/base.py``.  The solver runs coordinate
descent in covariance form on a gathered screen block, so a naive (n x p)
matrix needs only a few products, all returning tensors on the matrix's
``device``:

- :meth:`mul`       ``X^T (w * v)``, the full weighted gradient
- :meth:`mul_many`  ``X^T U_c`` for every row of ``U`` at once
- :meth:`gather`    the columns ``indices`` as an ``(n, k)`` block
- :meth:`tmul`      ``X @ beta``
- :meth:`sq_mul`    the weighted squared column norms

A covariance matrix (``MatrixCovBase``, the covariance method's ``A``)
gives blocks ``A[rows][:, cols]`` and products ``A[:, indices] @ values``;
a constraint matrix (``MatrixConstraintBase``, pinball's ``A``) its dense
(m, d) tensor.
"""

import numpy as np
import torch


class MatrixNaiveBase:
    """Abstract base.  Subclasses set ``_rows``, ``_cols``, ``dtype`` (a
    numpy dtype, as in the JAX package), ``torch_dtype`` and ``device``,
    and implement ``mul``, ``gather`` and ``tmul``."""

    _rows: int
    _cols: int
    dtype: np.dtype
    torch_dtype: torch.dtype
    device: torch.device

    @property
    def shape(self):
        return (self._rows, self._cols)

    def rows(self) -> int:
        return self._rows

    def cols(self) -> int:
        return self._cols

    def mul(self, v, w):
        """``X^T (w * v)`` -> (p,)."""
        raise NotImplementedError

    def mul_many(self, U):
        """``X^T U_c`` for every row of ``U`` (C, n) -> (p, C)."""
        ones = torch.ones(self._rows, dtype=self.torch_dtype,
                          device=self.device)
        return torch.stack([self.mul(u, ones) for u in U], dim=1)

    def gather(self, indices):
        """The columns ``indices`` -> (n, k)."""
        raise NotImplementedError

    def tmul(self, beta):
        """``X @ beta`` for ``beta`` (p,) or (p, L)."""
        raise NotImplementedError

    def sq_mul(self, w):
        """``diag(X^T W X)`` -> (p,)."""
        idx = torch.arange(self._cols, device=self.device)
        blk = self.gather(idx)
        return (blk * blk).T @ w

    def to_dense(self):
        idx = torch.arange(self._cols, device=self.device)
        return self.gather(idx).cpu().numpy()


def _index(indices, device):
    """Column or row indices as an int64 tensor on ``device``."""
    if isinstance(indices, torch.Tensor):
        return indices.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(indices, np.int64), device=device)


class MatrixCovBase:
    """A p x p PSD matrix ``A`` for the covariance method (reference
    matrix_cov_base.hpp:41-63): slices of ``A`` without necessarily forming
    it.  Subclasses set ``_cols``, ``dtype`` (numpy), ``torch_dtype`` and
    ``device``, and implement ``block`` and ``mul``; both return tensors on
    ``device``."""

    _cols: int
    dtype: np.dtype
    torch_dtype: torch.dtype
    device: torch.device

    def cols(self) -> int:
        return self._cols

    @property
    def shape(self):
        return (self._cols, self._cols)

    def block(self, rows, cols):
        """``A[rows][:, cols]`` -> (len(rows), len(cols))."""
        raise NotImplementedError

    def mul(self, indices, values):
        """``A[:, indices] @ values`` -> (p,)."""
        raise NotImplementedError

    def to_dense(self):
        idx = torch.arange(self._cols, device=self.device)
        return self.block(idx, idx).cpu().numpy()

    def bmul(self, subset, indices, values):
        """``A[subset][:, indices] @ values``."""
        return self.mul(indices, values)[_index(subset, self.device)]


class MatrixConstraintBase:
    """The ``A`` (m, d) of linear constraints ``lower <= A beta <= upper``
    (reference matrix_constraint_base.hpp:28-76).  Subclasses set
    ``_rows``, ``_cols``, ``dtype``, ``torch_dtype`` and ``device`` and
    implement ``dense``; every product goes through it."""

    _rows: int
    _cols: int
    dtype: np.dtype
    torch_dtype: torch.dtype
    device: torch.device

    def rows(self) -> int:
        return self._rows

    def cols(self) -> int:
        return self._cols

    def dense(self):
        """A as an (m, d) tensor on ``device``."""
        raise NotImplementedError

    def _vec(self, v):
        return torch.as_tensor(v, dtype=self.torch_dtype, device=self.device)

    def rmmul(self, j, Q):
        """``A[j] @ Q`` -> (d,)."""
        return self.dense()[j] @ self._vec(Q)

    def rvmul(self, j, v):
        """``A[j] . v`` -> 0-d."""
        return self.dense()[j] @ self._vec(v)

    def rvtmul(self, j, v):
        """``v * A[j]`` -> (d,)."""
        return v * self.dense()[j]

    def mul(self, v):
        """``A^T v`` -> (d,)."""
        return self.dense().T @ self._vec(v)

    def tmul(self, v):
        """``A v`` -> (m,)."""
        return self.dense() @ self._vec(v)

    def cov(self, Q):
        """``A Q A^T`` -> (m, m)."""
        A = self.dense()
        return A @ self._vec(Q) @ A.T

    def sp_mul(self, indices, values):
        """``A[indices]^T values`` -> (d,)."""
        return self.dense()[_index(indices, self.device)].T @ self._vec(values)
