"""Matrix protocol for adelie_tpu_torch.

Counterpart of ``adelie_tpu/matrix/base.py``.  The solver runs coordinate
descent in covariance form on a gathered screen block, so a matrix needs
only a few products, all returning tensors on the matrix's ``device``:

- :meth:`mul`       ``X^T (w * v)``, the full weighted gradient
- :meth:`mul_many`  ``X^T U_c`` for every row of ``U`` at once
- :meth:`gather`    the columns ``indices`` as an ``(n, k)`` block
- :meth:`tmul`      ``X @ beta``
- :meth:`sq_mul`    the weighted squared column norms
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
