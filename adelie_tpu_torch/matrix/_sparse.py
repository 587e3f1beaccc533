"""Sparse covariance matrix (reference matrix_cov_sparse; factory
``matrix.sparse(method="cov")``).

Counterpart of ``MatrixCovSparse`` in ``adelie_tpu/matrix/_sparse.py``.
The CSC arrays (column pointers, row indices, values) live on the device,
and both products work on the nonzeros of the columns asked for: they are
gathered as one ragged list (column by column, rows ascending within a
column), then

* ``block`` scatters them into the (rows, cols) block, each entry once;
* ``mul`` lays each row's products out in a zero-padded (p, L) array, L
  the most nonzeros a row has among those columns, in column order, and
  sums it along its rows.  No sum goes through atomics (``index_add_`` on
  the card), so two runs give the same bits.
"""

import numpy as np
import scipy.sparse as sp
import torch

from .base import MatrixCovBase, _index
from .dense import _as_tensor


class MatrixCovSparse(MatrixCovBase):
    def __init__(self, mat, *, dtype=None, device=None):
        mat = sp.csc_matrix(mat)
        if mat.shape[0] != mat.shape[1]:
            raise ValueError(f"a covariance matrix is square, got "
                             f"{mat.shape}")
        mat.sum_duplicates()
        mat.sort_indices()
        data, self.dtype = _as_tensor(mat.data, dtype, device,
                                      default=np.float64)
        self._data = data
        self.torch_dtype = data.dtype
        self.device = data.device
        self._indptr = torch.as_tensor(mat.indptr.astype(np.int64),
                                       device=self.device)
        self._indices = torch.as_tensor(mat.indices.astype(np.int64),
                                        device=self.device)
        self._cols = mat.shape[0]

    def _entries(self, cols):
        """The nonzeros of ``cols``: ``(entry, k)``, each entry's place in
        the CSC arrays and the position in ``cols`` of its column."""
        c = _index(cols, self.device)
        start = self._indptr[c]
        counts = self._indptr[c + 1] - start
        k = torch.repeat_interleave(
            torch.arange(len(c), device=self.device), counts)
        first = torch.cumsum(counts, 0) - counts
        entry = start[k] + torch.arange(len(k), device=self.device) - first[k]
        return entry, k

    def block(self, rows, cols):
        r = _index(rows, self.device)
        entry, k = self._entries(cols)
        ncols = len(_index(cols, self.device))
        if len(torch.unique(r)) == len(r):
            # each row's place in the block, -1 for a row not asked for
            place = torch.full((self._cols,), -1, dtype=torch.int64,
                               device=self.device)
            place[r] = torch.arange(len(r), device=self.device)
            rp = place[self._indices[entry]]
            keep = rp >= 0
            out = torch.zeros((len(r), ncols), dtype=self.torch_dtype,
                              device=self.device)
            out[rp[keep], k[keep]] = self._data[entry[keep]]
            return out
        full = torch.zeros((self._cols, ncols), dtype=self.torch_dtype,
                           device=self.device)
        full[self._indices[entry], k] = self._data[entry]
        return full[r]

    def mul(self, indices, values):
        vals = torch.as_tensor(values, dtype=self.torch_dtype,
                               device=self.device)
        entry, k = self._entries(indices)
        row = self._indices[entry]
        prod = self._data[entry] * vals[k]
        # each entry's rank among its row's entries, in column order
        order = torch.argsort(row, stable=True)
        row_s = row[order]
        counts = torch.bincount(row_s, minlength=self._cols)
        first = torch.cumsum(counts, 0) - counts
        rank = torch.arange(len(row_s), device=self.device) - first[row_s]
        L = int(counts.max()) if len(row_s) else 0
        lay = torch.zeros((self._cols, max(L, 1)), dtype=self.torch_dtype,
                          device=self.device)
        lay[row_s, rank] = prod[order]
        return lay.sum(dim=1)
