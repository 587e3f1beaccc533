"""Sparse matrices (reference matrix_naive_sparse, matrix_cov_sparse;
factory ``matrix.sparse``).

Counterpart of ``adelie_tpu/matrix/_sparse.py``.

``MatrixNaiveSparse``, the (n, p) feature matrix, keeps the JAX package's
layouts and its ``"auto"`` rule: ``"dense"`` holds the densified matrix
(its products are ``torch.matmul``); ``"padded"`` holds zero-padded CSC
and CSR planes (``_padded_planes``), so ``mul`` and ``sq_mul`` are one
gather of ``u`` through the (p, L) column plane and a sum along its rows,
``tmul`` the same through the (n, L) row plane: no scatter, and so no
atomics on the card.  Beside the planes the CSC arrays stay on the
device, and the screen's ``gather`` scatters the nonzeros of the columns
asked for into their block there (each entry once), where the JAX
package densifies on the host with scipy.  The thresholds of ``"auto"``
were measured on a TPU (ROADMAP.md); they are kept so that both packages
pick the same layout.

``MatrixCovSparse``, a sparse covariance matrix: the CSC arrays (column
pointers, row indices, values) live on the device, and both products work
on the nonzeros of the columns asked for: they are gathered as one ragged
list (column by column, rows ascending within a column), then

* ``block`` scatters them into the (rows, cols) block, each entry once;
* ``mul`` lays each row's products out in a zero-padded (p, L) array, L
  the most nonzeros a row has among those columns, in column order, and
  sums it along its rows.  No sum goes through atomics (``index_add_`` on
  the card), so two runs give the same bits.
"""

import numpy as np
import scipy.sparse as sp
import torch

from ..configs import matmul_precision
from ..device import resolve_device
from ..utils import TORCH_DTYPE
from .base import MatrixCovBase, MatrixNaiveBase, _index
from .dense import _as_tensor

# "auto" densifies above this density when the dense array fits
# _DENSE_BYTES_MAX (the JAX package's values, measured on a TPU)
_DENSE_DENSITY_MIN = 2e-3
_DENSE_BYTES_MAX = 2 << 30


def _padded_planes(mat, dtype):
    """(vals, idx) zero-padded planes of a scipy CSC or CSR matrix along
    its compressed axis: row k holds the entries of column (CSC) or row
    (CSR) k in index order, then zeros with index 0; at least one lane."""
    counts = np.diff(mat.indptr)
    L = max(int(counts.max()) if counts.size else 0, 1)
    m = len(counts)
    vals = np.zeros((m, L), dtype)
    idx = np.zeros((m, L), np.int64)
    lane = np.arange(mat.nnz) - np.repeat(mat.indptr[:-1], counts)
    rows = np.repeat(np.arange(m), counts)
    vals[rows, lane] = mat.data
    idx[rows, lane] = mat.indices
    return vals, idx


def _csc_entries(indptr, cols, device):
    """The nonzeros of the columns ``cols`` (a tensor) of a CSC matrix with
    pointers ``indptr`` on ``device``: ``(entry, k)``, each entry's place
    in the CSC arrays and the position in ``cols`` of its column."""
    start = indptr[cols]
    counts = indptr[cols + 1] - start
    k = torch.repeat_interleave(torch.arange(len(cols), device=device),
                                counts)
    first = torch.cumsum(counts, 0) - counts
    entry = start[k] + torch.arange(len(k), device=device) - first[k]
    return entry, k


class MatrixNaiveSparse(MatrixNaiveBase):
    """A sparse (n, p) matrix from anything ``scipy.sparse`` takes.

    ``layout``: ``"auto"`` (default) densifies at density 2e-3 and above
    when the dense array fits 2 GiB, and otherwise builds padded planes,
    unless nonzero skew makes the planes larger than that dense array (then
    dense), or larger than both 2 GiB and twice the dense array (then it
    raises); ``"dense"`` and ``"padded"`` force a layout; ``"bcoo"``, which
    the JAX package removed, raises."""

    def __init__(self, mat, *, dtype=None, layout: str = "auto",
                 device=None):
        mat = sp.csc_matrix(mat)
        if dtype is None:
            dtype = mat.dtype if mat.dtype in (np.float32, np.float64) \
                else np.float64
        if layout == "bcoo":
            raise ValueError(
                "layout='bcoo' was removed from the JAX package (half the "
                "padded layout's bandwidth); use 'auto', 'padded' or "
                "'dense'.")
        if layout not in ("auto", "padded", "dense"):
            raise ValueError(f"layout must be one of ['auto', 'dense', "
                             f"'padded'], got {layout!r}")
        self.dtype = np.dtype(dtype)
        if self.dtype not in TORCH_DTYPE:
            raise TypeError(f"sparse matrices are float32 or float64, not "
                            f"{self.dtype}")
        self.torch_dtype = TORCH_DTYPE[self.dtype]
        self.device = resolve_device(device)
        mat = mat.astype(self.dtype)
        mat.sum_duplicates()
        mat.sort_indices()
        self._rows, self._cols = mat.shape
        csr = mat.tocsr()
        if layout == "auto":
            layout = self._auto_layout(mat, csr)
        self.layout = layout
        if layout == "dense":
            self._dense = self._vec(mat.toarray())
        else:
            dev = self.device
            self._indptr = torch.as_tensor(mat.indptr.astype(np.int64),
                                           device=dev)
            self._indices = torch.as_tensor(mat.indices.astype(np.int64),
                                            device=dev)
            self._data = self._vec(mat.data)
            cvals, cidx = _padded_planes(mat, self.dtype)
            rvals, ridx = _padded_planes(csr, self.dtype)
            self._cvals, self._rvals = self._vec(cvals), self._vec(rvals)
            self._cidx = torch.as_tensor(cidx, device=dev)
            self._ridx = torch.as_tensor(ridx, device=dev)

    def _auto_layout(self, csc, csr):
        """The JAX package's rule (adelie_tpu/matrix/_sparse.py)."""
        Lc = int(np.diff(csc.indptr).max()) if self._cols else 0
        Lr = int(np.diff(csr.indptr).max()) if self._rows else 0
        density = csc.nnz / max(self._rows * self._cols, 1)
        dense_bytes = self._rows * self._cols * self.dtype.itemsize
        padded_bytes = (self._cols * Lc + self._rows * Lr) * \
            (self.dtype.itemsize + 4)
        if dense_bytes <= _DENSE_BYTES_MAX and (
                density >= _DENSE_DENSITY_MIN or padded_bytes >= dense_bytes):
            return "dense"
        if padded_bytes > max(_DENSE_BYTES_MAX, 2 * dense_bytes):
            raise ValueError(
                f"sparse auto-layout: padded planes would be "
                f"{padded_bytes / 1e9:.1f} GB (max column nnz {Lc}, max row "
                f"nnz {Lr}) and the dense array {dense_bytes / 1e9:.1f} GB. "
                f"Split the matrix (matrix.concatenate of column blocks), "
                f"densify the skewed columns separately, or pass "
                f"layout='padded' explicitly to override.")
        return "padded"

    def _plane_mul(self, u, square=False):
        """``sum_l cvals[j, l]^(1 or 2) u[cidx[j, l]]`` for every column j."""
        vals = self._cvals * self._cvals if square else self._cvals
        return (vals * u[self._cidx]).sum(dim=1)

    def mul(self, v, w):
        if self.layout == "dense":
            with matmul_precision():
                return (v * w) @ self._dense
        return self._plane_mul(v * w)

    def gather(self, indices):
        cols = torch.as_tensor(indices, device=self.device).long()
        if self.layout == "dense":
            return self._dense.index_select(1, cols)
        entry, k = _csc_entries(self._indptr, cols, self.device)
        out = torch.zeros((self._rows, len(cols)), dtype=self.torch_dtype,
                          device=self.device)
        out[self._indices[entry], k] = self._data[entry]
        return out

    def tmul(self, beta):
        beta = self._vec(beta)
        if self.layout == "dense":
            with matmul_precision():
                return self._dense @ beta
        g = beta[self._ridx]                        # (n, Lr) or (n, Lr, L)
        vals = self._rvals if beta.dim() == 1 else self._rvals[:, :, None]
        return (vals * g).sum(dim=1)

    def sq_mul(self, w):
        w = self._vec(w)
        if self.layout == "dense":
            with matmul_precision():
                return w @ (self._dense * self._dense)
        return self._plane_mul(w, square=True)


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
        return _csc_entries(self._indptr, _index(cols, self.device),
                            self.device)

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
