"""Matrix protocol for adelie_tpu_torch.

Counterpart of ``adelie_tpu/matrix/base.py``.  The solver runs coordinate
descent in covariance form on a gathered screen block, so a naive (n x p)
matrix needs only a few products, all returning tensors on the matrix's
``device`` (a user's matrix implements the first, third and fourth; the
others have defaults):

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
import scipy.sparse as sp
import torch

from ..configs import matmul_precision


class MatrixNaiveBase:
    """Abstract base, and the user protocol: a user's matrix subclasses it,
    sets ``_rows``, ``_cols``, ``dtype`` (a numpy dtype, as in the JAX
    package), ``torch_dtype`` and ``device``, and implements ``mul``,
    ``gather`` and ``tmul`` on tensors on ``device``.  ``sq_mul``,
    ``mean``, ``var`` and the reference's column and block products
    derive from those (a subclass may override them); ``@``, ``.T``,
    ``[...]`` and ``to_dense`` return numpy arrays."""

    _rows: int
    _cols: int
    dtype: np.dtype
    torch_dtype: torch.dtype
    device: torch.device

    # columns a derived product gathers at a time
    _CHUNK = 4096

    @property
    def shape(self):
        return (self._rows, self._cols)

    @property
    def ndim(self):
        return 2

    def rows(self) -> int:
        return self._rows

    def cols(self) -> int:
        return self._cols

    def _vec(self, v):
        """``v`` (array or tensor) as a tensor of the matrix's dtype on its
        device."""
        return torch.as_tensor(v, dtype=self.torch_dtype, device=self.device)

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

    def _chunked_cols(self):
        """``(start, block)`` for blocks of at most ``_CHUNK`` columns."""
        for s in range(0, self._cols, self._CHUNK):
            e = min(s + self._CHUNK, self._cols)
            yield s, self.gather(torch.arange(s, e, device=self.device))

    def sq_mul(self, w):
        """``diag(X^T W X)`` -> (p,), gathered ``_CHUNK`` columns at a
        time."""
        w = self._vec(w)
        with matmul_precision():
            return torch.cat([w @ (blk * blk)
                              for _, blk in self._chunked_cols()])

    def mean(self, w):
        """Weighted column means ``X^T w`` (weights summing to 1)."""
        w = self._vec(w)
        return self.mul(torch.ones_like(w), w)

    def var(self, centers, w):
        """Weighted column variances about ``centers``:
        ``sum_i w_i (X_ij - c_j)^2``."""
        w, c = self._vec(w), self._vec(centers)
        return (self.sq_mul(w) - 2 * c * self.mul(torch.ones_like(w), w)
                + c * c * w.sum())

    def cmul(self, j, v, w):
        """``X[:, j]^T (w * v)`` -> 0-d."""
        col = self.gather([j])[:, 0]
        return col @ (self._vec(v) * self._vec(w))

    def ctmul(self, j, v):
        """``v * X[:, j]`` -> (n,)."""
        return self._vec(v) * self.gather([j])[:, 0]

    def bmul(self, j, q, v, w):
        """``X[:, j:j+q]^T (w * v)`` -> (q,)."""
        blk = self.gather(np.arange(j, j + q))
        with matmul_precision():
            return (self._vec(v) * self._vec(w)) @ blk

    def btmul(self, j, q, v):
        """``X[:, j:j+q] @ v`` -> (n,)."""
        blk = self.gather(np.arange(j, j + q))
        with matmul_precision():
            return blk @ self._vec(v)

    def cov(self, j, q, sqrt_weights):
        """The weighted Gram of the columns ``[j, j+q)`` -> (q, q)."""
        blk = self.gather(np.arange(j, j + q)) \
            * self._vec(sqrt_weights)[:, None]
        with matmul_precision():
            return blk.T @ blk

    def sp_tmul(self, betas):
        """``betas @ X^T`` for a scipy.sparse ``betas`` (L, p) -> (L, n):
        one gather of the columns any row uses, then one product."""
        betas = sp.csr_matrix(betas)
        cols = np.unique(betas.indices)
        if cols.size == 0:
            return torch.zeros((betas.shape[0], self._rows),
                               dtype=self.torch_dtype, device=self.device)
        blk = self.gather(cols)
        sub = self._vec(betas[:, cols].toarray())
        with matmul_precision():
            return sub @ blk.T

    def __matmul__(self, other):
        return self.tmul(self._vec(other)).cpu().numpy()

    @property
    def T(self):
        """A transpose view for ``X.T @ v``."""
        return MatrixNaiveTranspose(self)

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key, slice(None))
        rkey, ckey = key
        if isinstance(ckey, slice):
            cols = np.arange(*ckey.indices(self._cols))
        else:
            cols = np.atleast_1d(np.asarray(ckey, np.int64))
        return self.gather(cols).cpu().numpy()[rkey]

    def to_dense(self):
        return torch.cat([blk for _, blk in self._chunked_cols()],
                         dim=1).cpu().numpy()


class MatrixNaiveTranspose:
    """``X.T`` of a :class:`MatrixNaiveBase`: ``X.T @ v`` for 1-D or 2-D
    ``v`` as unweighted ``mul`` calls (``X^T v == mul(v, ones)``), a numpy
    array; nothing is densified."""

    def __init__(self, mat):
        self._mat = mat
        self.ndim = 2

    @property
    def shape(self):
        n, p = self._mat.shape
        return (p, n)

    @property
    def T(self):
        return self._mat

    def __matmul__(self, v):
        v = np.asarray(v)
        if v.ndim < 1 or v.ndim > 2:
            raise ValueError("Right argument must be 1 or 2-dimensional.")
        m = self._mat
        ones = torch.ones(m.rows(), dtype=m.torch_dtype, device=m.device)
        if v.ndim == 1:
            return m.mul(m._vec(v), ones).cpu().numpy()
        return np.stack([m.mul(m._vec(v[:, i]), ones).cpu().numpy()
                         for i in range(v.shape[1])], axis=1)


class FixedSum:
    """A scatter-add in a fixed order: ``apply(vals)`` returns ``out``
    (size, ...) with ``out[t] = sum of vals[src[e]] over the entries e
    whose target[e] == t``, in ascending e.  The entries are laid out once
    on the host as a (targets, depth) table padded with a zero entry; a
    gather and a sum along the table's rows replace the atomics of
    ``index_add_`` on the card, so two runs give the same bits."""

    def __init__(self, target, size, device, src=None):
        target = np.asarray(target, np.int64).ravel()
        src = (np.arange(len(target)) if src is None
               else np.asarray(src, np.int64).ravel())
        order = np.argsort(target, kind="stable")
        uniq, first, counts = np.unique(target[order], return_index=True,
                                        return_counts=True)
        depth = int(counts.max()) if len(counts) else 1
        self.n_src = int(src.max()) + 1 if len(src) else 0
        table = np.full((len(uniq), depth), self.n_src, np.int64)
        lane = np.arange(len(target)) - np.repeat(first, counts)
        table[np.repeat(np.arange(len(uniq)), counts), lane] = src[order]
        # each output's slot in the sums, the last (zero) one if none
        slot = np.full(size, len(uniq), np.int64)
        slot[uniq] = np.arange(len(uniq))
        self._table = torch.as_tensor(table, device=device)
        self._slot = torch.as_tensor(slot, device=device)

    def apply(self, vals):
        pad = vals.new_zeros((1,) + tuple(vals.shape[1:]))
        ext = torch.cat([vals[:self.n_src], pad])
        sums = ext[self._table].sum(dim=1)
        return torch.cat([sums, pad])[self._slot]


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
