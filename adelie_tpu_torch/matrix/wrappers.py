"""Composition wrappers: standardize, column and row subsets, column and
row concatenation, the naive block-diagonal matrix, ``X (x) I_K`` and the
block-diagonal covariance matrix.

Counterpart of ``adelie_tpu/matrix/wrappers.py`` (reference
matrix_naive_standardize, matrix_naive_subset, matrix_naive_concatenate,
matrix_naive_block_diag, matrix_naive_kronecker_eye,
matrix_cov_block_diag).  Each wrapper composes its children's products and
lives on their device; children on different devices, or of different
dtypes, raise.  Where the JAX package scatter-adds (a column subset's
``tmul``, a row subset's expansion, where repeated indices must add), the
sums go through ``base.FixedSum``: a fixed order, no atomics on the card.

The multi-response problem runs on ``kronecker_eye(concatenate([1, X]),
K)`` (``solver/multi.py``).  Its screen block never gathers the (n K, m)
columns of the Kronecker: the screen cache keeps the child's columns and
forms one Gram a class (``solver/state_core.py``,
``KroneckerScreenCache``).  ``gather`` here serves ``to_dense`` and the
tests.
"""

import numpy as np
import scipy.sparse as sp
import torch

from ..configs import matmul_precision
from .base import FixedSum, MatrixCovBase, MatrixNaiveBase

__all__ = ["MatrixCovBlockDiag", "MatrixNaiveBlockDiag",
           "MatrixNaiveCConcatenate", "MatrixNaiveCSubset",
           "MatrixNaiveKroneckerEye", "MatrixNaiveRConcatenate",
           "MatrixNaiveRSubset", "MatrixNaiveStandardize"]


def _common(mats):
    """The children's (dtype, torch dtype, device); a mix raises."""
    devices = {m.device for m in mats}
    if len(devices) > 1:
        raise ValueError(f"matrices on different devices: "
                         f"{sorted(str(d) for d in devices)}")
    dtypes = {np.dtype(m.dtype) for m in mats}
    if len(dtypes) > 1:
        raise ValueError(f"matrices of different dtypes: "
                         f"{sorted(str(d) for d in dtypes)}")
    m = mats[0]
    return np.dtype(m.dtype), m.torch_dtype, m.device


def _any_streaming(mats):
    return any(getattr(m, "is_streaming", False) for m in mats)


def refuse_wrapped_stream(X):
    """Raise ``NotImplementedError`` for a wrapper in ``X`` that holds a
    host-streamed matrix where the streamed drivers cannot take it: they
    take the bare panel, a column concatenation holding it and
    ``X (x) I_K`` of either.  The JAX package refuses every other wrapper
    of a streamed panel (its ``mul_spec``): each of its products would be
    a pass over the panel, and no streamed KKT would certify the path."""
    if not getattr(X, "is_streaming", False):
        return
    if isinstance(X, MatrixNaiveCConcatenate):
        for m in X._children:
            refuse_wrapped_stream(m)
    elif isinstance(X, MatrixNaiveKroneckerEye):
        refuse_wrapped_stream(X.child)
    elif isinstance(X, (MatrixNaiveStandardize, MatrixNaiveCSubset,
                        MatrixNaiveRSubset, MatrixNaiveRConcatenate,
                        MatrixNaiveBlockDiag)):
        raise NotImplementedError(
            f"{type(X).__name__} over a host-streamed SNP matrix is not "
            "supported: the streamed driver takes only the bare panel "
            "(matrix.snp_unphased(..., streaming=True)) or a column "
            "concatenation of it (matrix.concatenate(..., axis=1))")


def _index_np(indices):
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu().numpy()
    return np.asarray(indices, np.int64)


class MatrixNaiveCConcatenate(MatrixNaiveBase):
    """The columns of its children side by side (reference
    matrix_naive_concatenate, the column variant)."""

    def __init__(self, mats):
        mats = list(mats)
        if not mats:
            raise ValueError("concatenate needs at least one matrix")
        self._children = mats
        self.dtype, self.torch_dtype, self.device = _common(mats)
        self._rows = mats[0].rows()
        if any(m.rows() != self._rows for m in mats):
            raise ValueError(f"matrices of different row counts: "
                             f"{[m.rows() for m in mats]}")
        self._offsets = np.concatenate(
            [[0], np.cumsum([m.cols() for m in mats])]).astype(np.int64)
        self._cols = int(self._offsets[-1])

    @property
    def is_streaming(self):
        return _any_streaming(self._children)

    @property
    def sweeps(self):
        """Passes over host memory: those of its streamed children."""
        return max((getattr(m, "sweeps", 0) for m in self._children),
                   default=0)

    def mul(self, v, w):
        return torch.cat([m.mul(v, w) for m in self._children])

    def mul_many(self, U):
        return torch.cat([m.mul_many(U) for m in self._children], dim=0)

    def gather(self, indices):
        idx = _index_np(indices)
        out = torch.empty((self._rows, len(idx)), dtype=self.torch_dtype,
                          device=self.device)
        child_of = np.searchsorted(self._offsets, idx, side="right") - 1
        for c in np.unique(child_of):
            pos = np.flatnonzero(child_of == c)
            local = torch.as_tensor(idx[pos] - self._offsets[c],
                                    device=self.device)
            out[:, torch.as_tensor(pos, device=self.device)] = \
                self._children[c].gather(local)
        return out

    def tmul(self, beta):
        beta = torch.as_tensor(beta, dtype=self.torch_dtype,
                               device=self.device)
        out = None
        for c, m in enumerate(self._children):
            term = m.tmul(beta[self._offsets[c]:self._offsets[c + 1]])
            out = term if out is None else out + term
        return out

    def sq_mul(self, w):
        return torch.cat([m.sq_mul(w) for m in self._children])


class MatrixNaiveStandardize(MatrixNaiveBase):
    """``(X - 1 c^T) / s``, never formed (reference
    matrix_naive_standardize): every product is the child's, corrected by
    the centers ``c`` and scales ``s``."""

    def __init__(self, mat, centers, scales):
        self._child = mat
        self.dtype, self.torch_dtype, self.device = _common([mat])
        self._rows, self._cols = mat.rows(), mat.cols()
        self._centers = self._vec(centers)
        self._scales = self._vec(scales)

    @property
    def is_streaming(self):
        return bool(getattr(self._child, "is_streaming", False))

    @property
    def centers(self):
        return self._centers

    @property
    def scales(self):
        return self._scales

    def mul(self, v, w):
        raw = self._child.mul(v, w)
        return (raw - self._centers * (v * w).sum()) / self._scales

    def gather(self, indices):
        idx = torch.as_tensor(indices, device=self.device).long()
        blk = self._child.gather(idx)
        return (blk - self._centers[idx]) / self._scales[idx]

    def tmul(self, beta):
        beta = self._vec(beta)
        scaled = beta / (self._scales if beta.dim() == 1
                         else self._scales[:, None])
        with matmul_precision():
            return self._child.tmul(scaled) - self._centers @ scaled

    def sq_mul(self, w):
        w = self._vec(w)
        raw = self._child.sq_mul(w)
        m1 = self._child.mul(torch.ones_like(w), w)
        c = self._centers
        return (raw - 2 * c * m1 + c * c * w.sum()) / self._scales ** 2


class MatrixNaiveCSubset(MatrixNaiveBase):
    """The child's columns ``subset`` (reference matrix_naive_subset, the
    column variant); a column may repeat."""

    def __init__(self, mat, subset):
        self._child = mat
        self.dtype, self.torch_dtype, self.device = _common([mat])
        sub = _index_np(subset)
        self._rows, self._cols = mat.rows(), len(sub)
        self._subset = torch.as_tensor(sub, device=self.device)
        # tmul's beta into the child's columns: repeated columns add
        self._to_child = FixedSum(sub, mat.cols(), self.device)

    @property
    def is_streaming(self):
        return bool(getattr(self._child, "is_streaming", False))

    def mul(self, v, w):
        return self._child.mul(v, w)[self._subset]

    def gather(self, indices):
        idx = torch.as_tensor(indices, device=self.device).long()
        return self._child.gather(self._subset[idx])

    def tmul(self, beta):
        return self._child.tmul(self._to_child.apply(self._vec(beta)))

    def sq_mul(self, w):
        return self._child.sq_mul(w)[self._subset]


class MatrixNaiveRSubset(MatrixNaiveBase):
    """The child's rows ``subset`` (reference matrix_naive_subset, the row
    variant); a row may repeat."""

    def __init__(self, mat, subset):
        self._child = mat
        self.dtype, self.torch_dtype, self.device = _common([mat])
        sub = _index_np(subset)
        self._rows, self._cols = len(sub), mat.cols()
        self._subset = torch.as_tensor(sub, device=self.device)
        # an (n_sub,) vector laid out on the child's rows: repeated rows add
        self._to_child = FixedSum(sub, mat.rows(), self.device)

    @property
    def is_streaming(self):
        return bool(getattr(self._child, "is_streaming", False))

    def _expand(self, v):
        return self._to_child.apply(self._vec(v))

    def mul(self, v, w):
        ones = torch.ones(self._child.rows(), dtype=self.torch_dtype,
                          device=self.device)
        return self._child.mul(self._expand(v * w), ones)

    def gather(self, indices):
        return self._child.gather(indices)[self._subset]

    def tmul(self, beta):
        return self._child.tmul(beta)[self._subset]

    def sq_mul(self, w):
        return self._child.sq_mul(self._expand(w))


class MatrixNaiveRConcatenate(MatrixNaiveBase):
    """The rows of its children stacked (reference
    matrix_naive_concatenate, the row variant)."""

    def __init__(self, mats):
        mats = list(mats)
        if not mats:
            raise ValueError("concatenate needs at least one matrix")
        self._children = mats
        self.dtype, self.torch_dtype, self.device = _common(mats)
        self._cols = mats[0].cols()
        if any(m.cols() != self._cols for m in mats):
            raise ValueError(f"matrices of different column counts: "
                             f"{[m.cols() for m in mats]}")
        self._row_offsets = np.concatenate(
            [[0], np.cumsum([m.rows() for m in mats])]).astype(np.int64)
        self._rows = int(self._row_offsets[-1])

    @property
    def is_streaming(self):
        return _any_streaming(self._children)

    def _split(self, v):
        o = self._row_offsets
        return [v[o[c]:o[c + 1]] for c in range(len(self._children))]

    def mul(self, v, w):
        out = None
        for m, vv, ww in zip(self._children, self._split(v), self._split(w)):
            term = m.mul(vv, ww)
            out = term if out is None else out + term
        return out

    def gather(self, indices):
        return torch.cat([m.gather(indices) for m in self._children])

    def tmul(self, beta):
        return torch.cat([m.tmul(beta) for m in self._children])

    def sq_mul(self, w):
        out = None
        for m, ww in zip(self._children, self._split(self._vec(w))):
            term = m.sq_mul(ww)
            out = term if out is None else out + term
        return out


class MatrixNaiveBlockDiag(MatrixNaiveBase):
    """Its children on the diagonal, zeros elsewhere (reference
    matrix_naive_block_diag): child c holds rows ``row_offsets[c] ..`` and
    columns ``col_offsets[c] ..``."""

    def __init__(self, mats):
        mats = list(mats)
        if not mats:
            raise ValueError("block_diag needs at least one matrix")
        self._children = mats
        self.dtype, self.torch_dtype, self.device = _common(mats)
        self._row_offsets = np.concatenate(
            [[0], np.cumsum([m.rows() for m in mats])]).astype(np.int64)
        self._col_offsets = np.concatenate(
            [[0], np.cumsum([m.cols() for m in mats])]).astype(np.int64)
        self._rows = int(self._row_offsets[-1])
        self._cols = int(self._col_offsets[-1])

    @property
    def is_streaming(self):
        return _any_streaming(self._children)

    def _rows_of(self, c):
        return slice(int(self._row_offsets[c]), int(self._row_offsets[c + 1]))

    def mul(self, v, w):
        return torch.cat([m.mul(v[self._rows_of(c)], w[self._rows_of(c)])
                          for c, m in enumerate(self._children)])

    def gather(self, indices):
        idx = _index_np(indices)
        out = torch.zeros((self._rows, len(idx)), dtype=self.torch_dtype,
                          device=self.device)
        child_of = np.searchsorted(self._col_offsets, idx, side="right") - 1
        for c in np.unique(child_of):
            pos = np.flatnonzero(child_of == c)
            local = torch.as_tensor(idx[pos] - self._col_offsets[c],
                                    device=self.device)
            out[self._rows_of(c), torch.as_tensor(pos, device=self.device)] \
                = self._children[c].gather(local)
        return out

    def tmul(self, beta):
        beta = self._vec(beta)
        o = self._col_offsets
        return torch.cat([m.tmul(beta[o[c]:o[c + 1]])
                          for c, m in enumerate(self._children)])

    def sq_mul(self, w):
        w = self._vec(w)
        return torch.cat([m.sq_mul(w[self._rows_of(c)])
                          for c, m in enumerate(self._children)])


class MatrixNaiveKroneckerEye(MatrixNaiveBase):
    """``X (x) I_K``, of shape (n K, p K): column ``q K + k`` is column q
    of the child in rows ``i K + k`` (reference
    matrix_naive_kronecker_eye).  The (n K,) operands are (n, K) blocks,
    one column a class, and every product is the child's on them."""

    def __init__(self, mat, K: int):
        if int(K) < 1:
            raise ValueError(f"K must be >= 1, got {K}")
        self._child = mat
        self._K = int(K)
        self.dtype, self.torch_dtype, self.device = _common([mat])
        self._rows = mat.rows() * self._K
        self._cols = mat.cols() * self._K

    @property
    def K(self):
        return self._K

    @property
    def child(self):
        return self._child

    @property
    def is_streaming(self):
        return bool(getattr(self._child, "is_streaming", False))

    @property
    def sweeps(self):
        return getattr(self._child, "sweeps", 0)

    def mul(self, v, w):
        """One child ``mul_many`` over the K classes of ``v * w``: one GEMM
        on a dense child, K launches of its kernel on an SNP matrix in
        device memory, one pass at C = K on a streamed one."""
        n, K = self._child.rows(), self._K
        vw = (self._vec(v) * self._vec(w)).reshape(n, K)
        return self._child.mul_many(vw.T.contiguous()).reshape(-1)

    def mul_many(self, U):
        """One child ``mul_many`` over C K rows: row ``c K + k`` holds class
        k of residual c, so a streamed child serves every class of a chunk
        of lambdas in one pass.  Returns (p K, C)."""
        K, n, p = self._K, self._child.rows(), self._child.cols()
        U = self._vec(U)
        C = U.shape[0]
        V = U.reshape(C, n, K).transpose(1, 2).reshape(C * K, n)
        base = self._child.mul_many(V)                       # (p, C K)
        return base.reshape(p, C, K).transpose(1, 2).reshape(p * K, C)

    def gather(self, indices):
        """The (n K, m) columns ``indices``, K - 1 of every K rows zero."""
        idx = _index_np(indices)
        K = self._K
        base = self._child.gather(
            torch.as_tensor(idx // K, device=self.device))   # (n, m)
        n, m = base.shape
        onehot = torch.zeros((K, m), dtype=self.torch_dtype,
                             device=self.device)
        onehot[torch.as_tensor(idx % K, device=self.device),
               torch.arange(m, device=self.device)] = 1
        return (base[:, None, :] * onehot[None, :, :]).reshape(n * K, m)

    def tmul(self, beta):
        p, K = self._child.cols(), self._K
        return self._child.tmul(self._vec(beta).reshape(p, K)).reshape(-1)

    def sp_tmul(self, betas):
        """``betas @ X^T`` (L, n K) for a scipy.sparse ``betas`` (L, p K):
        one child ``sp_tmul`` of the (L K, p) rows ``B[l, q K + k]`` at
        column q of row ``l K + k``, so the Kronecker's columns are never
        gathered."""
        B = sp.coo_matrix(betas)
        L, K, n = B.shape[0], self._K, self._child.rows()
        rows = B.row * K + B.col % K
        child = sp.csr_matrix((B.data, (rows, B.col // K)),
                              shape=(L * K, self._child.cols()))
        out = self._child.sp_tmul(child)                   # (L K, n)
        return out.reshape(L, K, n).transpose(1, 2).reshape(L, n * K)

    def sq_mul(self, w):
        n, K = self._child.rows(), self._K
        W = self._vec(w).reshape(n, K)
        return torch.stack([self._child.sq_mul(W[:, k].contiguous())
                            for k in range(K)], dim=1).reshape(-1)


class MatrixCovBlockDiag(MatrixCovBase):
    """Block-diagonal covariance matrix of its children (reference
    matrix_cov_block_diag): child c holds the columns ``offsets[c] ..
    offsets[c + 1]``.  A block is assembled on the device from the
    children's blocks; the index bookkeeping stays on the host."""

    def __init__(self, mats):
        mats = list(mats)
        if not mats:
            raise ValueError("block_diag needs at least one matrix")
        self._children = mats
        self.dtype, self.torch_dtype, self.device = _common(mats)
        self._offsets = np.concatenate(
            [[0], np.cumsum([m.cols() for m in mats])]).astype(np.int64)
        self._cols = int(self._offsets[-1])

    def _child_of(self, idx):
        return np.searchsorted(self._offsets, idx, side="right") - 1

    def block(self, rows, cols):
        rows, cols = _index_np(rows), _index_np(cols)
        out = torch.zeros((len(rows), len(cols)), dtype=self.torch_dtype,
                          device=self.device)
        rc, cc = self._child_of(rows), self._child_of(cols)
        for c in np.unique(np.concatenate([rc, cc])):
            rpos = np.flatnonzero(rc == c)
            cpos = np.flatnonzero(cc == c)
            if len(rpos) == 0 or len(cpos) == 0:
                continue
            off = self._offsets[c]
            blk = self._children[c].block(rows[rpos] - off, cols[cpos] - off)
            r = torch.as_tensor(rpos, device=self.device)
            k = torch.as_tensor(cpos, device=self.device)
            out[r[:, None], k[None, :]] = blk
        return out

    def mul(self, indices, values):
        indices = _index_np(indices)
        values = torch.as_tensor(values, dtype=self.torch_dtype,
                                 device=self.device)
        out = torch.zeros(self._cols, dtype=self.torch_dtype,
                          device=self.device)
        cc = self._child_of(indices)
        for c in np.unique(cc):
            pos = np.flatnonzero(cc == c)
            off = self._offsets[c]
            out[off:self._offsets[c + 1]] = self._children[c].mul(
                indices[pos] - off,
                values[torch.as_tensor(pos, device=self.device)])
        return out
