"""Dense matrices on a device.

Counterpart of ``adelie_tpu/matrix/dense.py``:

* ``MatrixNaiveDense``: the whole (n, p) matrix is one tensor on
  ``device`` and every product is one ``torch.matmul`` (cuBLAS on the
  card), as the JAX package left them to XLA;
* ``MatrixCovDense``: a (p, p) covariance matrix held whole;
* ``MatrixCovLazy``: the covariance ``X^T W X`` of an (n, p) tensor, its
  columns formed as the solver asks for them and kept on the device.

The float32 products follow ``configs.matmul_precision``.
"""

import numpy as np
import torch

from ..configs import matmul_precision
from ..device import resolve_device
from ..utils import TORCH_DTYPE
from .base import MatrixCovBase, MatrixNaiveBase, _index


def _as_tensor(mat, dtype, device, copy=False, default=np.float32):
    """``(tensor, numpy dtype)``: an array or a tensor as a float tensor on
    ``device`` (default ``"cuda"``); ``dtype`` defaults to the input's if
    it is float32 or float64, else ``default``.  A tensor keeps its device
    when ``device`` is None."""
    if isinstance(mat, torch.Tensor):
        src = np.dtype(str(mat.dtype).replace("torch.", ""))
        dev = mat.device if device is None else resolve_device(device)
    else:
        mat = np.asarray(mat)
        src = mat.dtype
        dev = resolve_device(device)
    if dtype is None:
        dtype = src if src in TORCH_DTYPE else default
    dtype = np.dtype(dtype)
    if dtype not in TORCH_DTYPE:
        raise TypeError(f"dense matrices are float32 or float64, not {dtype}")
    tdt = TORCH_DTYPE[dtype]
    if isinstance(mat, torch.Tensor):
        out = mat.to(device=dev, dtype=tdt, copy=copy)
    else:
        make = torch.tensor if copy else torch.as_tensor
        out = make(mat, dtype=tdt, device=dev)
    return out, dtype


class MatrixNaiveDense(MatrixNaiveBase):
    def __init__(self, mat, *, dtype=None, device=None, copy=False):
        mat = np.asarray(mat)
        if dtype is None:
            dtype = mat.dtype if mat.dtype in TORCH_DTYPE else np.float32
        self.dtype = np.dtype(dtype)
        if self.dtype not in TORCH_DTYPE:
            raise TypeError(f"dense matrices are float32 or float64, not "
                            f"{self.dtype}")
        self.torch_dtype = TORCH_DTYPE[self.dtype]
        self.device = resolve_device(device)
        self._rows, self._cols = mat.shape
        make = torch.tensor if copy else torch.as_tensor
        self._mat = make(mat, dtype=self.torch_dtype, device=self.device)

    @property
    def mat(self):
        return self._mat

    def mul(self, v, w):
        with matmul_precision():
            return (v * w) @ self._mat

    def mul_many(self, U):
        with matmul_precision():
            return (U @ self._mat).T

    def gather(self, indices):
        idx = torch.as_tensor(indices, device=self.device).long()
        return self._mat.index_select(1, idx)

    def tmul(self, beta):
        beta = torch.as_tensor(beta, dtype=self.torch_dtype,
                               device=self.device)
        with matmul_precision():
            return self._mat @ beta

    def sq_mul(self, w):
        with matmul_precision():
            return w @ (self._mat * self._mat)


class MatrixCovDense(MatrixCovBase):
    """A (p, p) covariance matrix held whole on ``device`` (reference
    matrix_cov_dense): ``mat`` an array or a tensor (a tensor stays on its
    device unless ``device`` is given)."""

    def __init__(self, mat, *, dtype=None, device=None, copy=False):
        self._mat, self.dtype = _as_tensor(mat, dtype, device, copy)
        if self._mat.dim() != 2 or self._mat.shape[0] != self._mat.shape[1]:
            raise ValueError(f"a covariance matrix is square, got "
                             f"{tuple(self._mat.shape)}")
        self.torch_dtype = self._mat.dtype
        self.device = self._mat.device
        self._cols = self._mat.shape[0]

    @property
    def mat(self):
        return self._mat

    def block(self, rows, cols):
        r, c = _index(rows, self.device), _index(cols, self.device)
        return self._mat.index_select(0, r).index_select(1, c)

    def cols_block(self, cols):
        """``A[:, cols]`` -> (p, len(cols))."""
        return self._mat.index_select(1, _index(cols, self.device))

    def mul(self, indices, values):
        vals = torch.as_tensor(values, dtype=self.torch_dtype,
                               device=self.device)
        with matmul_precision():
            return self.cols_block(indices) @ vals


class MatrixCovLazy(MatrixCovBase):
    """The covariance ``A = X^T W X`` of an (n, p) ``X`` (``W`` the
    diagonal of ``weights``, default ones), formed a batch of columns at a
    time (reference matrix_cov_lazy_cov.hpp:31-33).

    The formed columns stay on the device: a (p, cap) buffer, its capacity
    doubled as it fills, and a host index map from a column to its place
    in the buffer.  Each batch of new columns is one GEMM
    ``X^T (W X[:, new])``; ``block`` and ``mul`` read the buffer.
    ``n_formed`` counts the columns formed."""

    def __init__(self, X, weights=None, *, dtype=None, device=None,
                 copy=False):
        self._X, self.dtype = _as_tensor(X, dtype, device, copy)
        self.torch_dtype = self._X.dtype
        self.device = self._X.device
        self._n, self._cols = self._X.shape
        w = (torch.ones(self._n, dtype=self.torch_dtype, device=self.device)
             if weights is None else
             torch.as_tensor(weights, dtype=self.torch_dtype,
                             device=self.device))
        self._w = w
        self._slot = np.full(self._cols, -1, np.int64)
        self._buf = torch.zeros((self._cols, 0), dtype=self.torch_dtype,
                                device=self.device)
        self.n_formed = 0

    def _slots(self, cols):
        """The buffer slots of ``cols``, forming the missing columns (in
        order of first appearance) with one GEMM."""
        cols = np.asarray(cols.cpu() if isinstance(cols, torch.Tensor)
                          else cols, np.int64).ravel()
        missing = cols[self._slot[cols] < 0]
        new = missing[np.sort(np.unique(missing, return_index=True)[1])]
        if len(new):
            need = self.n_formed + len(new)
            cap = self._buf.shape[1]
            if need > cap:
                cap = min(max(need, 2 * cap, 16), self._cols)
                grown = torch.zeros((self._cols, cap), dtype=self.torch_dtype,
                                    device=self.device)
                grown[:, :self.n_formed] = self._buf[:, :self.n_formed]
                self._buf = grown
            idx = torch.as_tensor(new, device=self.device)
            with matmul_precision():
                blk = self._X.index_select(1, idx) * self._w[:, None]
                self._buf[:, self.n_formed:need] = self._X.T @ blk
            self._slot[new] = np.arange(self.n_formed, need)
            self.n_formed = need
        return torch.as_tensor(self._slot[cols], device=self.device)

    def block(self, rows, cols):
        s = self._slots(cols)
        return self._buf.index_select(0, _index(rows, self.device)) \
            .index_select(1, s)

    def mul(self, indices, values):
        s = self._slots(indices)
        vals = torch.as_tensor(values, dtype=self.torch_dtype,
                               device=self.device)
        with matmul_precision():
            return self._buf.index_select(1, s) @ vals
