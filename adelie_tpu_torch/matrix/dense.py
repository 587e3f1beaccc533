"""Dense matrix on a device.

Counterpart of ``MatrixNaiveDense`` in ``adelie_tpu/matrix/dense.py``: the
whole matrix is one tensor on ``device`` and every product is one
``torch.matmul`` (cuBLAS on the card), as the JAX package left them to XLA.
The float32 products follow ``configs.matmul_precision``.
"""

import numpy as np
import torch

from ..configs import matmul_precision
from ..device import resolve_device
from ..utils import TORCH_DTYPE
from .base import MatrixNaiveBase


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
