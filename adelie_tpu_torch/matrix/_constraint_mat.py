"""Constraint matrices (reference matrix_constraint_{dense,sparse};
factories ``matrix.dense``/``matrix.sparse`` with ``method="constraint"``).

Counterpart of ``adelie_tpu/matrix/_constraint_mat.py``.  Both carry the
``A`` (m, d) of linear constraints and of the pinball solver as one dense
tensor on the device, the products of ``MatrixConstraintBase`` going
through it; the sparse one keeps its scipy CSR on the host as well
(constraint matrices are small: m x a group's size).
"""

import numpy as np
import scipy.sparse as sp

from .base import MatrixConstraintBase
from .dense import _as_tensor


class MatrixConstraintDense(MatrixConstraintBase):
    def __init__(self, mat, *, dtype=None, device=None, copy=False):
        self._mat, self.dtype = _as_tensor(mat, dtype, device, copy,
                                           default=np.float64)
        self.torch_dtype = self._mat.dtype
        self.device = self._mat.device
        self._rows, self._cols = self._mat.shape

    def dense(self):
        return self._mat


class MatrixConstraintSparse(MatrixConstraintBase):
    def __init__(self, mat, *, dtype=None, device=None):
        mat = sp.csr_matrix(mat)
        self._mat, self.dtype = _as_tensor(mat.toarray(), dtype, device,
                                           default=np.float64)
        self._csr = mat.astype(self.dtype)
        self.torch_dtype = self._mat.dtype
        self.device = self._mat.device
        self._rows, self._cols = mat.shape

    def dense(self):
        return self._mat
