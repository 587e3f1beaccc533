"""Packed SNP matrices on a device.

Counterpart of ``adelie_tpu/matrix/_snp.py``.  The genotype matrix stays
2-bit packed on ``device``: (p, ceil(n/4)) uint8, four samples a byte, row
j holding column j.  The full gradient ``mul`` is one kernel launch (K3 for
unphased matrices, K4 for phased ancestry, ``snp_kernels.py``) that decodes
the bytes on the fly; ``gather``, ``tmul`` and ``sq_mul`` decode blocks of
at most ``_CHUNK`` columns with plain tensor code, as the JAX package
leaves them to XLA.  An unphased NA (code 3) reads the column's impute
value.  Not ported: ``mesh`` sharding (ROADMAP.md queue 11) and
``mul_spec``, which exists to keep XLA programs data-independent.
"""

import numpy as np
import torch

from ..configs import matmul_precision
from ..device import resolve_device
from ..utils import TORCH_DTYPE
from . import snp_kernels
from .base import MatrixNaiveBase
from .snp_kernels import unpack_cols as _unpack_cols

__all__ = ["MatrixNaiveSNPPhasedAncestry", "MatrixNaiveSNPUnphased",
           "unpack_2bit_np"]


def unpack_2bit_np(packed, n):
    """(cols, nb) uint8 -> (cols, n) uint8 array of 2-bit codes."""
    cols, nb = packed.shape
    out = np.zeros((cols, nb * 4), np.uint8)
    for k in range(4):
        out[:, k::4] = (packed >> (2 * k)) & 3
    return out[:, :n]


class MatrixNaiveSNPUnphased(MatrixNaiveBase):
    """SNP unphased matrix over an IO handler: anything with ``packed``,
    ``impute``, ``rows()`` and ``snps()`` (reference matrix.py:1245)."""

    _CHUNK = 2048

    def __init__(self, io, *, dtype=None, device=None):
        if hasattr(io, "_ensure"):
            io._ensure()
        self._init(io, io.snps(), dtype, device)
        self._impute = torch.as_tensor(
            np.asarray(io.impute, self.dtype), device=self.device)

    def _init(self, io, cols, dtype, device):
        self.dtype = np.dtype(dtype or np.float64)
        if self.dtype not in TORCH_DTYPE:
            raise TypeError(f"SNP matrices are float32 or float64, not "
                            f"{self.dtype}")
        self.torch_dtype = TORCH_DTYPE[self.dtype]
        self.device = resolve_device(device)
        self._rows = int(io.rows())
        self._cols = int(cols)
        packed = np.ascontiguousarray(np.asarray(io.packed), np.uint8)
        nb = (self._rows + 3) // 4
        if packed.shape != (self._cols, nb):
            raise ValueError(f"packed must be ({self._cols}, {nb}) for "
                             f"{self._rows} rows, got {packed.shape}")
        self._packed = torch.from_numpy(packed).to(self.device)

    def _decode(self, idx):
        """(n, k) dense block for the column indices ``idx`` (a tensor)."""
        codes = _unpack_cols(self._packed.index_select(0, idx), self._rows,
                             self.torch_dtype)
        imp = self._impute.index_select(0, idx)
        return torch.where(codes == 3, imp[None, :], codes)

    def _u(self, v, w):
        return (v * w).to(self.torch_dtype).contiguous()

    def gather(self, indices):
        idx = torch.as_tensor(indices, device=self.device).long()
        return self._decode(idx)

    def mul(self, v, w):
        return snp_kernels.snp_mul(self._packed, self._u(v, w), self._impute)

    def _chunks(self):
        for s in range(0, self._cols, self._CHUNK):
            e = min(s + self._CHUNK, self._cols)
            yield s, e, self._decode(torch.arange(s, e, device=self.device))

    def tmul(self, beta):
        beta = torch.as_tensor(beta, dtype=self.torch_dtype,
                               device=self.device)
        out = None
        with matmul_precision():
            for s, e, blk in self._chunks():
                term = blk @ beta[s:e]
                out = term if out is None else out + term
        return out

    def sq_mul(self, w):
        w = torch.as_tensor(w, dtype=self.torch_dtype, device=self.device)
        with matmul_precision():
            return torch.cat([w @ (blk * blk) for _, _, blk in self._chunks()])


class MatrixNaiveSNPPhasedAncestry(MatrixNaiveSNPUnphased):
    """Phased calldata x local ancestry matrix over an IO handler with
    ``packed``, ``rows()`` and ``cols()`` (reference matrix.py:1189).

    Columns are (snp, ancestry) pairs with values 0..2: no NA, so the
    decode has no impute select and ``mul`` runs K4.
    """

    def __init__(self, io, *, dtype=None, device=None):
        if hasattr(io, "_ensure"):
            io._ensure()
        self._init(io, io.cols(), dtype, device)

    def _decode(self, idx):
        return _unpack_cols(self._packed.index_select(0, idx), self._rows,
                            self.torch_dtype)

    def mul(self, v, w):
        return snp_kernels.snp_mul_no_na(self._packed, self._u(v, w))
