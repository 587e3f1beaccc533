"""Pairwise-interaction expansion, never formed (reference
matrix_naive_interaction; factory ``matrix.interaction``).

Counterpart of ``adelie_tpu/matrix/_interaction.py``.  Every expanded
column is the product of two terms, each one of {1, Z_f, 1{Z_f == level}}:
the host lays out a (feature, kind, level) descriptor a term and column
once, and the descriptors live on the device.  ``gather`` builds any set
of columns in one vectorized expression; ``mul``, ``tmul`` and ``sq_mul``
go through the expansion ``_CHUNK`` (4,096) columns at a time, so the
whole (n, p) matrix is never formed.
"""

import numpy as np
import torch

from ..configs import matmul_precision
from ..device import resolve_device
from ..utils import TORCH_DTYPE
from ._one_hot import _float_dtype, _levels_of
from .base import MatrixNaiveBase

_KIND_ONE = 0
_KIND_ID = 1
_KIND_IND = 2


def build_pairs(d, intr_map):
    """The unique valid pairs of ``intr_map`` (reference
    matrix.py:877-907): key k with each of its values (all ``d`` features
    for ``None``), a pair seen in either order once, no pair (k, k)."""
    if len(intr_map) <= 0:
        raise ValueError("intr_map must be non-empty.")
    pairs, seen = [], set()
    for key in np.sort(list(intr_map.keys())):
        values = intr_map[key]
        values = (np.arange(d) if values is None
                  else np.sort(np.unique(values)))
        for val in values:
            key_i, val_i = int(key), int(val)
            if ((key_i, val_i) in seen or (val_i, key_i) in seen
                    or key_i == val_i):
                continue
            pairs.append((key_i, val_i))
            seen.add((key_i, val_i))
    if len(pairs) <= 0:
        raise ValueError("No valid pairs exist.")
    return np.asarray(pairs, int)


def _pair_terms(i, j, Li, Lj):
    """The columns of the pair (i, j): a list of the two terms'
    (feature, kind, level) each."""
    one = lambda f: (f, _KIND_ONE, 0)            # noqa: E731
    ident = lambda f: (f, _KIND_ID, 0)           # noqa: E731
    ind = lambda f, k: (f, _KIND_IND, k)         # noqa: E731
    if Li <= 0 and Lj <= 0:                      # [Z_i, Z_j, Z_i Z_j]
        return [(ident(i), one(j)), (ident(j), one(j)),
                (ident(i), ident(j))]
    if Li <= 0 < Lj:                             # [1, Z_i] * I_{Z_j}
        return [(t(i), ind(j, k)) for k in range(Lj) for t in (one, ident)]
    if Lj <= 0 < Li:                             # I_{Z_i} * [1, Z_j]
        return [(ind(i, k), t(j)) for t in (one, ident) for k in range(Li)]
    return [(ind(i, ki), ind(j, kj))             # I_{Z_i} * I_{Z_j}
            for kj in range(Lj) for ki in range(Li)]


class MatrixNaiveInteractionDense(MatrixNaiveBase):
    def __init__(self, mat, intr_map, levels=None, *, dtype=None,
                 device=None):
        mat = np.asarray(mat)
        self.dtype = _float_dtype(mat, dtype)
        self.torch_dtype = TORCH_DTYPE[self.dtype]
        self.device = dev = resolve_device(device)
        n, d = mat.shape
        levels = _levels_of(mat, levels)
        pairs = build_pairs(d, intr_map)
        cols, starts = [], []
        for i, j in pairs:
            starts.append(len(cols))
            cols += _pair_terms(i, j, levels[i], levels[j])
        desc = np.asarray(cols, np.int64)         # (p, 2 terms, 3)

        self._rows, self._cols = n, len(cols)
        self.pairs = pairs
        self.levels = levels
        self.group_starts = np.asarray(starts, int)
        self._Z = self._vec(mat)
        self._feat = [torch.as_tensor(desc[:, t, 0], device=dev)
                      for t in range(2)]
        self._kind = [torch.as_tensor(desc[:, t, 1], device=dev)
                      for t in range(2)]
        self._level = [self._vec(desc[:, t, 2]) for t in range(2)]

    @property
    def groups(self):
        """The first column of each pair's group."""
        return self.group_starts

    def _term(self, t, idx):
        Zc = self._Z.index_select(1, self._feat[t][idx])
        kind = self._kind[t][idx]
        ind = (Zc == self._level[t][idx]).to(self.torch_dtype)
        return torch.where(kind == _KIND_ID, Zc, ind).masked_fill_(
            kind == _KIND_ONE, 1)

    def gather(self, indices):
        idx = torch.as_tensor(indices, device=self.device).long()
        return self._term(0, idx) * self._term(1, idx)

    def mul(self, v, w):
        u = v * w
        with matmul_precision():
            return torch.cat([u @ blk for _, blk in self._chunked_cols()])

    def tmul(self, beta):
        beta = self._vec(beta)
        out = None
        with matmul_precision():
            for s, blk in self._chunked_cols():
                term = blk @ beta[s:s + blk.shape[1]]
                out = term if out is None else out + term
        return out

    def mean(self, w):
        raise NotImplementedError(
            "interaction: mean() is not defined; give standardize its "
            "centers (reference matrix_naive_interaction.ipp:813).")

    def var(self, centers, w):
        raise NotImplementedError(
            "interaction: var() is not defined; give standardize its "
            "scales (reference matrix_naive_interaction.ipp:827).")
