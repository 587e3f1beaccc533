"""Matrix factories mirroring ``adelie_tpu.matrix``: dense, sparse,
packed SNP in device memory, packed SNP streamed from host memory, the
wrappers (``standardize``, ``subset``, ``concatenate``, ``block_diag``,
``kronecker_eye``), the implicit expansions (``one_hot``,
``interaction``, ``convex_relu``, ``convex_gated_relu``), the covariance
method's matrices (``dense``, ``eager_cov``, ``lazy_cov``, ``block_diag``
and ``sparse`` with ``method="cov"``) and the constraint matrices
(``dense`` and ``sparse`` with ``method="constraint"``).

A user's matrix subclasses ``MatrixNaiveBase`` (also named
``PyMatrixNaiveBase``, as in the reference) and implements ``mul``,
``gather`` and ``tmul`` on tensors; ``grpnet`` and every wrapper take it
as they take the package's own."""

import torch

from ..configs import configs, matmul_precision
from ..device import resolve_device
from ..utils import types
from ._constraint_mat import MatrixConstraintDense, MatrixConstraintSparse
from ._convex_relu import MatrixNaiveConvexGatedRelu, MatrixNaiveConvexRelu
from ._interaction import MatrixNaiveInteractionDense
from ._one_hot import MatrixNaiveOneHotDense
from ._snp import MatrixNaiveSNPPhasedAncestry, MatrixNaiveSNPUnphased
from ._snp_stream import MatrixNaiveSNPUnphasedStreamed
from ._sparse import MatrixCovSparse, MatrixNaiveSparse
from .base import (MatrixConstraintBase, MatrixCovBase, MatrixNaiveBase,
                   MatrixNaiveTranspose)
from .dense import MatrixCovDense, MatrixCovLazy, MatrixNaiveDense, _as_tensor
from .wrappers import (MatrixCovBlockDiag, MatrixNaiveBlockDiag,
                       MatrixNaiveCConcatenate, MatrixNaiveCSubset,
                       MatrixNaiveKroneckerEye, MatrixNaiveRConcatenate,
                       MatrixNaiveRSubset, MatrixNaiveStandardize)

# the reference's names of its user-extensible bases (reference
# matrix.py:40, 79, 199, 260): here the protocol bases themselves
PyMatrixNaiveBase = MatrixNaiveBase
PyMatrixCovBase = MatrixCovBase
PyMatrixConstraintBase = MatrixConstraintBase
PyMatrixNaiveTranspose = MatrixNaiveTranspose

__all__ = ["MatrixConstraintBase", "MatrixConstraintDense",
           "MatrixConstraintSparse", "MatrixCovBase", "MatrixCovBlockDiag",
           "MatrixCovDense", "MatrixCovLazy", "MatrixCovSparse",
           "MatrixNaiveBase", "MatrixNaiveBlockDiag",
           "MatrixNaiveCConcatenate", "MatrixNaiveCSubset",
           "MatrixNaiveConvexGatedRelu", "MatrixNaiveConvexRelu",
           "MatrixNaiveDense", "MatrixNaiveInteractionDense",
           "MatrixNaiveKroneckerEye", "MatrixNaiveOneHotDense",
           "MatrixNaiveRConcatenate", "MatrixNaiveRSubset",
           "MatrixNaiveSNPPhasedAncestry", "MatrixNaiveSNPUnphased",
           "MatrixNaiveSNPUnphasedStreamed", "MatrixNaiveSparse",
           "MatrixNaiveStandardize", "MatrixNaiveTranspose",
           "PyMatrixConstraintBase", "PyMatrixCovBase", "PyMatrixNaiveBase",
           "PyMatrixNaiveTranspose", "block_diag", "concatenate",
           "convex_gated_relu", "convex_relu", "dense", "eager_cov",
           "interaction", "kronecker_eye", "lazy_cov", "one_hot",
           "snp_phased_ancestry", "snp_unphased", "sparse", "standardize",
           "subset"]


def _naive(mat, device):
    """``mat`` as a matrix on ``device``: an array becomes a dense matrix
    there; a matrix on another device raises."""
    if isinstance(mat, MatrixNaiveBase):
        if device is not None and resolve_device(device) != mat.device:
            raise ValueError(f"a matrix on {mat.device} was given, but "
                             f"device={str(device)!r} was asked")
        return mat
    return dense(mat, device=device)


def _device_of(mats, device):
    """``device``, else the device of the first matrix among ``mats``."""
    if device is None:
        device = next((m.device for m in mats
                       if isinstance(m, MatrixNaiveBase)), None)
    return device


def dense(mat, *, method: str = "naive", n_threads: int = 1, dtype=None,
          copy: bool = False, device=None):
    """Dense matrix on ``device`` (default ``"cuda"``, which raises without
    a GPU: pass ``device="cpu"`` for the CPU): an (n, p) matrix
    (``method="naive"``), a (p, p) covariance matrix (``"cov"``; a tensor
    ``mat`` stays on its device unless ``device`` is given) or an (m, d)
    constraint matrix (``"constraint"``).  ``copy=False`` lets a CPU matrix
    share the memory of a numpy array of its dtype, as the reference's
    matrices view theirs; ``copy=True`` always copies.  ``n_threads`` is
    accepted for the JAX package's signature and ignored."""
    method = types.matrix_method(method)
    if method == "cov":
        return MatrixCovDense(mat, dtype=dtype, device=device, copy=copy)
    if method == "constraint":
        return MatrixConstraintDense(mat, dtype=dtype, device=device,
                                     copy=copy)
    return MatrixNaiveDense(mat, dtype=dtype, device=device, copy=copy)


def block_diag(mats, *, method: str = "naive", n_threads: int = 1,
               device=None):
    """Block-diagonal matrix of ``mats`` (reference matrix.py:198): naive
    (``method="naive"``: (n, p) matrices, each array among them a dense
    matrix) or covariance (``"cov"``: each array a dense covariance
    matrix), on ``device`` (default: the device of the matrices among
    them, else ``"cuda"``).  ``n_threads`` is accepted for the JAX
    package's signature and ignored."""
    method = types.matrix_method(method)
    if method == "constraint":
        raise ValueError(
            "method 'constraint' is not supported for block_diag")
    if method == "naive":
        device = _device_of(mats, device)
        return MatrixNaiveBlockDiag([_naive(m, device) for m in mats])
    if device is None:
        device = next((m.device for m in mats
                       if isinstance(m, MatrixCovBase)), None)
    return MatrixCovBlockDiag([
        m if isinstance(m, MatrixCovBase)
        else dense(m, method="cov", device=device) for m in mats])


def eager_cov(mat, *, n_threads: int = 1, device=None):
    """The Gram matrix ``A = X^T X`` of an (n, p) array or tensor, formed
    on ``device`` (default ``"cuda"``; a tensor's own device when it is
    None) as one product (reference matrix.py:683).  ``n_threads`` is
    accepted for the JAX package's signature and ignored."""
    X, _ = _as_tensor(mat, None, device)
    with matmul_precision():
        A = X.T @ X
    return MatrixCovDense(A)


def lazy_cov(mat, *, copy: bool = False, n_threads: int = 1, dtype=None,
             device=None):
    """The Gram matrix ``X^T X`` of an (n, p) array or tensor, its columns
    formed as the solver asks for them (reference matrix.py:1000).  ``copy``
    and ``n_threads`` are accepted for the JAX package's signature."""
    return MatrixCovLazy(mat, dtype=dtype, device=device, copy=copy)


def sparse(mat, *, method: str = "naive", n_threads: int = 1, dtype=None,
           copy: bool = False, layout: str = "auto", device=None):
    """A sparse (n, p) matrix (``method="naive"``, in the ``layout`` of
    ``MatrixNaiveSparse``), covariance matrix (``"cov"``) or constraint
    matrix (``"constraint"``) on ``device`` (default ``"cuda"``), from
    anything ``scipy.sparse`` takes (reference matrix.py:1301).  ``copy``
    and ``n_threads`` are accepted for the JAX package's signature."""
    method = types.matrix_method(method)
    if method == "naive":
        return MatrixNaiveSparse(mat, dtype=dtype, layout=layout,
                                 device=device)
    if method == "cov":
        return MatrixCovSparse(mat, dtype=dtype, device=device)
    return MatrixConstraintSparse(mat, dtype=dtype, device=device)


def snp_unphased(io, *, n_threads: int = 1, dtype=None, device=None,
                 streaming="auto", tile_snps: int = 65536):
    """Packed SNP unphased matrix on ``device`` (reference matrix.py:1245).

    ``io``: an ``io.snp_unphased`` or ``io.snp_bed`` handler, or anything
    with ``packed`` (p, ceil(n/4)) uint8, ``impute`` (p,), ``rows()`` and
    ``snps()``.  ``streaming=False`` puts the packed bytes on the device
    (``dtype`` defaults to float64).  ``streaming=True``, or ``"auto"`` with
    more packed bytes than ``configs.snp_hbm_budget``, keeps them in host
    memory and streams tiles of ``tile_snps`` SNP rows through the device
    for every full-matrix product (``dtype`` defaults to float32, as in the
    JAX package).  ``n_threads`` is accepted for the JAX package's
    signature and ignored."""
    if streaming == "auto":
        if hasattr(io, "_ensure"):
            io._ensure()
        packed_bytes = int(io.snps()) * ((int(io.rows()) + 3) // 4)
        streaming = packed_bytes > configs.snp_hbm_budget
    if streaming:
        return MatrixNaiveSNPUnphasedStreamed(io, dtype=dtype, device=device,
                                              tile_snps=tile_snps)
    return MatrixNaiveSNPUnphased(io, dtype=dtype, device=device)


def snp_phased_ancestry(io, *, n_threads: int = 1, dtype=None, device=None):
    """Phased calldata x local-ancestry matrix on ``device`` (reference
    matrix.py:1189); ``io`` has ``packed``, ``rows()`` and ``cols()``.
    ``n_threads`` is accepted for the JAX package's signature and
    ignored."""
    return MatrixNaiveSNPPhasedAncestry(io, dtype=dtype, device=device)


def concatenate(mats, *, axis: int = 1, n_threads: int = 1, device=None):
    """Column-wise (``axis=1``) or row-wise (``axis=0``) concatenation
    (reference matrix.py:292).  Arrays among ``mats`` become dense
    matrices on the device of the matrices among them, else on ``device``
    (default ``"cuda"``); matrices on different devices raise."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    device = _device_of(mats, device)
    mats = [_naive(m, device) for m in mats]
    return (MatrixNaiveCConcatenate if axis == 1
            else MatrixNaiveRConcatenate)(mats)


def kronecker_eye(mat, K: int, *, copy: bool = False, n_threads: int = 1,
                  device=None):
    """``X (x) I_K`` (reference matrix.py:917): an array becomes a dense
    matrix on ``device`` (default ``"cuda"``).  ``copy`` and ``n_threads``
    are accepted for the JAX package's signature and ignored."""
    return MatrixNaiveKroneckerEye(_naive(mat, device), K)


def standardize(mat, centers=None, scales=None, ddof: int = 0, *,
                n_threads: int = 1, device=None):
    """``(X - 1 c^T) / s``, never formed (reference matrix.py:1414).  The
    centers default to the column means and the scales to the column
    standard deviations about them with the divisor ``n - ddof``, both
    from ``X.mean`` and ``X.var`` with weights 1/n on ``X``'s device.  An
    array ``mat`` becomes a dense matrix on ``device`` (default
    ``"cuda"``).  ``n_threads`` is accepted for the JAX package's
    signature and ignored."""
    mat = _naive(mat, device)
    n = mat.rows()
    w = torch.full((n,), 1.0 / n, dtype=mat.torch_dtype, device=mat.device)
    centers = mat.mean(w) if centers is None else mat._vec(centers)
    if scales is None:
        scales = torch.sqrt(n / (n - ddof) * mat.var(centers, w))
    return MatrixNaiveStandardize(mat, centers, scales)


def subset(mat, indices, *, axis: int = 1, n_threads: int = 1,
           device=None):
    """The columns (``axis=1``) or rows (``axis=0``) ``indices`` of
    ``mat``, never copied; an index may repeat (reference
    matrix.py:1539).  An array ``mat`` becomes a dense matrix on
    ``device`` (default ``"cuda"``)."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    mat = _naive(mat, device)
    return (MatrixNaiveCSubset if axis == 1
            else MatrixNaiveRSubset)(mat, indices)


def one_hot(mat, levels=None, *, copy: bool = False, n_threads: int = 1,
            device=None):
    """The one-hot expansion of the discrete columns of ``mat`` (column g
    discrete with ``levels[g] > 0`` levels, its values 0 ..
    ``levels[g] - 1``), never formed (reference matrix.py:1073), on
    ``device`` (default ``"cuda"``).  ``copy`` and ``n_threads`` are
    accepted for the JAX package's signature."""
    return MatrixNaiveOneHotDense(mat, levels, device=device)


def interaction(mat, intr_map, levels=None, *, copy: bool = False,
                n_threads: int = 1, device=None):
    """The pairwise interactions of the columns of ``mat`` that
    ``intr_map`` lists (key: a column; value: the columns it meets, None
    for all), never formed (reference matrix.py:721), on ``device``
    (default ``"cuda"``).  ``levels`` as in :func:`one_hot`.  ``copy`` and
    ``n_threads`` are accepted for the JAX package's signature."""
    return MatrixNaiveInteractionDense(mat, intr_map, levels, device=device)


def convex_relu(mat, mask, *, gated: bool = False, n_threads: int = 1,
                device=None):
    """``[D_1 Z, ..., D_m Z]`` (``gated=True``) or ``[Y, -Y]`` of it, with
    ``D_k = diag(mask[:, k])``, for a dense or scipy.sparse ``Z``, never
    formed (reference matrix.py:390), on ``device`` (default ``"cuda"``).
    ``n_threads`` is accepted for the JAX package's signature."""
    cls = MatrixNaiveConvexGatedRelu if gated else MatrixNaiveConvexRelu
    return cls(mat, mask, device=device)


def convex_gated_relu(mat, mask, *, n_threads: int = 1, device=None):
    """:func:`convex_relu` with ``gated=True``."""
    return convex_relu(mat, mask, gated=True, device=device)
