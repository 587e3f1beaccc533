"""Matrix factories mirroring ``adelie_tpu.matrix``: dense, packed SNP in
device memory, packed SNP streamed from host memory, the wrappers the
multi-response problem is built of (``concatenate``, ``kronecker_eye``),
the covariance method's matrices (``dense``, ``eager_cov``, ``lazy_cov``,
``block_diag`` and ``sparse`` with ``method="cov"``) and the constraint
matrices (``dense`` and ``sparse`` with ``method="constraint"``)."""

from ..configs import configs, matmul_precision
from ..device import resolve_device
from ..utils import types
from ._constraint_mat import MatrixConstraintDense, MatrixConstraintSparse
from ._snp import MatrixNaiveSNPPhasedAncestry, MatrixNaiveSNPUnphased
from ._snp_stream import MatrixNaiveSNPUnphasedStreamed
from ._sparse import MatrixCovSparse
from .base import MatrixConstraintBase, MatrixCovBase, MatrixNaiveBase
from .dense import MatrixCovDense, MatrixCovLazy, MatrixNaiveDense, _as_tensor
from .wrappers import (MatrixCovBlockDiag, MatrixNaiveCConcatenate,
                       MatrixNaiveKroneckerEye)

__all__ = ["MatrixConstraintBase", "MatrixConstraintDense",
           "MatrixConstraintSparse", "MatrixCovBase", "MatrixCovBlockDiag",
           "MatrixCovDense", "MatrixCovLazy", "MatrixCovSparse",
           "MatrixNaiveBase", "MatrixNaiveCConcatenate", "MatrixNaiveDense",
           "MatrixNaiveKroneckerEye", "MatrixNaiveSNPPhasedAncestry",
           "MatrixNaiveSNPUnphased", "MatrixNaiveSNPUnphasedStreamed",
           "block_diag", "concatenate", "dense", "eager_cov",
           "kronecker_eye", "lazy_cov", "snp_phased_ancestry",
           "snp_unphased", "sparse"]

_STRUCTURED = "ROADMAP.md: structured matrices and user matrices"


def _naive(mat, device):
    """``mat`` as a matrix on ``device``: an array becomes a dense matrix
    there; a matrix on another device raises."""
    if isinstance(mat, MatrixNaiveBase):
        if device is not None and resolve_device(device) != mat.device:
            raise ValueError(f"a matrix on {mat.device} was given, but "
                             f"device={str(device)!r} was asked")
        return mat
    return dense(mat, device=device)


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
    """Block-diagonal covariance matrix of ``mats`` (reference
    matrix.py:198), ``method="cov"``: each array among them becomes a dense
    covariance matrix on ``device`` (default: the device of the matrices
    among them, else ``"cuda"``).  The naive block-diagonal matrix is not
    ported.  ``n_threads`` is accepted for the JAX package's signature and
    ignored."""
    method = types.matrix_method(method)
    if method == "naive":
        raise NotImplementedError(
            f"block_diag(method='naive') is not ported yet ({_STRUCTURED})")
    if method == "constraint":
        raise ValueError(
            "method 'constraint' is not supported for block_diag")
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
           copy: bool = False, device=None):
    """A sparse covariance matrix (``method="cov"``: its CSC arrays on
    ``device``, default ``"cuda"``) or constraint matrix
    (``"constraint"``), from anything ``scipy.sparse`` takes (reference
    matrix.py:1301).  The naive sparse matrix is not ported.  ``copy`` and
    ``n_threads`` are accepted for the JAX package's signature."""
    method = types.matrix_method(method)
    if method == "naive":
        raise NotImplementedError(
            f"sparse(method='naive') is not ported yet ({_STRUCTURED})")
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
    """Column-wise concatenation (reference matrix.py:292).  Arrays among
    ``mats`` become dense matrices on the device of the matrices among
    them, else on ``device`` (default ``"cuda"``); matrices on different
    devices raise.  Only ``axis=1`` is ported."""
    if axis != 1:
        raise NotImplementedError(
            f"concatenate(axis={axis}) is not ported yet ({_STRUCTURED})")
    if device is None:
        device = next((m.device for m in mats
                       if isinstance(m, MatrixNaiveBase)), None)
    return MatrixNaiveCConcatenate([_naive(m, device) for m in mats])


def kronecker_eye(mat, K: int, *, copy: bool = False, n_threads: int = 1,
                  device=None):
    """``X (x) I_K`` (reference matrix.py:917): an array becomes a dense
    matrix on ``device`` (default ``"cuda"``).  ``copy`` and ``n_threads``
    are accepted for the JAX package's signature and ignored."""
    return MatrixNaiveKroneckerEye(_naive(mat, device), K)
