"""Matrix factories mirroring ``adelie_tpu.matrix``: dense, packed SNP in
device memory, and packed SNP streamed from host memory."""

from ..configs import configs
from ._snp import MatrixNaiveSNPPhasedAncestry, MatrixNaiveSNPUnphased
from ._snp_stream import MatrixNaiveSNPUnphasedStreamed
from .base import MatrixNaiveBase
from .dense import MatrixNaiveDense

__all__ = ["MatrixNaiveBase", "MatrixNaiveDense",
           "MatrixNaiveSNPPhasedAncestry", "MatrixNaiveSNPUnphased",
           "MatrixNaiveSNPUnphasedStreamed", "dense",
           "snp_phased_ancestry", "snp_unphased"]


def dense(mat, *, method: str = "naive", n_threads: int = 1, dtype=None,
          copy: bool = False, device=None):
    """Dense matrix on ``device`` (default ``"cuda"``, which raises without
    a GPU: pass ``device="cpu"`` for the CPU).  Only ``method="naive"`` is
    ported.  ``copy=False`` lets a CPU matrix share the memory of a numpy
    array of its dtype, as the reference's matrices view theirs;
    ``copy=True`` always copies.  ``n_threads`` is accepted for the JAX
    package's signature and ignored."""
    if method != "naive":
        raise NotImplementedError(
            f"dense(method={method!r}) is not ported yet (ROADMAP.md queue 1)"
        )
    return MatrixNaiveDense(mat, dtype=dtype, device=device, copy=copy)


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
