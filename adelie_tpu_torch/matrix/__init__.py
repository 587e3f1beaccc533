"""Matrix factories mirroring ``adelie_tpu.matrix``: dense and packed SNP."""

from ..configs import configs
from ._snp import MatrixNaiveSNPPhasedAncestry, MatrixNaiveSNPUnphased
from .base import MatrixNaiveBase
from .dense import MatrixNaiveDense

__all__ = ["MatrixNaiveBase", "MatrixNaiveDense",
           "MatrixNaiveSNPPhasedAncestry", "MatrixNaiveSNPUnphased", "dense",
           "snp_phased_ancestry", "snp_unphased"]


def dense(mat, *, method: str = "naive", dtype=None, device=None):
    """Dense matrix on ``device`` (default: ``"cuda"`` when a GPU is
    available, else ``"cpu"``).  Only ``method="naive"`` is ported."""
    if method != "naive":
        raise NotImplementedError(
            f"dense(method={method!r}) is not ported yet (ROADMAP.md queue 1)"
        )
    return MatrixNaiveDense(mat, dtype=dtype, device=device)


def snp_unphased(io, *, dtype=None, device=None, streaming="auto"):
    """Packed SNP unphased matrix on ``device`` (reference matrix.py:1245).

    ``io``: an ``io.snp_unphased`` or ``io.snp_bed`` handler, or anything
    with ``packed`` (p, ceil(n/4)) uint8, ``impute`` (p,), ``rows()`` and
    ``snps()``.  ``dtype`` defaults to float64.  The packed bytes live on
    the device; ``streaming=True``, or ``"auto"`` with more packed bytes
    than ``configs.snp_hbm_budget``, asks for the host-streamed matrix,
    which is not ported yet (ROADMAP.md queue 8) and raises."""
    if streaming == "auto":
        if hasattr(io, "_ensure"):
            io._ensure()
        packed_bytes = int(io.snps()) * ((int(io.rows()) + 3) // 4)
        streaming = packed_bytes > configs.snp_hbm_budget
    if streaming:
        raise NotImplementedError(
            "the host-streamed SNP matrix (and its kernel K5) is not ported "
            "yet (ROADMAP.md queue 8); the packed bytes exceed "
            "configs.snp_hbm_budget or streaming=True was asked"
        )
    return MatrixNaiveSNPUnphased(io, dtype=dtype, device=device)


def snp_phased_ancestry(io, *, dtype=None, device=None):
    """Phased calldata x local-ancestry matrix on ``device`` (reference
    matrix.py:1189); ``io`` has ``packed``, ``rows()`` and ``cols()``."""
    return MatrixNaiveSNPPhasedAncestry(io, dtype=dtype, device=device)
