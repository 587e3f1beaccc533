"""Matrix factories mirroring ``adelie_tpu.matrix``; the dense one so far."""

from ..device import resolve_device
from .base import MatrixNaiveBase
from .dense import MatrixNaiveDense

__all__ = ["MatrixNaiveBase", "MatrixNaiveDense", "dense"]


def dense(mat, *, method: str = "naive", dtype=None, device=None):
    """Dense matrix on ``device`` (default: ``"cuda"`` when a GPU is
    available, else ``"cpu"``).  Only ``method="naive"`` is ported."""
    if method != "naive":
        raise NotImplementedError(
            f"dense(method={method!r}) is not ported yet (ROADMAP.md queue 1)"
        )
    return MatrixNaiveDense(mat, dtype=dtype, device=resolve_device(device))

