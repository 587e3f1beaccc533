"""Small utilities: timing, capacity bucketing, the dry-fit lambda.

Counterpart of ``adelie_tpu/utils/__init__.py``.  The capacity buckets are
kept although PyTorch runs eagerly: they decide the screen capacity S_cap,
and S_cap decides which pin kernel runs (``solver/pin.py``), so keeping
them keeps the port on the reference's dispatch.
"""

import time

import numpy as np
import torch

from . import types
from .types import screen_rule

__all__ = ["TORCH_DTYPE", "Stopwatch", "bucket", "bucket_pow2", "large_lmda",
           "screen_rule", "types"]

# the float dtypes the solver runs in, numpy -> torch
TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
               np.dtype(np.float64): torch.float64}


class Stopwatch:
    """Wall-clock timer (reference: util/stopwatch.hpp)."""

    def __init__(self):
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


def bucket(n: int, minimum: int = 64) -> int:
    """Round ``n`` up to a capacity bucket (min bucket, then powers of two)."""
    n = max(int(n), 1)
    cap = max(minimum, 1)
    while cap < n:
        cap *= 2
    return cap


def bucket_pow2(n: int, minimum: int = 1) -> int:
    """Round up to a power of two (used for max-group-size buckets)."""
    return bucket(n, minimum)


def large_lmda(dtype) -> float:
    """A finite 'lambda ~ infinity' for the lmda_max dry fit.

    The same 1e30 as the JAX package, so the dry fit and therefore the
    lambda path agree between the two packages in every dtype.
    """
    return 1e30
