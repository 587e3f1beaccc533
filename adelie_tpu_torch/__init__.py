"""adelie_tpu_torch: the group elastic net path solver of adelie_tpu, in
PyTorch, with its pin-solve kernels written in CUDA for Hopper.

The screen-set solver runs block coordinate descent in covariance form
against a Gram of the screened columns (``solver/pin.py``); its solves are
the two lasso kernels of ``solver/pin_kernels.py`` and, for groups of size
> 1, the grouped kernel of ``solver/pin_group_kernels.py`` (whose block
updates are ``bcd``'s), built from ``csrc/`` at the first CUDA call.  On
CPU tensors the kernels' plain PyTorch twins run instead.  The port so far
covers ``grpnet`` with a gaussian loss and groups of any size on a dense
matrix or on a packed SNP matrix (``io``, ``matrix.snp_unphased``,
``matrix.snp_phased_ancestry``), in device memory or, for a panel larger
than the card, streamed from host memory (``snp_unphased(streaming=True)``);
its gradients are the decode-matmul kernels of ``matrix/snp_kernels.py``.
ROADMAP.md lists what comes next.
"""

__version__ = "0.1.0"

from . import bcd, data, glm, io, matrix, solver, state
from .configs import configs, set_configs
from .logger import logger, logger_level
from .solver import grpnet

__all__ = ["bcd", "configs", "data", "glm", "grpnet", "io", "logger",
           "logger_level", "matrix", "set_configs", "solver", "state"]
