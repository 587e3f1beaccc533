"""adelie_tpu_torch: the group elastic net path solver of adelie_tpu, in
PyTorch, with its pin-solve kernels written in CUDA for Hopper.

The screen-set solver runs block coordinate descent in covariance form
against a Gram of the screened columns (``solver/pin.py``); its solves are
the two lasso kernels of ``solver/pin_kernels.py`` and, for groups of size
> 1, the grouped kernel of ``solver/pin_group_kernels.py`` (whose block
updates are ``bcd``'s), built from ``csrc/`` at the first CUDA call.  On
CPU tensors the kernels' plain PyTorch twins run instead.  The port so far
covers ``grpnet`` with groups of any size for the single-response GLMs
(the gaussian in covariance form; binomial, poisson and Cox by IRLS,
``glm``) and the multi-response ones (``glm.multigaussian``,
``glm.multinomial``, fitted on ``matrix.kronecker_eye``) on a dense matrix
or on a packed SNP matrix (``io``,
``matrix.snp_unphased``, ``matrix.snp_phased_ancestry``), in device
memory or, for a panel larger
than the card, streamed from host memory (``snp_unphased(streaming=True)``);
its gradients are the decode-matmul kernels of ``matrix/snp_kernels.py``.
The covariance method (``gaussian_cov`` on the covariance matrices of
``matrix``) runs the same pin solves; the standalone solvers ``bvls`` and
``pinball`` run their fits in the screened coordinate-descent kernel of
``solver/screened_cd_kernels.py``, and ``css_cov`` selects column subsets.
The model-selection layer: ``cv_grpnet`` (K-fold CV, the folds one after
another), ``diagnostic`` (predictions, gradients, KKT scores, plots),
``state`` (the solver states, ``check_state``, the fixed-screen pin states,
warm-start save and load) and the scikit-learn estimators
``GroupElasticNet`` and ``CSSModelSelection``.  ``cv``, ``diagnostic`` and
``sklearn`` load at first use, and the plots and estimators import
matplotlib and scikit-learn only then.  ROADMAP.md lists what comes next.
"""

__version__ = "0.1.0"

from . import bcd, data, glm, io, matrix, solver, state
from .configs import configs, set_configs
from .logger import logger, logger_level
from .solver import bvls, css_cov, gaussian_cov, grpnet, pinball

__all__ = ["CSSModelSelection", "GroupElasticNet", "bcd", "bvls", "configs",
           "css_cov", "cv", "cv_grpnet", "data", "diagnostic", "gaussian_cov",
           "glm", "grpnet", "io", "logger", "logger_level", "matrix",
           "pinball", "set_configs", "sklearn", "solver", "state"]


def __getattr__(name):
    # the model-selection modules load at first use (adelie_tpu/__init__.py
    # :60-85); none imports matplotlib or scikit-learn at import but
    # ``sklearn``
    import importlib

    if name in ("cv", "diagnostic", "sklearn"):
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name == "cv_grpnet":
        return importlib.import_module(".cv", __name__).cv_grpnet
    if name in ("GroupElasticNet", "CSSModelSelection"):
        return getattr(importlib.import_module(".sklearn", __name__), name)
    raise AttributeError(
        f"module 'adelie_tpu_torch' has no attribute {name!r}")
