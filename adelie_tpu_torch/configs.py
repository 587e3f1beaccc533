"""Global configuration for adelie_tpu_torch.

Counterpart of ``adelie_tpu/configs.py``: a plain dataclass singleton that
solver entry points read at call time.  The knobs that decide the screening
path (``screen_all_max``, ``screen_cap_min``, ``group_cap_min``) keep the JAX
package's values, so both packages walk the same path; re-tuning them for
the GPU needs a measurement first.
"""

from contextlib import contextmanager
from dataclasses import dataclass, fields

import torch


@dataclass
class Configs:
    # A group update whose ||dbeta||^2 <= dbeta_tol^2 q is skipped, for
    # groups of size q > 1 (reference configs.hpp: dbeta_tol = 1e-12).
    dbeta_tol: float = 1e-12
    # Capacity buckets for screen-set buffers (minimum bucket).
    screen_cap_min: int = 64
    group_cap_min: int = 64
    # Below this total value size every group is screened up front.
    screen_all_max: int = 1024
    # Precision of the large float32 products (Gram, gradients):
    # "highest"/"float32" keep full float32 (TF32 off), "default" and "x3"
    # allow TF32 on the card.  float64 products are unaffected.
    matmul_precision: str = "highest"
    # Total CD sweeps one lambda chunk may spend before it freezes and
    # returns to the host, which resumes at the next unaccepted lambda.
    chunk_sweep_budget: int = 1_000_000
    # Packed SNP bytes above which matrix.snp_unphased(streaming="auto")
    # asks for the host-streamed matrix: half the H100's 80 GB, as the JAX
    # package's 8 GiB is half a TPU v5e's 16 GB.  The rest holds the screen
    # block, the Gram and the kernels' working vectors.
    snp_hbm_budget: int = 40 * 10**9
    # On a streamed-KKT chunk failure, add to the screen set every group
    # that violates KKT at any converged lambda of the chunk, not only at
    # the first failure (solver/streamed.py): the chunk's one pass over
    # the panel already paid for those gradients, and each retry it saves
    # is another pass.  The solutions stay KKT-certified, but the screen
    # trajectory, and so the iterate within solver tolerance, can differ
    # from the in-device driver's; False reproduces that driver's path.
    stream_speculative_union: bool = True


_default = Configs()
configs = Configs()

# configs.matmul_precision -> torch.backends.cuda.matmul.allow_tf32
_ALLOW_TF32 = {
    "default": True,
    "x3": True,
    "float32": False,
    "highest": False,
}


def allow_tf32() -> bool:
    """Whether ``configs.matmul_precision`` lets float32 products use TF32."""
    name = configs.matmul_precision
    try:
        return _ALLOW_TF32[name]
    except KeyError:
        raise ValueError(
            f"Unknown matmul_precision: {name!r}. Valid: {sorted(_ALLOW_TF32)}"
        ) from None


@contextmanager
def matmul_precision():
    """Apply ``configs.matmul_precision`` to the products inside the block
    and restore the process setting after it."""
    want = allow_tf32()
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = want
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def set_configs(name: str, value=None):
    """Set a global configuration value; ``value=None`` resets it."""
    names = {f.name for f in fields(Configs)}
    if name not in names:
        raise ValueError(f"Unknown config: {name!r}. Valid: {sorted(names)}")
    if value is None:
        value = getattr(_default, name)
    setattr(configs, name, value)
    return value
