"""Synthetic data generators (reference adelie/data.py:84,222,362).

Counterpart of ``dense`` and the SNP generators of ``adelie_tpu/data.py``,
for a gaussian response with one class: the same
``numpy.random.default_rng`` calls in the same order, so one seed gives the
same arrays in both packages (``X``, ``y``, ``groups`` and ``penalty``;
unphased, ``beta``; phased, ``ancestries``).  Other GLMs and ``K > 1``
raise: they come with the GLM slice (ROADMAP.md queue 1 item 3).
"""

import numpy as np

from . import glm as glm_mod

__all__ = ["dense", "snp_phased_ancestry", "snp_unphased"]


def _check_gaussian(glm, K):
    if glm != "gaussian" or K != 1:
        raise NotImplementedError(
            f"simulated {glm!r} responses with K={K} are not ported yet "
            "(ROADMAP.md queue 5: GLMs)")


def _gaussian(eta, snr, rng, n, dtype, cast_y):
    signal_var = float(np.var(eta))
    noise = np.sqrt(signal_var / snr) if signal_var > 0 else 1.0
    y = eta.ravel() + noise * rng.standard_normal(n)
    if cast_y and dtype is not None:
        y = y.astype(dtype)
    return y, glm_mod.gaussian(y, dtype=dtype)


def _make_groups(p, G, equal_groups, rng):
    if equal_groups:
        groups = (p // G) * np.arange(G)
    else:
        cuts = rng.choice(np.arange(1, p), size=G - 1, replace=False)
        groups = np.sort(np.concatenate([[0], cuts])).astype(int)
    group_sizes = np.diff(np.concatenate([groups, [p]])).astype(int)
    return groups, group_sizes


def dense(
    n: int,
    p: int,
    G: int,
    *,
    K: int = 1,
    glm: str = "gaussian",
    equal_groups=False,
    rho: float = 0.0,
    sparsity: float = 0.95,
    zero_penalty: float = 0.0,
    snr: float = 1.0,
    seed: int = 0,
):
    """Dense simulated dataset (reference data.py:84): ``G`` groups over
    ``p`` equicorrelated features (correlation ``rho``), random group
    boundaries unless ``equal_groups`` (then ``p // G`` columns a group,
    the last group taking the rest), a sparse coefficient vector, a
    gaussian response with signal-to-noise ratio ``snr``."""
    _check_gaussian(glm, K)
    rng = np.random.default_rng(seed)
    groups, group_sizes = _make_groups(p, G, equal_groups, rng)

    penalty = np.sqrt(group_sizes).astype(float)
    if zero_penalty > 0:
        penalty[rng.choice(G, int(zero_penalty * G), replace=False)] = 0
    penalty /= np.linalg.norm(penalty) / np.sqrt(p)

    Z = rng.standard_normal(n)
    X = np.sqrt(max(rho, 0.0)) * Z[:, None] + np.sqrt(1 - max(rho, 0.0)) * (
        rng.standard_normal((n, p))
    )

    beta = rng.standard_normal((p, K))
    zero_idx = rng.choice(p, int(sparsity * p), replace=False)
    beta[zero_idx] = 0.0
    _, glm_obj = _gaussian((X @ beta)[:, :1], snr, rng, n, None,
                           cast_y=False)
    return {
        "X": np.asfortranarray(X),
        "glm": glm_obj,
        "groups": groups,
        "group_sizes": group_sizes,
        "penalty": penalty,
    }


def snp_unphased(
    n: int,
    p: int,
    *,
    K: int = 1,
    glm: str = "gaussian",
    sparsity: float = 0.95,
    one_ratio: float = 0.25,
    two_ratio: float = 0.05,
    missing_ratio: float = 0.1,
    zero_penalty: float = 0.0,
    snr: float = 1.0,
    seed: int = 0,
    dtype=None,
):
    """Simulated SNP unphased calldata (reference data.py:222).

    ``X`` entries are in {0, 1, 2, -9 (NA)}; ``y`` is gaussian with
    signal-to-noise ratio ``snr``; ``dtype`` sets the response's dtype.
    """
    _check_gaussian(glm, K)
    rng = np.random.default_rng(seed)
    probs = np.array([
        1 - one_ratio - two_ratio - missing_ratio,
        one_ratio,
        two_ratio,
        missing_ratio,
    ])
    vals = np.array([0, 1, 2, -9], dtype=np.int8)
    X = vals[rng.choice(4, size=(n, p), p=probs)]

    groups = np.arange(p)
    group_sizes = np.ones(p, dtype=int)
    penalty = np.sqrt(group_sizes).astype(float)
    if zero_penalty > 0:
        penalty[rng.choice(p, int(zero_penalty * p), replace=False)] = 0
        penalty /= np.linalg.norm(penalty) / np.sqrt(p)

    beta = rng.standard_normal((p, K))
    zero_idx = rng.choice(p, int(sparsity * p), replace=False)
    beta[zero_idx] = 0.0
    Ximp = np.where(X == -9, 0, X).astype(float)
    y, glm_obj = _gaussian(Ximp @ beta, snr, rng, n, dtype, cast_y=True)

    return {
        "X": X,
        "glm": glm_obj,
        "y": y,
        "beta": beta.ravel(),
        "groups": groups,
        "group_sizes": group_sizes,
        "penalty": penalty,
    }


def snp_phased_ancestry(
    n: int,
    s: int,
    A: int,
    *,
    K: int = 1,
    glm: str = "gaussian",
    sparsity: float = 0.95,
    one_ratio: float = 0.25,
    two_ratio: float = 0.05,
    zero_penalty: float = 0.0,
    snr: float = 1.0,
    seed: int = 0,
    dtype=None,
):
    """Simulated phased calldata with local ancestry (reference data.py:362).

    Returns calldata (n, 2s) in {0,1} and ancestries (n, 2s) in {0..A-1};
    column ``j A + a`` of the matrix counts the haplotypes of SNP j with
    ancestry a.
    """
    _check_gaussian(glm, K)
    rng = np.random.default_rng(seed)
    hap_prob = one_ratio + two_ratio
    X = rng.binomial(1, hap_prob, size=(n, 2 * s)).astype(np.int8)
    anc = rng.integers(0, A, size=(n, 2 * s)).astype(np.int8)

    p = s * A
    groups = np.arange(s) * A
    group_sizes = np.full(s, A, dtype=int)
    penalty = np.sqrt(group_sizes).astype(float)
    if zero_penalty > 0:
        penalty[rng.choice(s, int(zero_penalty * s), replace=False)] = 0
        penalty /= np.linalg.norm(penalty) / np.sqrt(p)

    beta = rng.standard_normal((p, K))
    zero_idx = rng.choice(p, int(sparsity * p), replace=False)
    beta[zero_idx] = 0.0

    dense_X = np.zeros((n, p))
    for j in range(s):
        for hap in range(2):
            col = X[:, 2 * j + hap]
            a = anc[:, 2 * j + hap]
            dense_X[np.arange(n), j * A + a] += col
    y, glm_obj = _gaussian(dense_X @ beta, snr, rng, n, dtype, cast_y=False)

    return {
        "X": X,
        "ancestries": anc,
        "glm": glm_obj,
        "y": y,
        "groups": groups,
        "group_sizes": group_sizes,
        "penalty": penalty,
    }
