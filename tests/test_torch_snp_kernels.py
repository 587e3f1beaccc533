"""K3 and K4's plain twins against the JAX package's kernels, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
these twins there).  Here the twins, which the CPU path runs, are held
against the Pallas kernels in interpret mode with the bars of
``tests/test_io_snp.py`` (rtol 2e-5, atol 1e-4 in float32), and against the
JAX package's XLA products in float64 (atol 1e-12).  The packed tail bits
past ``n`` are left unmasked: a code 3 there must contribute nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adelie_tpu as ja
import adelie_tpu_torch as ta
from adelie_tpu.matrix._snp_pallas import snp_mul_pallas, snp_mul_pallas_no_na
from adelie_tpu_torch.matrix import snp_kernels as sk

torch.set_num_threads(1)

SHAPES = [(10, 9), (300, 257), (513, 1000)]


def _inputs(p, n, seed, max_code=3):
    """Random packed bytes (codes 0..max_code, tail bits left as drawn),
    float32 u and impute."""
    rng = np.random.default_rng(seed)
    nb = (n + 3) // 4
    if max_code == 3:
        packed = rng.integers(0, 256, size=(p, nb), dtype=np.uint8)
    else:
        codes = rng.integers(0, max_code + 1, size=(p, 4 * nb), dtype=np.uint8)
        packed = np.zeros((p, nb), np.uint8)
        for k in range(4):
            packed |= codes[:, k::4] << (2 * k)
    u = rng.standard_normal(n).astype(np.float32)
    impute = rng.uniform(0, 2, p).astype(np.float32)
    return packed, u, impute


def _has_tail_na(packed, n):
    nb = packed.shape[1]
    codes = ta.matrix._snp.unpack_2bit_np(packed, 4 * nb)
    return bool((codes[:, n:] == 3).any())


@pytest.mark.parametrize("p,n", SHAPES)
def test_k3_twin_matches_pallas_kernel(p, n):
    packed, u, impute = _inputs(p, n, seed=p + n)
    if n % 4:
        assert _has_tail_na(packed, n)
    want = np.asarray(snp_mul_pallas(jnp.asarray(packed), jnp.asarray(u),
                                     jnp.asarray(impute), interpret=True))
    got = sk.snp_mul_ref(torch.from_numpy(packed), torch.from_numpy(u),
                         torch.from_numpy(impute)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("p,n", SHAPES)
def test_k4_twin_matches_pallas_kernel(p, n):
    packed, u, _ = _inputs(p, n, seed=p * n, max_code=2)
    want = np.asarray(snp_mul_pallas_no_na(jnp.asarray(packed),
                                           jnp.asarray(u), interpret=True))
    got = sk.snp_mul_no_na_ref(torch.from_numpy(packed),
                               torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


class _IO:
    """An in-memory handler, as bench.py builds one."""

    def __init__(self, packed, n, impute=None):
        self.packed = packed
        self.impute = impute
        self._n = n

    def rows(self):
        return self._n

    def snps(self):
        return self.packed.shape[0]

    cols = snps


@pytest.mark.parametrize("phased", [False, True])
def test_twins_match_jax_xla_products_f64(phased):
    """Both classes' ``mul`` in float64: the port's twin against the JAX
    package's XLA decode-matmul (its path off the TPU)."""
    p, n = 2100, 257            # two twin blocks, a ragged tail
    packed, u32, impute = _inputs(p, n, seed=5, max_code=2 if phased else 3)
    io = _IO(packed, n, impute.astype(np.float64))
    rng = np.random.default_rng(6)
    v, w = rng.standard_normal(n), rng.uniform(0.5, 1.5, n)
    if phased:
        jm = ja.matrix.snp_phased_ancestry(io, dtype=np.float64)
        tm = ta.matrix.snp_phased_ancestry(io, device="cpu")
    else:
        jm = ja.matrix.snp_unphased(io, dtype=np.float64, streaming=False)
        tm = ta.matrix.snp_unphased(io, device="cpu")
    want = np.asarray(jm.mul(v, w))
    got = tm.mul(torch.from_numpy(v), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_wrappers_on_cpu_run_the_twins_and_count_nothing():
    packed, u, impute = _inputs(40, 37, seed=1)
    pk, ut, it = (torch.from_numpy(a) for a in (packed, u, impute))
    before = dict(sk.launches)
    assert torch.equal(sk.snp_mul(pk, ut, it), sk.snp_mul_ref(pk, ut, it))
    assert torch.equal(sk.snp_mul_no_na(pk, ut), sk.snp_mul_no_na_ref(pk, ut))
    assert sk.launches == before


def test_wrappers_refuse_what_the_kernel_does_not_take():
    packed, u, impute = _inputs(8, 20, seed=2)
    pk, ut, it = (torch.from_numpy(a) for a in (packed, u, impute))
    with pytest.raises(TypeError, match="uint8"):
        sk.snp_mul(pk.to(torch.int16), ut, it)
    with pytest.raises(TypeError, match="float32 or float64"):
        sk.snp_mul_no_na(pk, ut.half())
    with pytest.raises(TypeError, match="impute"):
        sk.snp_mul(pk, ut, it.double())
    with pytest.raises(ValueError, match="4 nb"):
        sk.snp_mul(pk, torch.zeros(21), it)
    with pytest.raises(ValueError, match="contiguous"):
        sk.snp_mul_no_na(pk.T.contiguous().T, ut)
    meta = torch.empty((8, 5), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel or twin"):
        sk.snp_mul_no_na(meta, torch.empty(20, device="meta"))
