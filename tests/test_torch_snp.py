"""The packed-SNP path of adelie_tpu_torch against adelie_tpu, on the CPU.

The same files and numpy arrays go through both packages: the ``.snpdat``
codec in both directions, the SNP matrices' products in float64 (atol
1e-12), the simulators (equal arrays) and ``grpnet`` with the bars of
``test_torch_grpnet.py``.  The port runs its kernels' twins here.
"""

import numpy as np
import pytest
import torch

import adelie_tpu as ja
import adelie_tpu_torch as ta
from adelie_tpu_torch.configs import configs, set_configs
from adelie_tpu_torch.matrix import snp_kernels as sk
from adelie_tpu_torch.solver import pin_kernels as tk
from adelie_tpu_torch.state import state_from_numpy
from test_torch_grpnet import _WS_KEYS, _assert_same_path

torch.set_num_threads(1)


def _unphased_calldata(n, p, seed, missing=0.1):
    rng = np.random.default_rng(seed)
    probs = [0.6 - missing, 0.3, 0.1, missing]
    return np.array([0, 1, 2, -9], np.int8)[rng.choice(4, (n, p), p=probs)]


def _phased_calldata(n, s, A, seed):
    rng = np.random.default_rng(seed)
    call = rng.binomial(1, 0.3, size=(n, 2 * s)).astype(np.int8)
    anc = rng.integers(0, A, size=(n, 2 * s)).astype(np.int8)
    return call, anc


class _IO:
    """A handler holding another handler's numpy arrays, as bench.py's."""

    def __init__(self, src):
        self.packed = np.asarray(src.packed)
        self.impute = np.asarray(getattr(src, "impute", np.zeros(0)))
        self._n, self._p = src.rows(), src.cols()

    def rows(self):
        return self._n

    def snps(self):
        return self._p

    cols = snps


# --------------------------------------------------------------------------- #
# IO across packages                                                          #
# --------------------------------------------------------------------------- #


def _assert_same_unphased(a, b):
    np.testing.assert_array_equal(a.packed, b.packed)
    for k in ("impute", "nnz", "nnm"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert (a.rows(), a.snps()) == (b.rows(), b.snps())
    np.testing.assert_array_equal(a.to_dense(), b.to_dense())


@pytest.mark.parametrize("writer,reader", [(ja, ta), (ta, ja)])
def test_unphased_file_across_packages(writer, reader, tmp_path):
    X = _unphased_calldata(37, 11, seed=1)
    f = str(tmp_path / "x.snpdat")
    writer.io.snp_unphased(f).write(X)
    got = reader.io.snp_unphased(f).read()
    _assert_same_unphased(got, writer.io.snp_unphased(f).read())
    np.testing.assert_array_equal(got.to_dense(), X)


@pytest.mark.parametrize("writer,reader", [(ja, ta), (ta, ja)])
def test_phased_file_across_packages(writer, reader, tmp_path):
    n, s, A = 30, 5, 3
    call, anc = _phased_calldata(n, s, A, seed=2)
    f = str(tmp_path / "x.snpdat")
    writer.io.snp_phased_ancestry(f).write(call, anc, A)
    got = reader.io.snp_phased_ancestry(f, read_mode="mmap").read()
    want = writer.io.snp_phased_ancestry(f).read()
    np.testing.assert_array_equal(got.packed, want.packed)
    np.testing.assert_array_equal(got.nnz0, want.nnz0)
    np.testing.assert_array_equal(got.nnz1, want.nnz1)
    assert (got.rows(), got.snps(), got.ancestries(), got.cols()) == \
        (n, s, A, s * A)
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())


def test_bed_file_across_packages(tmp_path):
    X = _unphased_calldata(37, 9, seed=3)         # 37 % 4 != 0
    fj, ft = str(tmp_path / "j.bed"), str(tmp_path / "t.bed")
    ja.io.snp_bed(fj).write(X)
    ta.io.snp_bed(ft).write(X)
    assert open(fj, "rb").read() == open(ft, "rb").read()
    got = ta.io.snp_bed(fj, n_samples=37).read()
    want = ja.io.snp_bed(fj, n_samples=37).read()
    _assert_same_unphased(got, want)
    np.testing.assert_array_equal(got.to_dense(), X)


def test_corrupt_files_and_bad_modes_raise(tmp_path):
    f = tmp_path / "bad.snpdat"
    f.write_bytes(b"not a real snpdat file at all")
    with pytest.raises(RuntimeError, match="corrupt|cannot read"):
        ta.io.snp_unphased(str(f)).read()
    with pytest.raises(RuntimeError, match="corrupt|cannot read"):
        ta.io.snp_phased_ancestry(str(f)).read()
    with pytest.raises(ValueError, match="read_mode"):
        ta.io.snp_unphased(str(f), read_mode="bogus")
    with pytest.raises(ValueError):
        ta.io.snp_unphased(str(tmp_path / "w.snpdat")).write(
            np.full((4, 2), 3, np.int8))


# --------------------------------------------------------------------------- #
# matrix products                                                             #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("phased", [False, True])
def test_snp_matrix_products_match_jax(phased, tmp_path):
    f = str(tmp_path / "m.snpdat")
    if phased:
        call, anc = _phased_calldata(41, 5, 3, seed=4)
        ja.io.snp_phased_ancestry(f).write(call, anc, 3)
        jio = ja.io.snp_phased_ancestry(f).read()
        jm = ja.matrix.snp_phased_ancestry(jio)
        tm = ta.matrix.snp_phased_ancestry(_IO(jio), device="cpu")
    else:
        ja.io.snp_unphased(f).write(_unphased_calldata(41, 13, seed=4))
        jio = ja.io.snp_unphased(f).read()
        jm = ja.matrix.snp_unphased(jio)
        tm = ta.matrix.snp_unphased(_IO(jio), device="cpu")
    n, p = jm.shape
    assert tm.shape == (n, p) and tm.dtype == np.float64
    rng = np.random.default_rng(5)
    v, w = rng.standard_normal(n), rng.uniform(0.5, 1.5, n)
    U, b = rng.standard_normal((3, n)), rng.standard_normal((p, 2))
    idx = np.array([p - 1, 0, 2])
    t = torch.from_numpy

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-12)

    close(tm.mul(t(v), t(w)), jm.mul(v, w))
    close(tm.mul_many(t(U)), jm.mul_many(U))
    close(tm.gather(idx), jm.gather(idx))
    close(tm.tmul(b[:, 0]), jm.tmul(b[:, 0]))
    close(tm.tmul(b), jm.tmul(b))
    close(tm.sq_mul(t(w)), jm.sq_mul(w))
    close(tm.to_dense(), jm.to_dense())


def _tiny_io():
    return type("IO", (), {"packed": np.zeros((6, 5), np.uint8),
                           "impute": np.zeros(6), "rows": lambda self: 20,
                           "snps": lambda self: 6, "cols": lambda self: 6})()


def test_factories_raise_for_streaming_and_missing_gpu(monkeypatch):
    """``streaming=True``, or ``"auto"`` above the budget, gives the
    host-streamed matrix (float32 by default); ``n_threads`` is accepted;
    a missing GPU raises for every SNP factory."""
    io = _tiny_io()
    packed = io.packed
    Streamed = ta.matrix.MatrixNaiveSNPUnphasedStreamed
    m = ta.matrix.snp_unphased(io, streaming=True, n_threads=2, device="cpu")
    assert isinstance(m, Streamed) and m.dtype == np.float32
    old = configs.snp_hbm_budget
    set_configs("snp_hbm_budget", packed.nbytes - 1)
    try:
        assert isinstance(ta.matrix.snp_unphased(io, device="cpu"), Streamed)
        m = ta.matrix.snp_unphased(io, streaming=False, device="cpu")
        assert not isinstance(m, Streamed) and m.dtype == np.float64
    finally:
        set_configs("snp_hbm_budget")
    assert configs.snp_hbm_budget == old == 40 * 10**9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (ta.matrix.snp_unphased, ta.matrix.snp_phased_ancestry,
                 lambda io, **kw: ta.matrix.snp_unphased(io, streaming=True,
                                                         **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(io, device="cuda")
        # the default is the card, so without one it raises too
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(io)
    m = ta.matrix.snp_unphased(io, device="cpu")
    assert m.device == torch.device("cpu")
    assert m._packed.device == torch.device("cpu")


@pytest.mark.parametrize("cls", [ta.matrix.MatrixNaiveDense,
                                 ta.matrix.MatrixNaiveSNPUnphased,
                                 ta.matrix.MatrixNaiveSNPPhasedAncestry])
def test_matrix_classes_resolve_their_device(cls, monkeypatch):
    """A matrix class built with no device takes ``resolve_device``'s, as
    the factories do: the card, which raises when there is none; never the
    CPU silently.  ``device="cpu"`` gives the CPU."""
    arg = np.zeros((20, 6)) if cls is ta.matrix.MatrixNaiveDense \
        else _tiny_io()
    if torch.cuda.is_available():
        assert cls(arg).device == torch.device("cuda")
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(arg)
    assert cls(arg, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # resolved to "cuda": moving the data there fails in a CPU-only torch
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        cls(arg)


# --------------------------------------------------------------------------- #
# simulators                                                                  #
# --------------------------------------------------------------------------- #


def test_simulators_give_the_jax_packages_arrays():
    kw = dict(missing_ratio=0.2, zero_penalty=0.3, seed=7)
    j, t = ja.data.snp_unphased(60, 25, **kw), ta.data.snp_unphased(60, 25,
                                                                   **kw)
    for k in ("X", "y", "beta", "groups", "group_sizes", "penalty"):
        np.testing.assert_array_equal(t[k], j[k])
    np.testing.assert_array_equal(t["glm"].y.numpy(), np.asarray(j["glm"].y))
    j = ja.data.snp_phased_ancestry(40, 6, 3, seed=8)
    t = ta.data.snp_phased_ancestry(40, 6, 3, seed=8)
    for k in ("X", "ancestries", "y", "groups", "group_sizes", "penalty"):
        np.testing.assert_array_equal(t[k], j[k])
    with pytest.raises(NotImplementedError, match="queue 5"):
        ta.data.snp_unphased(10, 3, glm="binomial")


# --------------------------------------------------------------------------- #
# grpnet                                                                      #
# --------------------------------------------------------------------------- #


def _unphased_fit_inputs(tmp_path, n, p, seed, missing=0.1):
    d = ja.data.snp_unphased(n, p, missing_ratio=missing, seed=seed)
    f = str(tmp_path / "g.snpdat")
    ja.io.snp_unphased(f).write(d["X"])
    jio = ja.io.snp_unphased(f).read()
    return jio, d["y"]


def _fit_both(jm, tm, y, **kw):
    js = ja.grpnet(jm, ja.glm.gaussian(y), **kw)
    ts = ta.grpnet(tm, ta.glm.gaussian(y), device="cpu", **kw)
    return js, ts


@pytest.mark.parametrize("intercept", [True, False])
def test_grpnet_unphased_screen_all(intercept, tmp_path):
    """(a) p = 30: every column is screened up front, K3's and K1's twins."""
    jio, y = _unphased_fit_inputs(tmp_path, 150, 30, seed=3)
    js, ts = _fit_both(ja.matrix.snp_unphased(jio),
                       ta.matrix.snp_unphased(_IO(jio), device="cpu"), y,
                       lmda_path_size=12, min_ratio=0.05, intercept=intercept)
    _assert_same_path(js, ts)
    assert ts.screen_sizes[0] == 30


@pytest.mark.parametrize("intercept", [True, False])
def test_grpnet_unphased_basil(intercept, tmp_path):
    """(b) p = 1,500 > 1024 with 10% NA: BASIL screening.  The strong rule
    at the coarse path's second lambda screens 1,344 columns without an
    intercept, so K2's twin carries those pin solves; with one, 681.

    tol is 1e-12 for the reason given in test_torch_grpnet.py's K2 test."""
    jio, y = _unphased_fit_inputs(tmp_path, 200, 1500, seed=4)
    js, ts = _fit_both(ja.matrix.snp_unphased(jio),
                       ta.matrix.snp_unphased(_IO(jio), device="cpu"), y,
                       intercept=intercept, screen_rule="strong",
                       early_exit=False, lmda_path_size=4, min_ratio=0.3,
                       tol=1e-12)
    _assert_same_path(js, ts)
    if intercept:
        assert max(ts.screen_sizes) < 1024
    else:
        assert 1024 < max(ts.screen_sizes) < 1500


@pytest.mark.parametrize("intercept", [True, False])
def test_grpnet_phased_ancestry(intercept, tmp_path):
    """(c) phased ancestry with groups=None: K4's twin gives the gradient."""
    d = ja.data.snp_phased_ancestry(120, 20, 3, seed=5)
    f = str(tmp_path / "ph.snpdat")
    ja.io.snp_phased_ancestry(f).write(d["X"], d["ancestries"], 3)
    jio = ja.io.snp_phased_ancestry(f).read()
    tio = ta.io.snp_phased_ancestry(f).read()
    js, ts = _fit_both(ja.matrix.snp_phased_ancestry(jio),
                       ta.matrix.snp_phased_ancestry(tio, device="cpu"),
                       d["y"], lmda_path_size=15, intercept=intercept)
    _assert_same_path(js, ts)


def test_warm_start_from_jax_snp_state(tmp_path):
    """The first 5 lambdas of a BASIL path fitted in adelie_tpu, carried
    over with state_from_numpy and finished in the port: adelie_tpu's own
    continuation, and the full adelie_tpu path to the bars.

    tol is 1e-14: a continuation screens other columns than the full path,
    and two solves that stop at tol differ by up to sqrt(tol) in a
    coefficient (adelie_tpu's own two paths by 1.6e-6 at 1e-12)."""
    jio, y = _unphased_fit_inputs(tmp_path, 200, 1500, seed=4)
    jm = ja.matrix.snp_unphased(jio)
    kw = dict(intercept=False, early_exit=False, lmda_path_size=10,
              min_ratio=0.3, tol=1e-14)
    full = ja.grpnet(jm, ja.glm.gaussian(y), **kw)
    kw.pop("lmda_path_size")
    kw.pop("min_ratio")
    half = ja.grpnet(jm, ja.glm.gaussian(y), lmda_path=full.lmdas[:5], **kw)
    ws = state_from_numpy({k: np.asarray(getattr(half, k)) for k in _WS_KEYS},
                          device="cpu")
    before = dict(sk.launches), dict(tk.launches)
    ts = ta.grpnet(ta.matrix.snp_unphased(_IO(jio), device="cpu"),
                   ta.glm.gaussian(y), lmda_path=full.lmdas[5:],
                   warm_start=ws, device="cpu", **kw)
    assert (dict(sk.launches), dict(tk.launches)) == before
    js = ja.grpnet(jm, ja.glm.gaussian(y), lmda_path=full.lmdas[5:],
                   warm_start=half, **kw)
    _assert_same_path(js, ts)
    np.testing.assert_allclose(ts.betas.toarray(), full.betas.toarray()[5:],
                               atol=1e-6)
    np.testing.assert_allclose(ts.devs, full.devs[5:], atol=1e-8)
